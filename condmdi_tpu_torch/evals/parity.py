"""The paper-parity run: asset check (or fetch) → released checkpoint →
the wo_mm protocol → comparison with the paper's numbers.

Counterpart of condmdi_tpu/evals/parity.py. Parity is one invocation once the
assets exist:

  python -m condmdi_tpu_torch.utils.assets --fetch   # downloads (needs network)
  python -m condmdi_tpu_torch.evals.parity           # runs + compares

Pipeline (reference prepare/*.sh, README.md:135-139, eval_humanml_condmdi):
  1. the asset groups HumanML3D (manual), GloVe, the T2M evaluator and the
     released CondMDI models present (utils/assets.py), or fetched first with
     --fetch;
  2. the released `model000750000.pt` loads through the port's converter
     (utils/checkpoint.load_torch_checkpoint) with its args.json;
  3. the wo_mm protocol runs through the port's evals.run (20 replications,
     batch 32), on the card unless `main(..., device="cpu")`;
  4. every metric is compared with `parity_expected.json`, this package's copy
     of the JAX package's template: the paper's numbers ship inside the
     checkpoints zip (README.md:239), so the template holds nulls until they
     are filled in, and a null entry is reported, not compared (verdict
     `blocked_expected` when all are null).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

# metric → relative tolerance against the paper; the 20-replication CIs are
# ±1.96σ/√20, and these bounds are about 3× their usual width
DEFAULT_TOLERANCES = {
    "fid": 0.15,
    "r_precision": 0.05,
    "matching_score": 0.05,
    "diversity": 0.05,
    "keyframe_error": 0.10,
    "traj_error": 0.10,
    "skating_ratio": 0.15,
}

EXPECTED_TEMPLATE = Path(__file__).parent / "parity_expected.json"
REQUIRED_ASSETS = ("humanml3d", "glove", "t2m_evaluators", "models")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--fetch", action="store_true",
                   help="download missing assets first (needs network)")
    p.add_argument("--model_pt", default="save/condmdi_randomframes/model000750000.pt",
                   help="released reference checkpoint to evaluate")
    p.add_argument("--expected", default=str(EXPECTED_TEMPLATE))
    p.add_argument("--eval_mode", default="wo_mm")
    p.add_argument("--edit_mode", default="benchmark_sparse")
    p.add_argument("--transition_length", type=int, default=10)
    p.add_argument("--guidance_param", type=float, default=2.5)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--max_replications", type=int, default=0,
                   help="cap protocol replications (smoke/rehearsal runs)")
    p.add_argument("--output_dir", default="torch_eval_out/parity")
    return p


def check_required_assets(fetch: bool) -> dict:
    from condmdi_tpu_torch.utils.assets import check_assets, fetch_assets

    if fetch:
        fetch_assets(list(REQUIRED_ASSETS))
    status = check_assets()
    missing = [n for n in REQUIRED_ASSETS if n in status and not status[n]["present"]]
    return dict(status=status, missing=missing)


def compare(summary: dict, expected: dict, tolerances=None) -> list:
    """[(metric, measured, expected, rel_err, ok or None)]; None where the
    template holds no value yet."""
    tolerances = tolerances or DEFAULT_TOLERANCES
    rows = []
    for key, exp in expected.items():
        if key.startswith("_"):
            continue
        got = summary.get(key)
        measured = float(np.ravel(got["mean"])[0]) if got else float("nan")
        if exp is None:
            rows.append((key, measured, None, None, None))
            continue
        exp_v = float(np.ravel(exp)[0]) if isinstance(exp, (list, tuple)) else float(exp)
        rel = abs(measured - exp_v) / max(abs(exp_v), 1e-8)
        rows.append((key, measured, exp_v, rel, rel <= tolerances.get(key, 0.10)))
    return rows


def main(argv=None, *, device: str | torch.device = "cuda"):
    """Returns the verdict dict ({'status': 'blocked' | 'blocked_expected' | 'fail' |
    'pass', ...}); the report goes to <output_dir>/parity_report.json."""
    args = build_parser().parse_args(argv)

    assets = check_required_assets(args.fetch)
    if assets["missing"]:
        print(f"[parity] missing asset groups: {assets['missing']}")
        print("[parity] run with --fetch on a networked machine, or follow the manual "
              "steps printed by `python -m condmdi_tpu_torch.utils.assets --check`")
        return dict(status="blocked", missing=assets["missing"])

    if not Path(args.model_pt).exists():
        print(f"[parity] released checkpoint not found: {args.model_pt}")
        return dict(status="blocked", missing=[args.model_pt])

    from condmdi_tpu_torch.evals.run import main as eval_main

    argv_eval = [
        "--eval_mode", args.eval_mode,
        "--model_path", args.model_pt,
        "--edit_mode", args.edit_mode,
        "--transition_length", str(args.transition_length),
        "--guidance_param", str(args.guidance_param),
        "--num_samples", str(args.num_samples),
        "--output_dir", args.output_dir,
    ]
    if args.max_replications:
        argv_eval += ["--max_replications", str(args.max_replications)]
    summary = eval_main(argv_eval, device=device)

    expected = json.loads(Path(args.expected).read_text())
    rows = compare(summary, expected)
    print(f"\n[parity] comparison vs {args.expected}:")
    n_fail = n_skip = 0
    for key, measured, exp_v, rel, ok in rows:
        if ok is None:
            print(f"  {key:18s} measured={measured:.4f}  expected=?     "
                  "(fill parity_expected.json from the checkpoints-zip eval log)")
            n_skip += 1
        else:
            print(f"  {key:18s} measured={measured:.4f}  expected={exp_v:.4f}  "
                  f"rel_err={rel:.3f}  {'OK' if ok else 'FAIL'}")
            n_fail += 0 if ok else 1
    verdict = "blocked_expected" if n_skip == len(rows) else ("fail" if n_fail else "pass")
    print(f"[parity] verdict: {verdict} ({n_fail} failing, {n_skip} unfilled)")
    out = dict(status=verdict, rows=rows, summary_keys=sorted(summary))
    report = Path(args.output_dir) / "parity_report.json"
    report.parent.mkdir(parents=True, exist_ok=True)
    report.write_text(json.dumps(out, indent=1, default=str))
    if n_fail and argv is None:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
