"""The port's CondMDI keyframe protocol on the gate checkpoint, held to the committed reports' spread.

    python3 eval_protocol.py [float] [int8]      (both when no leg is named)

Runs `condmdi_tpu_torch.evals.run` on the card with the settings of the two
committed reports of save/synthetic_unet_m (their `meta`): benchmark_sparse,
wo_mm, guidance 1.0, --num_samples 1000 (992 samples, 31 batches of 32),
seed 10, the hash text encoder, the gate npz (params_fingerprint
0d69067e95b7d9da), the 1000-step DDPM in float32:

  float  --max_replications 2, against eval_benchmark_sparse_wo_mm.json
  int8   --precision_mode int8_static --int8_float_last_k 250
         --max_replications 1, against eval_benchmark_sparse_wo_mm_int8_static_f250.json

The two frameworks draw different noise streams, so the comparison is
statistical: for each metric (each entry of a vector metric), the port's mean
over its n replications should lie within 3·σ·√(1/n + 1/20) of the committed
mean over 20, σ being the committed per-replication standard deviation (ddof 1).
The keyframe mask is the committed reports' (a keyframe every 30th frame; see
COMMITTED_MASK): a run whose mask settings differ is refused, before it
starts and again on its report's meta.
Prints one JSON line per leg (each metric: port mean, committed mean, σ, band,
inside or not; seconds; samples/s; the card's name and power limit) and writes
the reports and the lines under chiprun_out/eval_protocol/. A metric outside
its band is reported, not an error: the script fails only if a run fails or its
fingerprint is not the gate's.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GATE = ROOT / "save" / "synthetic_unet_m"
OUT = ROOT / "chiprun_out" / "eval_protocol"
COMMON = ["--model_path", str(GATE / "gate_ema_000100000.npz"), "--edit_mode", "benchmark_sparse",
          "--eval_mode", "wo_mm", "--guidance_param", "1.0", "--num_samples", "1000",
          "--seed", "10", "--text_encoder", "hash"]
LEGS = {
    "float": (["--max_replications", "2"], "eval_benchmark_sparse_wo_mm.json"),
    "int8": (["--precision_mode", "int8_static", "--int8_float_last_k", "250",
              "--max_replications", "1"], "eval_benchmark_sparse_wo_mm_int8_static_f250.json"),
}
COMMITTED_REPLICATIONS = 20
# The keyframe mask's settings. The committed reports' meta does not record them;
# they were made with no mask flag (scripts/round5_battery3.sh:78-91 for the float
# and int8_static reports; the f250 report is the same command with
# --int8_float_last_k 250, BENCH_NOTES.md's round-5 table), so with EvalArgs'
# defaults: a keyframe every 30th frame.
MASK_KEYS = ("transition_length", "n_keyframes", "editable_features")
COMMITTED_MASK = dict(transition_length=30, n_keyframes=5, editable_features="pos_rot_vel")


def check_mask(label: str, got: dict, meta: dict) -> None:
    """Refuse a comparison whose keyframe mask is not the committed report's."""
    want = {key: meta.get(key, COMMITTED_MASK[key]) for key in MASK_KEYS}
    if got != want:
        raise SystemExit(f"{label}: mask settings {got} are not the committed report's {want}")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bands(port: dict, committed: dict, n: int) -> dict:
    """metric -> list of {port, committed, sigma, band, inside} per entry."""
    out = {}
    for key, reps in committed["per_replication"].items():
        ref = np.atleast_2d(np.asarray(reps, np.float64).T).T  # [20, entries]
        got = np.atleast_2d(np.asarray(port["per_replication"][key], np.float64).T).T
        sigma = ref.std(axis=0, ddof=1)
        band = 3 * sigma * np.sqrt(1 / n + 1 / COMMITTED_REPLICATIONS)
        mean_ref, mean_got = ref.mean(axis=0), got.mean(axis=0)
        out[key] = [dict(port=float(g), committed=float(r), sigma=float(s), band=float(b),
                         gap=float(g - r), inside=bool(abs(g - r) <= b))
                    for g, r, s, b in zip(mean_got, mean_ref, sigma, band)]
    return out


def run_leg(name: str, card: str) -> dict:
    import torch

    from condmdi_tpu_torch.evals.run import main

    from condmdi_tpu_torch.utils.config import EvalArgs, parse_args

    extra, committed_name = LEGS[name]
    committed = json.loads((GATE / committed_name).read_text())
    args = parse_args(EvalArgs, COMMON + extra)
    check_mask(name, {key: getattr(args, key) for key in MASK_KEYS}, committed["meta"])
    out_dir = OUT / name
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main(COMMON + extra + ["--output_dir", str(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (path,) = out_dir.glob("eval_*.json")
    port = json.loads(path.read_text())
    check_mask(f"{name} report", {key: port["meta"][key] for key in MASK_KEYS}, committed["meta"])
    if port["meta"]["params_fingerprint"] != committed["meta"]["params_fingerprint"]:
        raise SystemExit(f"{name}: fingerprint {port['meta']['params_fingerprint']} is not the "
                         f"committed report's {committed['meta']['params_fingerprint']}")
    n = port["meta"]["replications"]
    samples = port["meta"]["num_samples"] * n
    return dict(leg=name, card=card, report=str(path.relative_to(ROOT)),
                mask={key: port["meta"][key] for key in MASK_KEYS},
                committed=str((GATE / committed_name).relative_to(ROOT)), replications=n,
                samples=samples, seconds=seconds, samples_per_s=samples / seconds,
                bands=bands(port, committed, n))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("eval_protocol: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    legs = argv or list(LEGS)
    card = card_line()
    OUT.mkdir(parents=True, exist_ok=True)
    for name in legs:
        line = run_leg(name, card)
        for key, entries in line["bands"].items():
            for i, e in enumerate(entries):
                print(f"[{name}] {key}[{i}]: port {e['port']:.5f}, committed {e['committed']:.5f} "
                      f"(sigma {e['sigma']:.5f}), gap {e['gap']:+.5f}, band {e['band']:.5f}: "
                      f"{'inside' if e['inside'] else 'OUTSIDE'}", flush=True)
        (OUT / f"{name}.json").write_text(json.dumps(line, indent=1))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
