"""Shared scaffolding for the evaluation CLIs (run / run_t2m).

Counterpart of condmdi_tpu/evals/common.py. Each protocol CLI mirrors one
reference eval script:
  evals.run           ↔ eval/eval_humanml_condmdi.py  (CondMDI keyframe protocol)
  evals.run_t2m       ↔ eval/eval_humanml.py          (legacy MDM text-to-motion)
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import torch


def load_eval_datasets(args, T: int, B: int, enc, device: str | torch.device = "cuda"):
    """(ds_rel, ds_abs, gt_batches, synthetic_data) — test split, collated.

    Reads HumanML3D's test split from its files where they are, and falls back
    to synthetic data LOUDLY where they are absent (Text2MotionDataset raises
    FileNotFoundError); callers must propagate `synthetic_data` into the report
    meta. The synthetic set's codec runs on
    `device`. Collating draws each item's crop and caption from the global
    np.random, in the JAX package's order.
    """
    from condmdi_tpu_torch.data.dataset import (
        DatasetConfig,
        SyntheticMotionDataset,
        Text2MotionDataset,
        collate,
    )

    synthetic_data = False
    data_cfg_rel = DatasetConfig(max_motion_length=T, abs_3d=False, split="test")
    data_cfg_abs = DatasetConfig(max_motion_length=T, abs_3d=True, split="test")
    try:
        ds_rel = Text2MotionDataset(data_cfg_rel)
        ds_abs = Text2MotionDataset(data_cfg_abs)
    except FileNotFoundError:
        warnings.warn(
            "HumanML3D assets absent — evaluating on SYNTHETIC data. The "
            "report will carry synthetic_data=true; its numbers are NOT "
            "comparable to paper numbers.",
            stacklevel=2,
        )
        synthetic_data = True
        # size the synthetic test split to the requested protocol scale
        # (reference wo_mm: num_samples=1000, eval_humanml_condmdi.py:488)
        n_req = max(getattr(args, "num_samples", 32), B)
        size = max(B * 2, ((n_req + B - 1) // B) * B)
        ds_rel = SyntheticMotionDataset(data_cfg_rel, size=size, seed=1, device=device)
        ds_abs = SyntheticMotionDataset(data_cfg_abs, size=size, seed=1, device=device)

    n_batches = max(
        1, min(len(ds_rel) // B, max(getattr(args, "num_samples", 32), B) // B)
    )
    gt_batches = []
    for bi in range(n_batches):
        batch = collate([ds_rel[bi * B + i] for i in range(B)], T, enc)
        if not any(batch["tokens"]):  # synthetic data carries no tokens
            batch["tokens"] = [["a/DET", "person/NOUN", "moves/VERB"]] * B
        gt_batches.append(batch)
    return ds_rel, ds_abs, gt_batches, synthetic_data


def load_word_vectorizer():
    from condmdi_tpu_torch.data.word_vectorizer import HashWordVectorizer, WordVectorizer

    try:
        return WordVectorizer("glove")
    except Exception:
        return HashWordVectorizer()


TRAINED_EVALUATOR = Path("save/evaluator_synth/evaluator.npz")


def load_evaluator(device: str | torch.device = "cuda"):
    """(evaluator, source) — resolution order, paths relative to the working
    directory as in the JAX package:
      1. converted reference T2M checkpoint (absolute paper-comparable numbers)
      2. the in-image contrastively-trained synthetic evaluator
         (condmdi_tpu/evals/train_evaluator.py) — DISCRIMINATIVE on the
         synthetic population (R-precision well above chance), not
         paper-comparable
      3. LOUD random-init fallback (absolute numbers meaningless)."""
    from condmdi_tpu_torch.evals.evaluator import EvaluatorWrapper

    eval_ckpt = Path("t2m/text_mot_match/model/finest.tar")
    if eval_ckpt.exists():
        return EvaluatorWrapper.from_torch_checkpoint(str(eval_ckpt), device), "checkpoint"
    if TRAINED_EVALUATOR.exists():
        from condmdi_tpu_torch.evals.train_evaluator import load_params_npz

        return (
            EvaluatorWrapper(load_params_npz(TRAINED_EVALUATOR), device),
            "trained_synthetic",
        )
    warnings.warn(
        "No evaluator checkpoint (neither the reference T2M one nor the "
        "in-image trained synthetic one) — using a RANDOM-INIT evaluator. "
        "FID/R-precision from this run are meaningless as absolute numbers; "
        "the report will carry evaluator=random_init.",
        stacklevel=2,
    )
    return EvaluatorWrapper.random_init(0, device=device), "random_init"


def output_dir(args) -> Path:
    """--output_dir, else torch_eval_out/<the checkpoint's directory name> (or
    torch_eval_out/eval_out without a checkpoint) under the working directory:
    the report keeps the JAX report's file name, never its directory."""
    if getattr(args, "output_dir", ""):
        return Path(args.output_dir)
    parent = Path(args.model_path).resolve().parent.name if args.model_path else "eval_out"
    return Path("torch_eval_out") / parent


def write_report_meta(log_file: Path, meta: dict, device: str | torch.device = "cuda") -> None:
    """Attach the self-describing meta block to the summary json.

    Every report records where it was generated: `platform` is the torch
    device type ("cuda" or "cpu"), `device_name` the card's name, `devices`
    the number of devices used (one); callers may override them.
    """
    dev = torch.device(device)
    try:
        blob = json.loads(Path(log_file).read_text())
    except Exception:
        blob = {}
    meta = dict(meta)
    meta.setdefault("platform", dev.type)
    meta.setdefault("device_name",
                    torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    meta.setdefault("devices", 1)
    blob["meta"] = meta
    Path(log_file).write_text(json.dumps(blob, indent=1, default=str))


def print_summary(summary: dict) -> None:
    for k, v in summary.items():
        if not isinstance(v, dict) or "mean" not in v:
            continue  # identity fields (params_fingerprint), not metrics
        print(f"{k}: {v['mean']} ± {v['conf']}")


# reference eval-mode tables (eval_humanml.py:345-372, eval_humanml_condmdi.py:490-516)
EVAL_MODES = {
    "debug": dict(replication_times=5, run_mm=False, mm_num_repeats=0, mm_num_times=0),
    "wo_mm": dict(replication_times=20, run_mm=False, mm_num_repeats=0, mm_num_times=0),
    "mm_short": dict(replication_times=5, run_mm=True, mm_num_repeats=30, mm_num_times=10),
}


def eval_mode(args) -> dict:
    """The eval mode's table entry, its replications capped by
    --max_replications where that is set."""
    mode = EVAL_MODES.get(args.eval_mode, EVAL_MODES["wo_mm"])
    if getattr(args, "max_replications", 0):
        mode = {**mode, "replication_times": min(
            mode["replication_times"], args.max_replications
        )}
    return mode
