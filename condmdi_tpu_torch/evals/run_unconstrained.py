"""Unconstrained-generation evaluation CLI (reference
eval/unconstrained/evaluate.py).

Counterpart of condmdi_tpu/evals/run_unconstrained.py. Protocol: sample an
UNCONDITIONED MDM (`trans_enc`, `cond_mode="no_cond"`), extract recognition
features for the generated and the GT motions, score FID / KID /
precision-recall / diversity (evals.unconstrained), and aggregate
mean ± 1.96σ/√n over the replications.

The feature extractor is ST-GCN on the a2m rot6d features directly (the SMPL
layout, 6 input channels), as in the JAX package; the reference's openpose
xyz extractor needs the SMPL body and keypoint-projection assets. Absolute
numbers need the reference recognition checkpoint (--classifier_ckpt); without
it the extractor is a random init, warned and recorded in the report's meta,
as are the synthetic HumanAct12 clips and a model from Flax's initialisation
(see evals.run_a2m, whose data, classifier and model loading this shares).

Usage:
  python -m condmdi_tpu_torch.evals.run_unconstrained --eval_mode debug \
      [--model_path ...] [--classifier_ckpt ...]

Runs on the card in full float32; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact
from condmdi_tpu_torch.evals.common import EVAL_MODES, output_dir, print_summary, write_report_meta
from condmdi_tpu_torch.evals.run_a2m import (
    A2M_FEATS,
    _STGCNOnA2MFeatures,
    load_a2m_data,
    load_mdm,
    make_pipeline,
    summarize,
)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", default="")
    p.add_argument("--model_path", default="")
    p.add_argument("--classifier_ckpt", default="")
    p.add_argument("--eval_mode", default="debug")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--num_frames", type=int, default=60)
    p.add_argument("--diffusion_steps", type=int, default=50)
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--kid_subsets", type=int, default=10)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--output_dir", default="")
    return p


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.data.dataset import collate
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.evals.a2m import STGCNClassifier
    from condmdi_tpu_torch.evals.unconstrained import evaluate_unconstrained
    from condmdi_tpu_torch.utils.seed import seed_all

    args = build_parser().parse_args(argv)
    # reference parity: every eval entry pins the global RNGs (fixseed)
    seed_all(args.seed)
    dev = resolve_device(device)

    args.dataset = "humanact12"  # the reference protocol runs on HumanAct12
    mode = EVAL_MODES.get(args.eval_mode, EVAL_MODES["debug"])
    ds, _, synthetic_data = load_a2m_data(args)

    if args.classifier_ckpt and Path(args.classifier_ckpt).exists():
        clf = _STGCNOnA2MFeatures(STGCNClassifier.from_torch_checkpoint(args.classifier_ckpt,
                                                                        dev))
        classifier_source = "checkpoint"
    else:
        warnings.warn(
            "recognition checkpoint absent — random-init ST-GCN features; "
            "FID/KID are meaningless as absolute numbers.",
            stacklevel=2,
        )
        clf = _STGCNOnA2MFeatures(STGCNClassifier.random_init(num_class=12, device=dev))
        classifier_source = "random_init"

    B = min(args.batch_size, len(ds))
    T = args.num_frames
    model = load_mdm(args, "no_cond", 1, dev)
    pipe = make_pipeline(model, args.diffusion_steps, dev)

    n_batches = max(1, args.num_samples // B)
    gt = collate([ds[i % len(ds)] for i in range(n_batches * B)], T)
    _, gt_feat = clf(gt["motion"], gt["lengths"])

    results = {"fid": [], "kid": [], "precision": [], "recall": [], "diversity": []}
    for rep in range(mode["replication_times"]):
        gens = []
        for bi in range(n_batches):
            sample = pipe.sample(
                (B, T, A2M_FEATS), {},
                generator=torch.Generator(device=dev).manual_seed(args.seed + rep * 1000 + bi))
            gens.append(sample.cpu().numpy())
        gen = np.concatenate(gens)
        _, gen_feat = clf(gen, np.full((len(gen),), T, np.int32))
        out = evaluate_unconstrained(
            gen_feat, gt_feat, n_subsets=args.kid_subsets,
            subset_size=min(len(gen_feat), 64),
            rng=np.random.default_rng(args.seed + rep),
        )
        for k in results:
            results[k].append(out[k])

    summary = summarize(results, mode["replication_times"])
    print_summary(summary)

    out_dir = output_dir(args)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_file = out_dir / f"eval_unconstrained_{args.eval_mode}.json"
    log_file.write_text(json.dumps(summary, indent=1))
    write_report_meta(log_file, {
        "protocol": "unconstrained",
        "synthetic_data": synthetic_data,
        "classifier": classifier_source,
        "features": "stgcn_smpl_rot6d",
        "model_path": args.model_path or "random_init",
        "eval_mode": args.eval_mode,
        "replications": mode["replication_times"],
        "num_samples": n_batches * B,
        "framework": f"torch {torch.__version__}",
    }, dev)
    return summary


if __name__ == "__main__":
    main()
