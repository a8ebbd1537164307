"""Action-to-motion evaluation CLI (reference eval/eval_humanact12_uestc.py).

Counterpart of condmdi_tpu/evals/run_a2m.py. Protocol: generate motions
conditioned on the GT batch's action labels with MDM (`trans_enc`,
`cond_mode="action"`), score accuracy / FID / diversity against the GT
features of the recognition model (the GRU for HumanAct12, ST-GCN for UESTC;
reference a2m/gru_eval.py, a2m/stgcn_eval.py), and aggregate mean ± 1.96σ/√n
over the replications.

Inputs, each falling back LOUDLY (a warning, and the report's meta records it):
  data        HumanAct12Dataset / UESTCDataset pickles → SyntheticA2MDataset
  classifier  the recognition checkpoint (--classifier_ckpt) → random init
  model       --model_path, a flat Flax npz of an action MDM → Flax's
              initialisation from --seed (a plumbing run); an Orbax directory
              raises (export it with scripts/gate_params_io.py)

Usage:
  python -m condmdi_tpu_torch.evals.run_a2m --dataset humanact12 \
      --eval_mode debug [--model_path ...] [--classifier_ckpt ...]

Runs on the card in full float32 (no TF32); `main(argv, device="cpu")` runs on
the CPU. The sampler's step replays from CUDA graphs on the card; each batch's
x_T and step noise come from torch.Generator(seed + rep*1000 + batch), so the
port's samples are JAX's statistically, not draw for draw. Without
--output_dir the report goes to torch_eval_out/ (common.output_dir), never
into save/, under the JAX report's file name.
"""

from __future__ import annotations

import argparse
import json
import warnings
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact
from condmdi_tpu_torch.evals.common import EVAL_MODES, output_dir, print_summary, write_report_meta

A2M_FEATS = 150  # 25 joints × rot6d


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["humanact12", "uestc"], default="humanact12")
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
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--output_dir", default="")
    return p


def load_a2m_data(args):
    """(dataset, num_actions, synthetic_flag), with the loud fallback."""
    from condmdi_tpu_torch.data.a2m import HumanAct12Dataset, SyntheticA2MDataset, UESTCDataset

    try:
        if args.dataset == "uestc":
            ds = UESTCDataset(datapath=args.datapath or "dataset/uestc",
                              num_frames=args.num_frames)
            return ds, ds.NUM_ACTIONS, False
        ds = HumanAct12Dataset(datapath=args.datapath or "dataset/HumanAct12Poses",
                               num_frames=args.num_frames)
        return ds, 12, False
    except FileNotFoundError:
        warnings.warn(
            f"{args.dataset} assets absent — evaluating on SYNTHETIC "
            "action-conditioned clips (report carries synthetic_data=true).",
            stacklevel=2,
        )
        na = 40 if args.dataset == "uestc" else 12
        return (
            SyntheticA2MDataset(size=max(args.num_samples, args.batch_size), num_actions=na,
                                seed=args.seed, num_frames=args.num_frames),
            na,
            True,
        )


class _STGCNOnA2MFeatures:
    """Adapter: [B, T, 150] a2m rot6d features → ST-GCN's [B, T, 24, 6] (the
    SMPL layout; the trailing 6 features are the translation row)."""

    def __init__(self, clf):
        self.clf = clf

    def __call__(self, motion, lengths):
        m = np.asarray(motion)
        B, T, _ = m.shape
        return self.clf(m[..., :144].reshape(B, T, 24, 6), lengths)


def load_classifier(args, num_actions, device: str | torch.device = "cuda"):
    """(classifier, source): the checkpoint's, or a random init (warned)."""
    from condmdi_tpu_torch.evals.a2m import A2MClassifier, STGCNClassifier

    if args.classifier_ckpt and Path(args.classifier_ckpt).exists():
        if args.dataset == "uestc":
            clf = STGCNClassifier.from_torch_checkpoint(args.classifier_ckpt, device)
            return _STGCNOnA2MFeatures(clf), "checkpoint"
        return A2MClassifier.from_torch_checkpoint(args.classifier_ckpt, device), "checkpoint"
    warnings.warn(
        "recognition-model checkpoint absent — random-init classifier; "
        "accuracy/FID are meaningless as absolute numbers.",
        stacklevel=2,
    )
    if args.dataset == "uestc":
        clf = STGCNClassifier.random_init(num_class=num_actions, device=device)
        return _STGCNOnA2MFeatures(clf), "random_init"
    return A2MClassifier.random_init(num_actions=num_actions, device=device), "random_init"


def load_mdm(args, cond_mode: str, num_actions: int, device: torch.device):
    """The protocol's MDM (trans_enc, ff 2·latent, 4 heads) on `device`: the flat
    Flax npz at --model_path, else Flax's initialisation from --seed."""
    from condmdi_tpu_torch.models.flax_init import load_flax_init, load_params
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.weights import load_flax_params

    model = MDM(njoints=25, nfeats=6, latent_dim=args.latent_dim, ff_size=args.latent_dim * 2,
                num_layers=args.layers, num_heads=4, cond_mode=cond_mode,
                num_actions=num_actions, device=device, seed=None)
    mp = args.model_path
    if mp and Path(mp).is_dir():
        raise ValueError(f"{mp} is an Orbax checkpoint directory, which only the JAX package "
                         "can restore: export it to a flat npz (scripts/gate_params_io.py)")
    if mp and Path(mp).exists():
        load_params(model, load_flax_params(mp))
    else:
        if mp:
            warnings.warn(f"--model_path {mp} not found — Flax's initialisation from --seed",
                          stacklevel=2)
        load_flax_init(model, args.seed)
    return model.requires_grad_(False).eval()


def make_pipeline(model, diffusion_steps: int, device: torch.device):
    """SamplePipeline over `model` with the JAX CLI's setup: the cosine schedule
    at `diffusion_steps`, the default DiffusionConfig and DDPM."""
    from condmdi_tpu_torch.diffusion import (
        DiffusionConfig,
        DiffusionSchedule,
        SamplerConfig,
        get_named_beta_schedule,
    )
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", diffusion_steps))
    return SamplePipeline(lambda x, t, y, **_: model(x, t, y), sched, DiffusionConfig(),
                          SamplerConfig(), device=device)


def summarize(results: dict, replications: int) -> OrderedDict:
    from condmdi_tpu_torch.evals.metrics import get_metric_statistics

    summary = OrderedDict()
    for k, vals in results.items():
        mean, ci = get_metric_statistics(np.asarray(vals), replications)
        summary[k] = dict(mean=np.asarray(mean).tolist(), conf=np.asarray(ci).tolist())
    return summary


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.data.dataset import collate
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.evals.a2m import evaluate_a2m
    from condmdi_tpu_torch.utils.seed import seed_all

    args = build_parser().parse_args(argv)
    # reference parity: every eval entry pins the global RNGs (fixseed); the data
    # layer's crops use the global numpy RNG
    seed_all(args.seed)
    dev = resolve_device(device)

    mode = EVAL_MODES.get(args.eval_mode, EVAL_MODES["debug"])
    ds, num_actions, synthetic_data = load_a2m_data(args)
    classifier, classifier_source = load_classifier(args, num_actions, dev)

    B = min(args.batch_size, len(ds))
    T = args.num_frames
    model = load_mdm(args, "action", num_actions, dev)
    pipe = make_pipeline(model, args.diffusion_steps, dev)

    n_batches = max(1, args.num_samples // B)
    gt_batches = [collate([ds[(bi * B + i) % len(ds)] for i in range(B)], T)
                  for bi in range(n_batches)]

    results = {"accuracy": [], "fid": [], "diversity": []}
    for rep in range(mode["replication_times"]):
        gen_m = []
        for bi, batch in enumerate(gt_batches):
            actions = torch.as_tensor(batch["action"], device=dev).long()
            sample = pipe.sample(
                (B, T, A2M_FEATS), {"action": actions},
                generator=torch.Generator(device=dev).manual_seed(args.seed + rep * 1000 + bi))
            gen_m.append(sample.cpu().numpy())
        cat = lambda key: np.concatenate([b[key] for b in gt_batches])  # noqa: E731
        out = evaluate_a2m(
            classifier, cat("motion"), cat("lengths"), cat("action"),
            np.concatenate(gen_m), cat("lengths"), cat("action"),
            rng=np.random.default_rng(args.seed + rep),
        )
        for k in results:
            results[k].append(out[k])

    summary = summarize(results, mode["replication_times"])
    print_summary(summary)

    out_dir = output_dir(args)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_file = out_dir / f"eval_a2m_{args.dataset}_{args.eval_mode}.json"
    log_file.write_text(json.dumps(summary, indent=1))
    write_report_meta(log_file, {
        "protocol": "a2m",
        "dataset": args.dataset,
        "synthetic_data": synthetic_data,
        "classifier": classifier_source,
        "model_path": args.model_path or "random_init",
        "eval_mode": args.eval_mode,
        "replications": mode["replication_times"],
        "num_samples": n_batches * B,
        "framework": f"torch {torch.__version__}",
    }, dev)
    return summary


if __name__ == "__main__":
    main()
