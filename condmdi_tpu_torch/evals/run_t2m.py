"""Legacy text-to-motion evaluation CLI (reference eval/eval_humanml.py).

Counterpart of condmdi_tpu/evals/run_t2m.py. The MDM-style protocol: sample
the model from TEXT ONLY (classifier-free guidance, no keyframe observation)
and score matching / R-precision / FID / diversity / skating (+ multimodality
in mm_short) against the test split over N replications (reference
eval_humanml.py:166-292, mode table :345-372).

Usage:
  python -m condmdi_tpu_torch.evals.run_t2m --model_path save/mdm/model.npz \
      --guidance_param 2.5 --eval_mode wo_mm|debug|mm_short [--output_dir <dir>]

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")` runs
on the CPU. Without --output_dir the report lands in
torch_eval_out/<the checkpoint's directory name> (common.output_dir). Unlike the
JAX CLI, --max_replications caps the replications here as it does in
evals.run.
"""

from __future__ import annotations

import torch

from condmdi_tpu_torch.device import float32_exact
from condmdi_tpu_torch.evals.common import (
    eval_mode,
    load_eval_datasets,
    load_evaluator,
    load_word_vectorizer,
    output_dir,
    print_summary,
    write_report_meta,
)


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.evals.harness import EvalConfig, evaluation, generate_eval_batch
    from condmdi_tpu_torch.models.text import encoder_name, make_text_encoder
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling, model_apply_fn
    from condmdi_tpu_torch.utils.config import EvalArgs, parse_args
    from condmdi_tpu_torch.utils.seed import seed_all

    args = parse_args(EvalArgs, argv)
    # reference parity: every eval entry pins the global RNGs (fixseed)
    seed_all(args.seed)

    args.keyframe_conditioned = False  # text-only protocol
    mode = eval_mode(args)

    T = args.num_frames
    B = 32
    dev = resolve_device(device)

    model, sched, dcfg = load_model_for_sampling(args, dev)
    pipe = SamplePipeline(
        model_apply_fn(model), sched, dcfg,
        SamplerConfig(method="ddim" if args.use_ddim else "ddpm"), device=dev,
    )

    enc = make_text_encoder(args, device=dev)
    ds_rel, ds_abs, gt_batches, synthetic_data = load_eval_datasets(args, T, B, enc, dev)

    cfg = EvalConfig(
        guidance_param=args.guidance_param,
        replication_times=mode["replication_times"],
        run_mm=mode["run_mm"],
        mm_num_times=mode["mm_num_times"],
        max_frames=T,
        batch_size=B,
        keyframe_conditioned=False,
        report_keyframe_metrics=False,
    )

    vec = load_word_vectorizer()
    evaluator, evaluator_source = load_evaluator(dev)

    def generate_fn(rep):
        return [
            generate_eval_batch(pipe, b, args.seed + rep * 1000 + i, cfg,
                                ds_abs.stats, ds_rel.stats, model_is_abs=args.abs_3d)
            for i, b in enumerate(gt_batches)
        ]

    def generate_mm_fn(rep):
        return [
            [
                generate_eval_batch(pipe, b, 9_000_000 + rep * 10_000 + r * 100 + i,
                                    cfg, ds_abs.stats, ds_rel.stats, model_is_abs=args.abs_3d)
                for i, b in enumerate(gt_batches[:3])
            ]
            for r in range(mode["mm_num_repeats"])
        ]

    out_dir = output_dir(args)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_file = out_dir / f"eval_humanml_{args.eval_mode}.json"
    summary = evaluation(
        evaluator, gt_batches, generate_fn, cfg, vec, str(log_file),
        generate_mm_fn=generate_mm_fn if mode["run_mm"] else None,
    )
    print_summary(summary)

    write_report_meta(log_file, {
        "protocol": "eval_humanml (legacy t2m)",
        "synthetic_data": synthetic_data,
        "evaluator": evaluator_source,
        "text_encoder": encoder_name(enc),
        "eval_mode": args.eval_mode,
        "guidance_param": args.guidance_param,
        "replications": mode["replication_times"],
        "model_path": args.model_path,
        "framework": f"torch {torch.__version__}",
    }, dev)
    return summary


if __name__ == "__main__":
    main()
