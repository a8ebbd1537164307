"""Evaluation CLI (reference `python -m eval.eval_humanml_condmdi`).

Counterpart of condmdi_tpu/evals/run.py, the CondMDI keyframe protocol.
Usage:
  python -m condmdi_tpu_torch.evals.run \
      --model_path save/synthetic_unet_m/gate_ema_000100000.npz \
      --edit_mode benchmark_sparse --guidance_param 1.0 \
      --eval_mode wo_mm|debug|mm_short [--output_dir <dir>]

eval modes (reference eval_humanml_condmdi.py:490-516):
  debug     5 replications
  wo_mm     20 replications, no multimodality (paper protocol)
  mm_short  5 replications + multimodality (30 repeats, 10 times)

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")` runs
on the CPU. The report lands in --output_dir, else in
torch_eval_out/<the checkpoint's directory name> (common.output_dir), under
the JAX report's file name. With
--precision_mode int8_static/int8_static_pc/int8_prequant the activation
scales are calibrated along one dynamic-int8 sampling trajectory first;
--int8_float_last_k K runs the last K model timesteps on the float twin
(models/unet.py MixedStepDenoiser). One card: the JAX package's data-parallel
generation over several devices waits for parallel/ (ROADMAP Queue A 8).
"""

from __future__ import annotations

from pathlib import Path

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


def loaded_params_tree(args, model) -> dict:
    """The parameter tree as loaded, in Flax's layout: what the JAX CLI
    fingerprints (before any int8 calibration or quantization)."""
    from condmdi_tpu_torch.models.flax_init import flax_params
    from condmdi_tpu_torch.utils import checkpoint as ckpt
    from condmdi_tpu_torch.weights import read_params

    mp = args.model_path
    if Path(mp).exists() and mp.endswith(".npz"):
        return read_params(mp)
    if Path(mp).exists() and mp.endswith(".pt"):
        return ckpt.load_torch_checkpoint(
            mp, args.arch,
            **(dict(n_levels=len(args.dim_mults)) if args.arch.startswith("unet")
               else dict(num_layers=args.layers)))
    return {("params",) + path: v for path, v in flax_params(model, args.seed).items()}


def calibrate(model, sched, dcfg, args, batch, ds_rel, ds_abs, T, dev):
    """Trajectory calibration of the static activation scales on the first test
    batch: one dynamic-int8 DDPM run at the protocol guidance with the
    serving-shaped conditioning (abs-space observations, the edit mode's mask);
    x_T and the step noise from a torch.Generator seeded with --seed."""
    from condmdi_tpu_torch.data.convert import rel_to_abs3d
    from condmdi_tpu_torch.ops.quant import calibrate_act_scales_trajectory
    from condmdi_tpu_torch.training.keyframes import get_keyframes_mask

    motion_rel = torch.from_numpy(batch["motion"]).to(dev)
    with torch.no_grad():
        motion_abs = rel_to_abs3d(motion_rel, ds_rel.stats, ds_abs.stats)
    cal_mask = get_keyframes_mask(
        torch.from_numpy(batch["lengths"]).to(dev), T,
        edit_mode=args.edit_mode, trans_length=args.transition_length,
        feature_mode=args.editable_features, n_keyframes=args.n_keyframes,
        generator=torch.Generator().manual_seed(args.seed),
    ) & torch.from_numpy(batch["time_mask"]).to(dev)[..., None]
    calibrate_act_scales_trajectory(
        model, sched.to(dev), dcfg, tuple(motion_rel.shape),
        {"text_embed": torch.from_numpy(batch["text_embed"]).to(dev)},
        guidance_param=args.guidance_param, obs_x0=motion_abs, obs_mask=cal_mask,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
    )


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.evals.harness import EvalConfig, evaluation, generate_eval_batch
    from condmdi_tpu_torch.models.text import encoder_name, make_text_encoder
    from condmdi_tpu_torch.models.unet import MixedStepDenoiser
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling, model_apply_fn
    from condmdi_tpu_torch.utils.checkpoint import params_fingerprint
    from condmdi_tpu_torch.utils.config import EvalArgs, parse_args
    from condmdi_tpu_torch.utils.seed import seed_all

    args = parse_args(EvalArgs, argv)
    # reference parity: every eval entry pins the global RNGs (fixseed,
    # eval_humanml_condmdi.py:461) — the data layer's crop/text choice and the
    # diversity draws use the global numpy RNG.
    seed_all(args.seed)

    k_float = int(getattr(args, "int8_float_last_k", 0))
    pmode = getattr(args, "precision_mode", "float")
    if k_float > 0 and pmode not in ("int8", "int8_static", "int8_static_pc"):
        raise SystemExit(
            "evals.run: --int8_float_last_k requires --precision_mode "
            "int8, int8_static or int8_static_pc (int8_prequant stores "
            "quantized kernels "
            "the float twin cannot apply; float has no int8 leg to mix)."
        )

    args.keyframe_conditioned = True
    mode = eval_mode(args)

    T = args.num_frames
    B = 32  # fixed eval batch (reference :455)
    dev = resolve_device(device)

    model, sched, dcfg = load_model_for_sampling(args, dev)

    # fingerprint the AS-LOADED weights (before int8 calibration changes the
    # model): names the checkpoint contents that produced this report
    fingerprint = params_fingerprint(loaded_params_tree(args, model)) if args.model_path else ""

    # Guard: a model built without keyframe conditioning accepts and ignores
    # obs_x0/obs_mask, so the keyframe protocol would silently measure an
    # unconditioned sampler. Refuse unless explicitly overridden for an
    # ablation baseline.
    model_kc = bool(getattr(model, "keyframe_conditioned", False))
    if not model_kc and args.edit_mode != "uncond":
        if not getattr(args, "allow_unconditioned", False):
            raise SystemExit(
                "evals.run: --model_path points at a model trained WITHOUT "
                "keyframe conditioning (args.json keyframe_conditioned=false); "
                "it ignores obs_x0/obs_mask, so keyframe-protocol metrics "
                "would be meaningless. Train with --keyframe_conditioned true, "
                "or pass --allow_unconditioned true to record an explicit "
                "unconditioned baseline (meta will mark it)."
            )
        print(
            "WARNING: evaluating an UNCONDITIONED model under the keyframe "
            "protocol (--allow_unconditioned) — keyframe metrics are a "
            "no-conditioning baseline, not model performance."
        )

    enc = make_text_encoder(args)
    ds_rel, ds_abs, gt_batches, synthetic_data = load_eval_datasets(args, T, B, enc, dev)

    # int8 protocol runs: static scales calibrated along the trajectory the
    # protocol samples (at guidance > 1 the CFG extrapolation leaves the
    # forward marginals, and q_sample-calibrated ranges clip). An
    # int8_prequant model already holds its int8 codes; calibration fills its
    # activation scales.
    if pmode in ("int8_static", "int8_static_pc", "int8_prequant"):
        calibrate(model, sched, dcfg, args, gt_batches[0], ds_rel, ds_abs, T, dev)
        print(f"eval sampling: precision_mode={pmode} "
              "(act scales trajectory-calibrated)")

    # mixed-step: the int8 model, and its float twin for model timesteps
    # t < K (the original 1000-step scale even under respacing, so K always
    # means the last K of the full reverse process)
    apply_fn = MixedStepDenoiser(model, k_float) if k_float > 0 else model_apply_fn(model)
    pipe = SamplePipeline(
        apply_fn, sched, dcfg,
        SamplerConfig(method="ddim" if args.use_ddim else "ddpm"), device=dev,
    )

    cfg = EvalConfig(
        edit_mode=args.edit_mode,
        transition_length=args.transition_length,
        editable_features=args.editable_features,
        n_keyframes=args.n_keyframes,
        guidance_param=args.guidance_param,
        drop_observations=getattr(args, "drop_observations", False),
        replication_times=mode["replication_times"],
        run_mm=mode["run_mm"],
        mm_num_times=mode["mm_num_times"],
        max_frames=T,
        batch_size=B,
    )

    vec = load_word_vectorizer()
    evaluator, evaluator_source = load_evaluator(dev)

    def generate_fn(rep):
        return [
            generate_eval_batch(pipe, b, args.seed + rep * 1000 + i, cfg,
                                ds_abs.stats, ds_rel.stats)
            for i, b in enumerate(gt_batches)
        ]

    def generate_mm_fn(rep):
        # mm_num_repeats independent samplings of the first batch subset
        # (reference mm_num_samples=100 ≈ 3 batches; scaled to what we have)
        return [
            [
                generate_eval_batch(pipe, b, 9_000_000 + rep * 10_000 + r * 100 + i,
                                    cfg, ds_abs.stats, ds_rel.stats)
                for i, b in enumerate(gt_batches[:3])
            ]
            for r in range(mode["mm_num_repeats"])
        ]

    out_dir = output_dir(args)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if pmode == "float" else f"_{pmode}"
    if k_float > 0:
        suffix += f"_f{k_float}"
    if getattr(args, "drop_observations", False):
        suffix += "_dropobs"
    log_file = out_dir / f"eval_{args.edit_mode}_{args.eval_mode}{suffix}.json"
    summary = evaluation(
        evaluator, gt_batches, generate_fn, cfg, vec, str(log_file),
        generate_mm_fn=generate_mm_fn if mode["run_mm"] else None,
    )
    print_summary(summary)
    # programmatic callers need the identity of the weights too (after
    # print_summary, which iterates metric dicts)
    summary["params_fingerprint"] = fingerprint

    write_report_meta(log_file, {
        "protocol": "condmdi",
        "synthetic_data": synthetic_data,
        "evaluator": evaluator_source,
        "text_encoder": encoder_name(enc),
        "eval_mode": args.eval_mode,
        "edit_mode": args.edit_mode,
        # the keyframe mask's settings (JAX's meta leaves them out)
        "transition_length": args.transition_length,
        "n_keyframes": args.n_keyframes,
        "editable_features": args.editable_features,
        "replications": mode["replication_times"],
        "model_path": args.model_path,
        "params_fingerprint": fingerprint,
        "model_keyframe_conditioned": model_kc,
        "drop_observations": getattr(args, "drop_observations", False),
        "precision_mode": pmode,
        "int8_float_last_k": k_float,
        "guidance_param": args.guidance_param,
        "num_samples": len(gt_batches) * B,
        "seed": args.seed,
        "rng": "global_seeded",
        # the sampler noise: torch generators seeded per batch (not jax.random)
        "noise": "torch.Generator(seed + rep * 1000 + batch)",
        "use_ema": getattr(args, "use_ema", True),
        "framework": f"torch {torch.__version__}",
    }, dev)
    return summary


if __name__ == "__main__":
    main()
