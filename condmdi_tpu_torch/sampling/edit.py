"""Inference-time editing CLI on the UNCONDITIONED model (reference sample/edit.py:25).

Counterpart of condmdi_tpu/sampling/edit.py. Conditioning enters only
through imputation and reconstruction guidance (the
`inpainted_motion`/`inpainting_mask` state inside p_mean_variance); the model
itself is not keyframe-conditioned. Usage:

  python -m condmdi_tpu_torch.sampling.edit --edit_mode benchmark_clip \
      --imputate true [--reconstruction_guidance true] ...

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")`
runs on the CPU. Saves results.npy {motion, joints, text, lengths,
inpainted_motion, inpainting_mask, edit_mode, text_encoder} as the JAX CLI
does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.data.dataset import (
        DatasetConfig, SyntheticMotionDataset, Text2MotionDataset, collate,
    )
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.models.text import encoder_name, make_text_encoder
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline, build_inpainting_state
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling, model_apply_fn
    from condmdi_tpu_torch.training.keyframes import get_keyframes_mask
    from condmdi_tpu_torch.utils.config import EDIT_MODES, CondSyntArgs, parse_args

    args = parse_args(CondSyntArgs, argv)
    if args.edit_mode not in EDIT_MODES:
        raise SystemExit(
            f"error: --edit_mode must be one of {', '.join(EDIT_MODES)} "
            f"(got {args.edit_mode!r})"
        )
    args.keyframe_conditioned = False  # edit drives the unconditioned model
    if not (args.imputate or args.reconstruction_guidance):
        args.imputate = True  # editing without either is a no-op
    dev = resolve_device(device)
    n_frames = args.num_frames

    model, sched, dcfg = load_model_for_sampling(args, dev)
    F = model.input_feats

    data_cfg = DatasetConfig(max_motion_length=n_frames, abs_3d=args.abs_3d, split="test")
    try:
        ds = Text2MotionDataset(data_cfg)
    except FileNotFoundError:
        ds = SyntheticMotionDataset(data_cfg, size=max(args.num_samples, 4), device=dev)
    encoder = make_text_encoder(args, device=dev)
    batch = collate([ds[i] for i in range(args.num_samples)], n_frames, encoder)
    B = batch["motion"].shape[0]

    inpainted_motion = torch.from_numpy(batch["motion"]).to(dev)
    inpainting_mask = get_keyframes_mask(
        torch.from_numpy(batch["lengths"]).to(dev), n_frames,
        edit_mode=args.edit_mode,
        trans_length=args.transition_length,
        feature_mode=args.editable_features,
        n_keyframes=args.n_keyframes,
        generator=torch.Generator().manual_seed(args.seed),
    )
    inpaint = build_inpainting_state(
        inpainted_motion,
        inpainting_mask,
        time_mask=torch.from_numpy(batch["time_mask"]).to(dev),
        imputate=args.imputate,
        reconstruction_guidance=args.reconstruction_guidance,
        reconstruction_weight=args.reconstruction_weight,
        gradient_schedule=args.gradient_schedule,
        stop_imputation_at=args.stop_imputation_at,
        stop_recguidance_at=args.stop_recguidance_at,
        replacement_distribution=args.replacement_distribution,
        diffusion_steps=args.diffusion_steps,
    )

    y = {"text_embed": torch.from_numpy(batch["text_embed"]).to(dev)}
    if args.text_condition == "":
        y["uncond"] = True  # unconditioned editing (edit.py:86-90)

    pipe = SamplePipeline(model_apply_fn(model), sched, dcfg,
                          SamplerConfig(method="ddim" if args.use_ddim else "ddpm"), device=dev)

    all_motions = []
    for rep in range(args.num_repetitions):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 17 * rep)
        all_motions.append(pipe.sample(
            (B, n_frames, F), y,
            guidance_param=args.guidance_param if args.text_condition else 1.0,
            inpaint=inpaint, generator=gen,
        ))
    joints = [pipe.sample_to_joints(m, ds.denormalize, args.abs_3d).cpu().numpy()
              for m in all_motions]

    out_dir = Path(args.output_dir or "save/edit_out")
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(
        out_dir / "results.npy",
        {
            "motion": np.concatenate([m.cpu().numpy() for m in all_motions], axis=0),
            "joints": np.concatenate(joints, axis=0),
            "text": batch["text"] * args.num_repetitions,
            "lengths": np.tile(batch["lengths"], args.num_repetitions),
            "inpainted_motion": inpainted_motion.cpu().numpy(),
            "inpainting_mask": inpainting_mask.cpu().numpy(),
            "edit_mode": args.edit_mode,
            "text_encoder": encoder_name(encoder),
        },
    )
    print(f"saved {out_dir/'results.npy'}")
    return out_dir


if __name__ == "__main__":
    main()
