"""Keyframe-conditioned sampling CLI (reference sample/conditional_synthesis.py:55).

Counterpart of condmdi_tpu/sampling/conditional.py. Usage:

  python -m condmdi_tpu_torch.sampling.conditional --edit_mode benchmark_sparse \
      --model_path save/synthetic_unet_m/gate_ema_000100000.npz --num_samples 4 \
      [--imputate true] [--reconstruction_guidance true] [--guidance_param 2.5]

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")` runs
on the CPU. Builds obs_x0/obs_mask from the first test batch through the
edit-mode zoo, runs the keyframe-conditioned model (optionally with
imputation and reconstruction guidance) and saves results.npy {motion,
joints, text, lengths, observed_motion, observed_mask, edit_mode,
text_encoder} as the JAX CLI does.
The random edit modes draw their masks from a torch.Generator seeded with
--seed, so they differ from JAX's draw for draw (training/keyframes.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact


def parse_cli_args(argv=None):
    """`main`'s arguments from `argv`: parsed, checked, keyframe-conditioned."""
    from condmdi_tpu_torch.utils.config import EDIT_MODES, CondSyntArgs, parse_args

    args = parse_args(CondSyntArgs, argv)
    if args.edit_mode not in EDIT_MODES:
        raise SystemExit(
            f"error: --edit_mode must be one of {', '.join(EDIT_MODES)} "
            f"(got {args.edit_mode!r})"
        )
    args.keyframe_conditioned = True
    if getattr(args, "keyframe_guidance_param", 1.0) != 1.0:
        # as the reference (conditional_synthesis.py:139-140)
        raise NotImplementedError("keyframe_guidance_param != 1 is not implemented")
    return args


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

    args = parse_cli_args(argv)
    dev = resolve_device(device)
    n_frames = args.num_frames  # the flag's, before a checkpoint's args.json is read

    model, sched, dcfg = load_model_for_sampling(args, dev)
    F = model.input_feats

    # data: the first test batch (the synthetic set where HumanML3D is absent)
    dcfg_data = DatasetConfig(max_motion_length=n_frames, abs_3d=args.abs_3d, split="test")
    try:
        ds = Text2MotionDataset(dcfg_data)
    except FileNotFoundError:
        ds = SyntheticMotionDataset(dcfg_data, size=max(args.num_samples, 4), device=dev)
    encoder = make_text_encoder(args, device=dev)
    if getattr(args, "use_fixed_dataset", False):
        # curated reproducible samples (reference --use_fixed_dataset)
        from condmdi_tpu_torch.data.fixed_dataset import (
            DEFAULT_PATH, load_fixed_dataset, make_synthetic_fixture,
        )

        if not DEFAULT_PATH.exists():
            make_synthetic_fixture(DEFAULT_PATH, n=max(args.num_samples, 8), T=n_frames,
                                   device=dev)
        batch = load_fixed_dataset(args.num_samples, text_encoder=encoder)
    else:
        batch = collate([ds[i] for i in range(args.num_samples)], n_frames, encoder)
    B = batch["motion"].shape[0]

    obs_x0 = torch.from_numpy(batch["motion"]).to(dev)
    time_mask = torch.from_numpy(batch["time_mask"]).to(dev)
    obs_mask = get_keyframes_mask(
        torch.from_numpy(batch["lengths"]).to(dev), n_frames,
        edit_mode=args.edit_mode,
        trans_length=args.transition_length,
        feature_mode=args.editable_features,
        n_keyframes=args.n_keyframes,
        generator=torch.Generator().manual_seed(args.seed),
    )
    obs_mask = obs_mask & time_mask[..., None]

    text_embed = torch.from_numpy(batch["text_embed"]).to(dev)
    y = {"text_embed": torch.zeros_like(text_embed) if args.no_text else text_embed}

    inpaint = None
    if args.imputate or args.reconstruction_guidance:
        inpaint = build_inpainting_state(
            obs_x0,
            obs_mask,
            time_mask=time_mask,
            imputate=args.imputate,
            reconstruction_guidance=args.reconstruction_guidance,
            reconstruction_weight=args.reconstruction_weight,
            gradient_schedule=args.gradient_schedule,
            stop_imputation_at=args.stop_imputation_at,
            stop_recguidance_at=args.stop_recguidance_at,
            replacement_distribution=args.replacement_distribution,
            diffusion_steps=args.diffusion_steps,
        )

    pipe = SamplePipeline(model_apply_fn(model), sched, dcfg,
                          SamplerConfig(method="ddim" if args.use_ddim else "ddpm"), device=dev)

    all_motions = []
    for rep in range(args.num_repetitions):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 100 * rep)
        all_motions.append(pipe.sample(
            (B, n_frames, F), y,
            guidance_param=args.guidance_param,
            obs_x0=obs_x0, obs_mask=obs_mask,
            inpaint=inpaint, generator=gen,
        ))
    joints = [pipe.sample_to_joints(m, ds.denormalize, args.abs_3d).cpu().numpy()
              for m in all_motions]

    out_dir = Path(args.output_dir or "save/conditional_out")
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(
        out_dir / "results.npy",
        {
            "motion": np.concatenate([m.cpu().numpy() for m in all_motions], axis=0),
            "joints": np.concatenate(joints, axis=0),
            "text": batch["text"] * args.num_repetitions,
            "lengths": np.tile(batch["lengths"], args.num_repetitions),
            "observed_motion": obs_x0.cpu().numpy(),
            "observed_mask": obs_mask.cpu().numpy(),
            "edit_mode": args.edit_mode,
            "text_encoder": encoder_name(encoder),
        },
    )
    print(f"saved {out_dir/'results.npy'}")
    return out_dir


if __name__ == "__main__":
    main()
