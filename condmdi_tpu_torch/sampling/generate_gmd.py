"""GMD guided-generation CLI (reference sample/gmd/generate.py).

Counterpart of condmdi_tpu/sampling/generate_gmd.py. Guidance modes (applied
via the preset layer, sampling/templates.py):

  no / testing  — plain text-to-motion sampling
  trajectory    — single-stage: the abs-root MOTION model is sampled with
                  gradient guidance toward keyframe xz locations, while the
                  p2p-interpolated trajectory is imputed into the root
                  channels (reference generate.py:540,498)
  mdm_legacy    — single-stage relative-root model, trajectory imputation
                  only (reference generate.py:289; no gradient guidance, :564)
  kps           — two-stage: a 4-dim TRAJECTORY model is guided toward the
                  keyframes, then the motion model imputes its root channels
                  (reference generate.py:396+)
  sdf           — kps + circular-obstacle SDF avoidance loss
                  (reference generate.py:442, condition.py:581)

Usage:
  python -m condmdi_tpu_torch.sampling.generate_gmd --guidance_mode kps \
      --model_path save/motion/ckpt.npz --traj_model_path save/traj/ckpt.npz \
      --text_prompt "a person walks" --num_samples 2

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")` runs
on the CPU. With no checkpoint a model takes Flax's initialisation from
--seed (pass --unet_zero false, or a Flax-initialised UNet outputs exactly
0). Without --traj_model_path the trajectory model is built from the motion
model's options with traj_only set, as in the JAX CLI; a traj checkpoint's
args.json (beside it) gives its own widths, CLI flags winning.

A guided run (trajectory, kps and sdf's first stage) takes the gradient
through the denoiser every step and runs eagerly; imputation without
guidance (mdm_legacy, kps and sdf's second stage) and plain sampling replay
the sampler step from CUDA graphs (sampling/pipeline.py). Outputs
results.npy {motion, joints, text, lengths, kframes, obstacles,
guidance_mode, pattern, text_encoder, random_init_model} (+ a trajectory
plot where matplotlib is available) in --output_dir.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.data.humanml_repr import recover_from_ric
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.models.factory import get_model_dims
    from condmdi_tpu_torch.models.text import encoder_name, make_text_encoder
    from condmdi_tpu_torch.sampling.gmd import (
        CondKeyLocations,
        get_kframes,
        get_obstacles,
        interpolate_kframes_trajectory,
        kframes_to_target,
        two_stage_generate,
    )
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline, build_inpainting_state
    from condmdi_tpu_torch.sampling.synthesize import (
        get_text_prompts,
        load_model_for_sampling,
        model_apply_fn,
    )
    from condmdi_tpu_torch.sampling.templates import get_template
    from condmdi_tpu_torch.utils.assets import load_norm_stats
    from condmdi_tpu_torch.utils.config import GMDGenerateArgs, parse_args, replace_args

    args = parse_args(GMDGenerateArgs, argv)
    args = get_template(args, args.guidance_mode)
    print(f"##### Guidance mode: {args.guidance_mode} #####")
    dev = resolve_device(device)

    n_frames = min(args.num_frames, int(args.motion_length * 20))
    texts = get_text_prompts(args)
    B = len(texts)
    mode = args.guidance_mode

    # keyframe pattern per mode (reference generate.py:258-271)
    if args.kframe_pattern:
        pattern = args.kframe_pattern
    elif mode == "sdf":
        pattern = "sdf_obstacle"
    elif mode == "kps":
        pattern = "zigzag"
    else:
        pattern = "square"
    kframes = get_kframes(pattern=pattern, interpolate=args.interpolate_cond)
    obstacles = get_obstacles() if mode == "sdf" else None

    model, sched, dcfg = load_model_for_sampling(args, dev)
    dims = get_model_dims(args)
    F = dims["njoints"] * dims["nfeats"]
    stats = load_norm_stats("abs3d" if args.abs_3d else "t2m")

    encoder = make_text_encoder(args, device=dev)
    y = {"text_embed": torch.from_numpy(encoder.encode(texts)).to(dev)}

    # gradient guidance requires the DDPM posterior loop (templates never
    # set use_ddim together with guidance; testing turns it off)
    sampler = SamplerConfig(method="ddim" if args.use_ddim else "ddpm")
    motion_pipe = SamplePipeline(model_apply_fn(model), sched, dcfg, sampler, device=dev)

    traj_pipe = None
    if args.gen_two_stages:
        # kps / sdf: trajectory model -> motion model (generate.py:396+)
        traj_args = replace_args(
            args, traj_only=True, model_path=args.traj_model_path, arch="unet"
        )
        traj_model, traj_sched, traj_dcfg = load_model_for_sampling(traj_args, dev)
        traj_pipe = SamplePipeline(model_apply_fn(traj_model), traj_sched, traj_dcfg,
                                   SamplerConfig(method="ddpm"), device=dev)

    all_motions, all_joints = [], []
    for rep in range(args.num_repetitions):
        gen = torch.Generator(device=dev).manual_seed(args.seed + rep)
        if args.gen_two_stages:
            _, sample = two_stage_generate(
                traj_pipe, motion_pipe, kframes, B, n_frames,
                traj_stats=stats, motion_stats=stats,
                y_traj=y, y_motion=y,
                classifier_scale=args.classifier_scale,
                obstacles=obstacles,
                use_mse_loss=args.gen_mse_loss,
                generator=gen,
            )
        else:
            cond_loss_fn, cond_scale = None, 1.0
            if mode == "trajectory":
                target, target_mask = kframes_to_target(kframes, B, n_frames, dev)
                guide = CondKeyLocations(
                    target, target_mask, stats, abs_3d=args.abs_3d,
                    use_mse_loss=args.gen_mse_loss,
                    motion_length_cut=args.motion_length_cut,
                )
                cond_loss_fn, cond_scale = guide.loss_fn, args.classifier_scale

            inpaint = None
            if args.do_inpaint and mode in ("trajectory", "mdm_legacy"):
                traj_xz = interpolate_kframes_trajectory(kframes, n_frames)
                denorm = np.zeros((B, n_frames, F), np.float32)
                if args.abs_3d:
                    # abs-root rep: channels 1:3 ARE xz world positions —
                    # impute the p2p trajectory directly
                    # (generate.py:498 inpaint_motion_points)
                    denorm[..., 1:3] = traj_xz[None]
                    ch = slice(1, 3)
                else:
                    # mdm_legacy (relative rep): channels 0:3 are root
                    # rot-velocity + LOCAL xz linear velocity. Prompt-driven
                    # generation has no GT motion to take them from, so the
                    # p2p trajectory is encoded as root velocities under an
                    # identity-heading approximation (rot_vel=0, world≈local
                    # frame), as the JAX CLI does.
                    vel = np.diff(traj_xz, axis=0, append=traj_xz[-1:])
                    denorm[..., 0] = 0.0
                    denorm[..., 1:3] = vel[None]
                    ch = slice(0, 3)
                motion_norm = (denorm - stats.mean[:F]) / stats.std[:F]
                m = torch.zeros((B, n_frames, F), dtype=torch.bool, device=dev)
                m[..., ch] = True
                inpaint = build_inpainting_state(
                    torch.from_numpy(motion_norm).to(dev), m,
                    imputate=True,
                    stop_imputation_at=args.stop_imputation_at,
                    diffusion_steps=args.diffusion_steps,
                )
            sample = motion_pipe.sample(
                (B, n_frames, F), y,
                guidance_param=args.guidance_param,
                inpaint=inpaint, generator=gen,
                cond_loss_fn=cond_loss_fn, cond_scale=cond_scale,
            )
        all_motions.append(sample.cpu().numpy())
        if F >= 263:
            std = torch.as_tensor(stats.std[:F], device=dev)
            mean = torch.as_tensor(stats.mean[:F], device=dev)
            all_joints.append(
                recover_from_ric(sample * std + mean, 22, abs_3d=args.abs_3d).cpu().numpy())

    out_dir = Path(args.output_dir or "save/gmd_out")
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(
        out_dir / "results.npy",
        {
            "motion": np.concatenate(all_motions, axis=0),
            "joints": np.concatenate(all_joints, axis=0) if all_joints else None,
            "text": texts * args.num_repetitions,
            "lengths": np.full((B * args.num_repetitions,), n_frames),
            "kframes": kframes,
            "obstacles": obstacles,
            "guidance_mode": mode,
            "pattern": pattern,
            "text_encoder": encoder_name(encoder),
            "random_init_model": not args.model_path,
        },
    )
    print(f"saved {out_dir/'results.npy'}")
    try:
        from condmdi_tpu_torch.viz.plot import plot_trajectory_with_kframes

        plot_trajectory_with_kframes(
            all_joints[0][0] if all_joints else None,
            kframes, obstacles, out_dir / "trajectory.png",
        )
    except Exception as e:  # viz is best-effort (matplotlib may be absent)
        print(f"viz skipped: {e}")
    return out_dir


if __name__ == "__main__":
    main()
