"""GMD two-stage conditioned evaluation CLI (reference eval/eval_humanml_condition.py).

Counterpart of condmdi_tpu/evals/run_condition.py. Protocol: per
replication, for every test batch
  stage 1 — the TRAJECTORY model (4-dim rot/x/z/y features) is sampled with
            gradient guidance (CondKeyLocations) toward 5 GT pelvis-xz
            keyframes per sample;
  stage 2 — the MOTION model imputes the generated root channels
            (get_inpainting_motion_from_traj, reference condition.py:294);
then score matching / R-precision / FID / diversity / skating plus the
trajectory-error vector [traj_fail_20cm, traj_fail_50cm, kps_fail_20cm,
kps_fail_50cm, kps_mean_err] (reference eval_humanml_condition.py:36-87).

Usage:
  python -m condmdi_tpu_torch.evals.run_condition --model_path save/motion/ckpt.npz \
      --traj_model_path save/traj/ckpt.npz --eval_mode debug|wo_mm [--output_dir <dir>]

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")` runs
on the CPU. Empty model paths run random-init models (Flax's initialisation
from --seed; the report meta records it). The keyframe targets come from
numpy's `default_rng(seed + rep)` with JAX's calls in JAX's order, so the
same seed gives the same targets; each batch's sampler noise from
`torch.Generator(seed + rep*1000 + batch)`. Stage 1 runs eagerly (a gradient
through the trajectory model every step), stage 2 from CUDA graphs. The
report lands in --output_dir, else in torch_eval_out/<the checkpoint's
directory name> (common.output_dir), under the JAX report's file name;
--max_replications caps the replications, as in evals.run.
"""

from __future__ import annotations

import numpy as np
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

N_TARGET_KEYFRAMES = 5


def _gt_keyframe_targets(gt_joints, lengths, rng):
    """Per-sample targets: 5 random GT pelvis positions (xz observed)."""
    B, T = gt_joints.shape[:2]
    target = np.zeros((B, T, 22, 3), np.float32)
    mask = np.zeros((B, T, 22, 3), bool)
    for i in range(B):
        L = max(int(lengths[i]), N_TARGET_KEYFRAMES)
        idx = rng.choice(L, N_TARGET_KEYFRAMES, replace=False)
        target[i, idx, 0] = gt_joints[i, idx, 0]
        mask[i, idx, 0, 0] = True
        mask[i, idx, 0, 2] = True
    return target, mask


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.data.convert import abs3d_to_rel, rel_to_abs3d, sample_to_motion
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.evals import metrics as M
    from condmdi_tpu_torch.evals.harness import (
        EvalConfig,
        GeneratedBatch,
        compute_kps_error,
        evaluation,
    )
    from condmdi_tpu_torch.models.text import encoder_name, make_text_encoder
    from condmdi_tpu_torch.sampling.gmd import two_stage_generate
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling, model_apply_fn
    from condmdi_tpu_torch.utils.config import EvalArgs, parse_args, replace_args
    from condmdi_tpu_torch.utils.seed import seed_all

    args = parse_args(EvalArgs, argv)
    # reference parity: every eval entry pins the global RNGs (fixseed,
    # eval_humanml_condmdi.py:461) — the data layer's crop/text choice uses
    # the global numpy/python RNGs, so unseeded runs are not reproducible.
    seed_all(args.seed)

    args.keyframe_conditioned = False  # GMD models are not keyframe-concat models
    args.abs_3d = True  # GMD guidance operates on abs-root features
    mode = eval_mode(args)

    T = args.num_frames
    B = 32
    dev = resolve_device(device)

    motion_model, sched, dcfg = load_model_for_sampling(args, dev)
    traj_args = replace_args(
        args, traj_only=True, model_path=args.traj_model_path, arch="unet"
    )
    traj_model, traj_sched, traj_dcfg = load_model_for_sampling(traj_args, dev)

    sampler = SamplerConfig(method="ddpm")  # guidance needs the DDPM loop
    motion_pipe = SamplePipeline(model_apply_fn(motion_model), sched, dcfg, sampler, device=dev)
    traj_pipe = SamplePipeline(model_apply_fn(traj_model), traj_sched, traj_dcfg, sampler,
                               device=dev)

    enc = make_text_encoder(args, device=dev)
    ds_rel, ds_abs, gt_batches, synthetic_data = load_eval_datasets(args, T, B, enc, dev)

    cfg = EvalConfig(
        replication_times=mode["replication_times"],
        run_mm=False,  # reference protocol computes trajectory diversity instead
        max_frames=T,
        batch_size=B,
        keyframe_conditioned=False,
    )

    vec = load_word_vectorizer()
    evaluator, evaluator_source = load_evaluator(dev)
    abs_stats, rel_stats = ds_abs.stats, ds_rel.stats

    def generate_batch(batch, seed, np_rng):
        with torch.no_grad():
            motion_rel = torch.from_numpy(batch["motion"]).to(dev)
            motion_abs = rel_to_abs3d(motion_rel, rel_stats, abs_stats)
            gt_joints = sample_to_motion(motion_abs, abs_stats).cpu().numpy()
        target, target_mask = _gt_keyframe_targets(gt_joints, batch["lengths"], np_rng)
        y = {"text_embed": torch.from_numpy(batch["text_embed"]).to(dev)}
        _, sample = two_stage_generate(
            traj_pipe, motion_pipe, None, B, T,
            traj_stats=abs_stats, motion_stats=abs_stats,
            y_traj=y, y_motion=y,
            classifier_scale=args.classifier_scale,
            impute_until=1 if args.impute_until is None else args.impute_until,
            target=torch.from_numpy(target).to(dev),
            target_mask=torch.from_numpy(target_mask).to(dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
        )
        with torch.no_grad():
            cur_joints = sample_to_motion(sample, abs_stats).cpu().numpy()
            motions_rel = abs3d_to_rel(sample, abs_stats, rel_stats).cpu().numpy()
        kf_frames = target_mask.any(axis=(2, 3))
        dist_error, num_kf = compute_kps_error(cur_joints, gt_joints, kf_frames, traj_only=True)
        keyframe_error, _ = compute_kps_error(cur_joints, gt_joints, kf_frames, traj_only=False)
        skate_ratio, _ = M.calculate_skating_ratio(cur_joints)
        return GeneratedBatch(
            motions_rel=motions_rel,
            lengths=np.asarray(batch["lengths"]),
            captions=batch.get("text", [""] * B),
            tokens=batch.get("tokens", [[] for _ in range(B)]),
            dist_error=dist_error,
            keyframe_error=keyframe_error,
            num_keyframes=num_kf,
            skate_ratio=skate_ratio,
        )

    def generate_fn(rep):
        np_rng = np.random.default_rng(args.seed + rep)
        return [
            generate_batch(b, args.seed + rep * 1000 + i, np_rng)
            for i, b in enumerate(gt_batches)
        ]

    out_dir = output_dir(args)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_file = out_dir / f"eval_condition_{args.eval_mode}.json"
    summary = evaluation(evaluator, gt_batches, generate_fn, cfg, vec, str(log_file))
    print_summary(summary)

    write_report_meta(log_file, {
        "protocol": "eval_humanml_condition (GMD two-stage)",
        "synthetic_data": synthetic_data,
        "evaluator": evaluator_source,
        "text_encoder": encoder_name(enc),
        "eval_mode": args.eval_mode,
        "classifier_scale": args.classifier_scale,
        "replications": mode["replication_times"],
        "model_path": args.model_path,
        "traj_model_path": args.traj_model_path,
        "random_init_models": not (args.model_path and args.traj_model_path),
    }, dev)
    return summary


if __name__ == "__main__":
    main()
