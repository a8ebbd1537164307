"""CondMDI evaluation harness (reference eval/eval_humanml_condmdi.py).

Counterpart of condmdi_tpu/evals/harness.py. Protocol parity (paper
harness, :443-505): batch 32 × 196 frames; per replication build a
generated-motion dataset by sampling the model over the test set with
keyframe conditioning, then compute
  matching score / R-precision (top-1/2/3)   (:20 evaluate_matching_score)
  FID                                        (:121)
  diversity (300)                            (:146)
  multimodality (optional)                   (:159)
  + trajectory error, keyframe error, skating ratio from the sampler pass
and aggregate mean ± 1.96σ/√n over replications (:208).

The generated-dataset stage (reference CompMDMGeneratedDatasetCondMDI,
comp_v6_model_dataset_condmdi.py:24) runs batched on the pipeline's device:
rel→abs GT conversion, mask building, sampling, joints, abs→rel
back-conversion; the samples and joints come to the host once per batch for
the numpy metrics. Noise: each batch's sampler draws from a torch.Generator
on the device seeded with the batch's integer seed (the JAX package keys
jax.random with the same integer, so the streams differ); the random edit
modes draw their masks from a CPU generator seeded with seed + 2**32. The JAX
package's data-parallel `mesh` option waits for parallel/ (ROADMAP Queue A 8).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from condmdi_tpu_torch.data.convert import abs3d_to_rel, rel_to_abs3d, sample_to_motion
from condmdi_tpu_torch.evals import metrics as M

MASK_SEED_OFFSET = 1 << 32  # the mask generator's seed, apart from the noise's


def compute_kps_error(
    cur_motion: np.ndarray,  # [B, T, 22, 3]
    gt_motion: np.ndarray,  # [B, T, 22, 3]
    keyframe_mask: np.ndarray,  # [B, T] bool
    traj_only: bool = True,
    max_keyframes: int = 196,
):
    """Keyframe position error (reference compute_kps_error_arbitrary,
    condition.py:130): per keyframe, joint-mean of the L2 error — xz root
    only (traj) or all joints (keyframe error). Returns (err [B, K], num_kf
    [B]) with zero padding. Numpy, the JAX package's arithmetic."""
    B, T = keyframe_mask.shape
    K = min(max_keyframes, T)
    if traj_only:
        a = cur_motion[:, :, 0:1, :][..., [0, 2]]
        b = gt_motion[:, :, 0:1, :][..., [0, 2]]
    else:
        a, b = cur_motion, gt_motion
    per_frame = np.linalg.norm(a - b, axis=-1).mean(axis=-1)  # [B, T]
    # a stable argsort on ~mask brings each row's keyframe indices to the
    # front in ascending frame order
    order = np.argsort(~keyframe_mask, axis=1, kind="stable")[:, :K]  # [B, K]
    num_kf = np.minimum(keyframe_mask.sum(axis=1), K).astype(np.int32)  # [B]
    gathered = np.take_along_axis(per_frame, order, axis=1)  # [B, K]
    slot_valid = np.arange(K)[None, :] < num_kf[:, None]
    errs = np.where(slot_valid, gathered, 0.0).astype(np.float32)
    return errs, num_kf


@dataclass
class EvalConfig:
    edit_mode: str = "benchmark_sparse"
    transition_length: int = 10
    editable_features: str = "pos_rot_vel"
    n_keyframes: int = 5
    guidance_param: float = 2.5
    replication_times: int = 20
    diversity_times: int = 300
    mm_num_times: int = 0
    run_mm: bool = False
    max_frames: int = 196
    batch_size: int = 32
    # False: legacy text-to-motion protocol (eval/eval_humanml.py) — no
    # keyframe observation is fed to the model
    keyframe_conditioned: bool = True
    # ablation: the model still runs in its conditioned form but with the
    # observation mask zeroed — keyframe metrics are still computed on the
    # edit-mode frames
    drop_observations: bool = False
    # report traj/keyframe error metrics
    report_keyframe_metrics: bool = True


@dataclass
class GeneratedBatch:
    motions_rel: np.ndarray  # [B, T, 263] normalized relative (T2M space)
    lengths: np.ndarray
    captions: list
    tokens: list
    dist_error: np.ndarray
    keyframe_error: np.ndarray
    num_keyframes: np.ndarray
    skate_ratio: np.ndarray


def generate_eval_batch(
    pipe,
    batch: dict,
    seed: int,
    cfg: EvalConfig,
    abs_stats,
    rel_stats,
    model_is_abs: bool = True,
    cache_path: Optional[str] = None,
) -> GeneratedBatch:
    """One test batch → generated motions + CondMDI metrics.

    `batch` carries RELATIVE-normalized GT motion (evaluator space) exactly
    like the reference 'eval' loader; the model consumes the abs variant.
    `seed` seeds the batch's sampler noise (and the random edit modes'
    masks). `cache_path`: optional .npz path caching the raw samples per
    (seed, batch, replication) — the reference's .pt sample cache
    (comp_v6_model_dataset_condmdi.py:382) for cheap harness re-runs.
    """
    from condmdi_tpu_torch.training.keyframes import get_keyframes_mask

    dev = pipe.device
    B, T, F = batch["motion"].shape
    lengths = torch.from_numpy(np.asarray(batch["lengths"])).to(dev)

    motion_rel = torch.from_numpy(np.asarray(batch["motion"])).to(dev)
    motion_abs = rel_to_abs3d(motion_rel, rel_stats, abs_stats) if model_is_abs else motion_rel

    if cfg.keyframe_conditioned:
        obs_mask = get_keyframes_mask(
            lengths, T,
            edit_mode=cfg.edit_mode,
            trans_length=cfg.transition_length,
            feature_mode=cfg.editable_features,
            n_keyframes=cfg.n_keyframes,
            generator=torch.Generator().manual_seed(seed + MASK_SEED_OFFSET),
        )
        obs_mask = obs_mask & torch.from_numpy(np.asarray(batch["time_mask"])).to(dev)[..., None]
    else:
        obs_mask = torch.zeros((B, T, F), dtype=torch.bool, device=dev)

    y = {"text_embed": torch.from_numpy(np.asarray(batch["text_embed"])).to(dev)}
    if cache_path is not None and os.path.exists(cache_path):
        with np.load(cache_path) as cached:
            sample = torch.from_numpy(cached["sample"]).to(dev)
            obs_mask = torch.from_numpy(cached["obs_mask"]).to(dev)
    else:
        model_mask = torch.zeros_like(obs_mask) if cfg.drop_observations else obs_mask
        obs_kw = (
            dict(obs_x0=motion_abs, obs_mask=model_mask)
            if cfg.keyframe_conditioned else {}
        )
        sample = pipe.sample(
            (B, T, F), y,
            guidance_param=cfg.guidance_param,
            generator=torch.Generator(device=dev).manual_seed(seed),
            **obs_kw,
        )
        if cache_path is not None:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.savez(cache_path, sample=sample.cpu().numpy(), obs_mask=obs_mask.cpu().numpy())

    with torch.no_grad():
        stats = abs_stats if model_is_abs else rel_stats
        cur_joints = sample_to_motion(sample, stats).cpu().numpy()
        if not np.isfinite(cur_joints).all():
            # fail HERE with the cause, not later inside scipy's matching-score norm
            raise FloatingPointError(
                "generated motions are non-finite — the sampling run diverged "
                "(int8 activation-scale clipping under CFG extrapolation, or an "
                "unstable guidance setting). See ops/quant.py "
                "calibrate_act_scales_trajectory."
            )
        gt_joints = (sample_to_motion(motion_abs, stats) if model_is_abs
                     else sample_to_motion(motion_rel, rel_stats)).cpu().numpy()
        motions_rel = (abs3d_to_rel(sample, abs_stats, rel_stats) if model_is_abs
                       else sample).cpu().numpy()

    kf_frames = obs_mask.any(dim=-1).cpu().numpy()
    dist_error, num_kf = compute_kps_error(cur_joints, gt_joints, kf_frames, traj_only=True)
    keyframe_error, _ = compute_kps_error(cur_joints, gt_joints, kf_frames, traj_only=False)
    skate_ratio, _ = M.calculate_skating_ratio(cur_joints)

    if not np.isfinite(motions_rel).all():
        # fail HERE with the cause: the joints were finite, so the abs->rel
        # conversion produced the non-finite values
        bad = np.where(~np.isfinite(motions_rel).all(axis=(1, 2)))[0]
        raise FloatingPointError(
            f"abs3d_to_rel produced non-finite rel features for batch rows "
            f"{bad.tolist()} — joints were finite, so this is a conversion "
            "regression (geometry guards: quaternion.qbetween, "
            "skeleton.inverse_kinematics eps normalizations)"
        )
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


# --------------------------------------------------------------------------- #
# Replication-level metric computation
# --------------------------------------------------------------------------- #
def evaluate_matching_score(evaluator, batches, word_vectorizer):
    """Matching score + R-precision over generated batches (ref :20-101)."""
    from condmdi_tpu_torch.data.word_vectorizer import tokens_to_embeddings

    match_sum, top_k_sum, n = 0.0, np.zeros(3), 0
    all_motion_emb = []
    traj_metrics, kf_errors, skate = [], [], []
    for gb in batches:
        word, pos, cap_lens = tokens_to_embeddings(gb.tokens, word_vectorizer)
        text_emb, motion_emb = evaluator.get_co_embeddings(
            word, pos, cap_lens, gb.motions_rel, gb.lengths
        )
        match_sum += M.calculate_matching_score(text_emb, motion_emb, sum_all=True)
        top_k_sum += M.calculate_R_precision(text_emb, motion_emb, 3, sum_all=True)
        n += len(text_emb)
        all_motion_emb.append(motion_emb)
        traj_metrics.append(
            M.calculate_trajectory_error(gb.dist_error, gb.num_keyframes)
        )
        kf_errors.append(M.calculate_keyframe_error(gb.keyframe_error, gb.num_keyframes))
        skate.append(gb.skate_ratio.mean())
    return dict(
        matching_score=match_sum / n,
        r_precision=top_k_sum / n,
        motion_embeddings=np.concatenate(all_motion_emb, axis=0),
        traj_error=np.mean(np.stack(traj_metrics), axis=0),
        keyframe_error=float(np.mean(kf_errors)),
        skating_ratio=float(np.mean(skate)),
    )


def evaluate_gt_embeddings(evaluator, gt_batches):
    embs = [
        evaluator.get_motion_embeddings(b["motion"], b["lengths"]) for b in gt_batches
    ]
    return np.concatenate(embs, axis=0)


def evaluation(
    evaluator,
    gt_batches,
    generate_fn: Callable[[int], list],
    cfg: EvalConfig,
    word_vectorizer,
    log_file: Optional[str] = None,
    generate_mm_fn: Optional[Callable[[int], list]] = None,
) -> dict:
    """Full replication loop (reference evaluation:215 → :332).

    generate_mm_fn(rep): when cfg.run_mm, returns the SAME batches sampled
    `mm_num_times` times (list of lists of GeneratedBatch) for the
    multimodality metric (reference :159-206).
    """
    gt_emb = evaluate_gt_embeddings(evaluator, gt_batches)
    gt_mu, gt_cov = M.calculate_activation_statistics(gt_emb)

    results = {
        "matching_score": [], "r_precision": [], "fid": [], "diversity": [],
        "skating_ratio": [],
    }
    # the legacy eval_humanml protocol reports no keyframe metrics
    # (reference :166-292)
    report_kf = cfg.report_keyframe_metrics
    if report_kf:
        results["traj_error"] = []
        results["keyframe_error"] = []
    if cfg.run_mm and generate_mm_fn is not None:
        results["multimodality"] = []
    for rep in range(cfg.replication_times):
        batches = generate_fn(rep)
        scores = evaluate_matching_score(evaluator, batches, word_vectorizer)
        mu, cov = M.calculate_activation_statistics(scores["motion_embeddings"])
        fid = M.calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
        div_times = min(cfg.diversity_times, len(scores["motion_embeddings"]) - 1)
        diversity = M.calculate_diversity(scores["motion_embeddings"], div_times)
        results["matching_score"].append(scores["matching_score"])
        results["r_precision"].append(scores["r_precision"])
        results["fid"].append(fid)
        results["diversity"].append(diversity)
        if report_kf:
            results["traj_error"].append(scores["traj_error"])
            results["keyframe_error"].append(scores["keyframe_error"])
        results["skating_ratio"].append(scores["skating_ratio"])
        if cfg.run_mm and generate_mm_fn is not None:
            reps_batches = generate_mm_fn(rep)  # [R] lists of batches
            per_rep_embs = []
            for rep_batches in reps_batches:
                embs = np.concatenate([
                    evaluator.get_motion_embeddings(gb.motions_rel, gb.lengths)
                    for gb in rep_batches
                ], axis=0)
                per_rep_embs.append(embs)
            mm_act = np.stack(per_rep_embs, axis=1)  # [N, R, D]
            mm_times = min(cfg.mm_num_times or mm_act.shape[1] - 1, mm_act.shape[1] - 1)
            results["multimodality"].append(
                M.calculate_multimodality(mm_act, max(mm_times, 1))
            )

    summary = OrderedDict()
    for key, vals in results.items():
        mean, ci = M.get_metric_statistics(np.asarray(vals), cfg.replication_times)
        summary[key] = dict(mean=np.asarray(mean).tolist(), conf=np.asarray(ci).tolist())
    if log_file:
        import json

        # per-replication raw values ride along so a report can be re-derived
        # one replication at a time
        blob = dict(summary)
        blob["per_replication"] = {
            k: np.asarray(v).tolist() for k, v in results.items()
        }
        with open(log_file, "w") as fh:
            json.dump(blob, fh, indent=2)
    return summary
