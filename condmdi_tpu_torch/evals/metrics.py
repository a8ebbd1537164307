"""Evaluation metrics (host-side numpy), a copy of condmdi_tpu/evals/metrics.py.

The port keeps its own copy so that it imports nothing of the JAX package; the
arithmetic is the same call for call, so the same arrays give the same bits
(tests/test_torch_eval_metrics.py). The diversity and multimodality draws come
from the global `np.random` unless an `rng` is passed, as in JAX.

Parity: reference data_loaders/humanml/utils/metrics.py — R-precision :24,
matching score :49, FID :97, diversity :75, multimodality :86, keyframe
error :151, trajectory error (20/50 cm) :157, trajectory diversity :186,
foot skating ratio :213 — and get_metric_statistics
(eval/eval_humanml_condmdi.py:208: mean ± 1.96σ/√n).

Layout notes: motions for the skating metric are [bs, T, 22, 3]
(features-last convention) — the reference's [bs, 22, 3, T] is accepted via
`motions_layout='ref'`.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg
from scipy.ndimage import uniform_filter1d


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    assert matrix1.shape[1] == matrix2.shape[1]
    d1 = -2 * np.dot(matrix1, matrix2.T)
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(argsorted: np.ndarray, top_k: int) -> np.ndarray:
    size = argsorted.shape[0]
    gt = np.arange(size)[:, None]
    bool_mat = argsorted == gt
    correct = np.zeros((size,), bool)
    cols = []
    for i in range(top_k):
        correct = correct | bool_mat[:, i]
        cols.append(correct[:, None].copy())
    return np.concatenate(cols, axis=1)


def calculate_R_precision(embedding1, embedding2, top_k, sum_all=False):
    dist = euclidean_distance_matrix(embedding1, embedding2)
    argmax = np.argsort(dist, axis=1)
    top_k_mat = calculate_top_k(argmax, top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(embedding1, embedding2, sum_all=False):
    dist = linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray):
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def calculate_diversity(activation, diversity_times, rng=None):
    assert activation.ndim == 2 and activation.shape[0] > diversity_times
    rng = rng or np.random
    n = activation.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return linalg.norm(activation[first] - activation[second], axis=1).mean()


def calculate_multimodality(activation, multimodality_times, rng=None):
    assert activation.ndim == 3 and activation.shape[1] > multimodality_times
    rng = rng or np.random
    n = activation.shape[1]
    first = rng.choice(n, multimodality_times, replace=False)
    second = rng.choice(n, multimodality_times, replace=False)
    return linalg.norm(activation[:, first] - activation[:, second], axis=2).mean()


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    def _sqrtm(a):
        res = linalg.sqrtm(a)  # scipy ≥1.17 returns just the matrix
        return res[0] if isinstance(res, tuple) else res

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def calculate_keyframe_error(keyframe_error: np.ndarray, num_keyframes: np.ndarray) -> float:
    """Mean over batch of per-sample mean error over its first k keyframes."""
    per = [keyframe_error[i, : num_keyframes[i]].mean() for i in range(len(keyframe_error))]
    return float(np.mean(per))


def calculate_trajectory_error(dist_error, num_keyframes, strict=True) -> np.ndarray:
    """[traj_fail@0.2, traj_fail@0.5, kps_fail@0.2, kps_fail@0.5, mean_err]."""
    bs = dist_error.shape[0]
    mean_err_traj = np.array(
        [dist_error[i, : num_keyframes[i]].mean() for i in range(bs)]
    )
    if strict:
        traj_fail_02 = 1.0 - (dist_error <= 0.2).all(axis=1).sum() / bs
        traj_fail_05 = 1.0 - (dist_error <= 0.5).all(axis=1).sum() / bs
    else:
        traj_fail_02 = (mean_err_traj > 0.2).sum() / bs
        traj_fail_05 = (mean_err_traj > 0.5).sum() / bs
    denom = (dist_error >= 0).sum()
    all_fail_02 = (dist_error > 0.2).sum() / denom
    all_fail_05 = (dist_error > 0.5).sum() / denom
    return np.array(
        [traj_fail_02, traj_fail_05, all_fail_02, all_fail_05, mean_err_traj.mean()]
    )


def calculate_trajectory_diversity(trajectories, lengths) -> float:
    """RMS distance of per-repetition trajectories to their mean (ref :186)."""
    divs = []
    for traj, length in zip(trajectories, lengths):
        t = traj[:, :length, :]
        mean_traj = t.mean(axis=0, keepdims=True)
        dist = np.sqrt(((t - mean_traj) ** 2).sum(axis=2))
        divs.append(np.sqrt((dist**2).mean()))
    return float(np.mean(divs))


def calculate_skating_ratio(motions: np.ndarray, layout: str = "btj3"):
    """Foot-skate ratio (ref :213): feet 10/11 below 5 cm with planar
    velocity > 0.5 m/s (5-frame smoothed), at 20 fps.

    motions: [bs, T, 22, 3] (layout='btj3') or [bs, 22, 3, T] ('ref').
    Returns (skating_ratio [bs], skate_vel [bs, 2, T-1]).
    """
    if layout == "btj3":
        motions = np.transpose(motions, (0, 2, 3, 1))  # → [bs, 22, 3, T]
    thresh_height, fps, thresh_vel, avg_window = 0.05, 20.0, 0.50, 5

    feet = motions[:, [10, 11], :, :]
    plane_vel = (
        np.linalg.norm(feet[:, :, [0, 2], 1:] - feet[:, :, [0, 2], :-1], axis=2) * fps
    )
    vel_avg = uniform_filter1d(plane_vel, axis=-1, size=avg_window, mode="constant", origin=0)

    height = feet[:, :, 1, :]
    contact = np.logical_and(height[:, :, :-1] < thresh_height, height[:, :, 1:] < thresh_height)
    skate_vel = contact * vel_avg

    skating = np.logical_and(contact, plane_vel > thresh_vel)
    skating = np.logical_and(skating, vel_avg > thresh_vel)
    skating = np.logical_or(skating[:, 0, :], skating[:, 1, :])
    return np.sum(skating, axis=1) / skating.shape[1], skate_vel


def get_metric_statistics(values: np.ndarray, replication_times: int):
    """mean ± 1.96σ/√n over replications (eval_humanml_condmdi.py:208)."""
    mean = np.mean(values, axis=0)
    std = np.std(values, axis=0)
    conf_interval = 1.96 * std / np.sqrt(replication_times)
    return mean, conf_interval
