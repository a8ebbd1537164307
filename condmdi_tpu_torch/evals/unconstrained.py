"""Unconstrained-generation metrics: KID (polynomial MMD) + improved
precision/recall (reference eval/unconstrained/metrics/{kid.py,
precision_recall.py}, eval/unconstrained/evaluate.py:21).

A numpy copy of condmdi_tpu/evals/unconstrained.py, bit-exact: the same math
on the host (the degree-3 polynomial kernel inlined), over any feature
extractor's features (evals.run_unconstrained uses ST-GCN's).
"""

from __future__ import annotations

import numpy as np


def _polynomial_kernel(X, Y=None, degree=3, gamma=None, coef0=1.0):
    Y = X if Y is None else Y
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return (gamma * (X @ Y.T) + coef0) ** degree


def _mmd2_unbiased(K_XX, K_XY, K_YY):
    m = K_XX.shape[0]
    n = K_YY.shape[0]
    sum_XX = (K_XX.sum() - np.trace(K_XX)) / (m * (m - 1))
    sum_YY = (K_YY.sum() - np.trace(K_YY)) / (n * (n - 1))
    sum_XY = K_XY.mean()
    return sum_XX + sum_YY - 2 * sum_XY


def polynomial_mmd(codes_g, codes_r, degree=3, gamma=None, coef0=1.0):
    K_XX = _polynomial_kernel(codes_g, degree=degree, gamma=gamma, coef0=coef0)
    K_YY = _polynomial_kernel(codes_r, degree=degree, gamma=gamma, coef0=coef0)
    K_XY = _polynomial_kernel(codes_g, codes_r, degree=degree, gamma=gamma, coef0=coef0)
    return _mmd2_unbiased(K_XX, K_XY, K_YY)


def calculate_kid(codes_g, codes_r, n_subsets=50, subset_size=1000, rng=None):
    """KID = mean ± std of unbiased polynomial MMD² over random subsets."""
    rng = rng or np.random.default_rng(0)
    subset_size = min(subset_size, len(codes_g), len(codes_r))
    replace_g = subset_size < len(codes_g)
    replace_r = subset_size < len(codes_r)
    mmds = np.zeros(n_subsets)
    for i in range(n_subsets):
        g = codes_g[rng.choice(len(codes_g), subset_size, replace=replace_g)]
        r = codes_r[rng.choice(len(codes_r), subset_size, replace=replace_r)]
        mmds[i] = polynomial_mmd(g, r)
    return float(mmds.mean()), float(mmds.std())


def _manifold_estimate(A, B, k=3):
    """Fraction of B points inside the k-NN-ball manifold of A
    (reference precision_recall.py:30)."""
    # pairwise distances
    dAA = np.linalg.norm(A[:, None, :] - A[None, :, :], axis=-1)
    # k-th NN radius per A point (exclude self → k+1 smallest)
    radii = np.sort(dAA, axis=1)[:, k]
    dAB = np.linalg.norm(A[:, None, :] - B[None, :, :], axis=-1)  # [|A|, |B|]
    covered = (dAB <= radii[:, None]).any(axis=0)
    return float(covered.mean())


def precision_and_recall(generated_features, real_features, k=3):
    """Improved precision/recall (Kynkäänniemi et al.; reference :12)."""
    precision = _manifold_estimate(real_features, generated_features, k)
    recall = _manifold_estimate(generated_features, real_features, k)
    return precision, recall


def evaluate_unconstrained(gen_features, gt_features, n_subsets=20, subset_size=64, rng=None) -> dict:
    """Bundle: FID + KID + precision/recall + diversity (reference
    unconstrained/evaluate.py:21)."""
    from condmdi_tpu_torch.evals import metrics as M

    mu_g, cov_g = M.calculate_activation_statistics(gen_features)
    mu_r, cov_r = M.calculate_activation_statistics(gt_features)
    fid = M.calculate_frechet_distance(mu_r, cov_r, mu_g, cov_g)
    kid_mean, kid_std = calculate_kid(
        gen_features, gt_features, n_subsets=n_subsets, subset_size=subset_size, rng=rng
    )
    precision, recall = precision_and_recall(gen_features, gt_features)
    dt = min(30, len(gen_features) - 1)
    diversity = M.calculate_diversity(gen_features, dt, rng=rng)
    return dict(
        fid=fid, kid=kid_mean, kid_std=kid_std,
        precision=precision, recall=recall, diversity=float(diversity),
    )
