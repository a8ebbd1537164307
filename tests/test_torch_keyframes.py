"""The port's keyframe masks (condmdi_tpu_torch/training/keyframes.py) against the
JAX package's, on the CPU.

The eight deterministic edit modes must equal JAX's masks exactly, for each
feature mode and over ragged lengths. The four random modes draw from a
torch.Generator instead of jax.random, so they are held to JAX's sampling
semantics over many seeds instead: exactly min(k, length) distinct keyframes,
nothing at or past `length`, the root on every keyframe in random_joints,
and every keyframe of `random` observing between 1 and F-1 features (the
forced-feature adjustment).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.training import keyframes as jkf
from condmdi_tpu_torch.data import layout as L
from condmdi_tpu_torch.training import keyframes as tkf

T = 60
LENGTHS = [60, 41, 7, 1, 0, 33]  # ragged, including an empty item
DETERMINISTIC = ("benchmark_sparse", "benchmark_clip", "uncond", "right_wrist", "lower_body",
                 "pelvis_feet", "pelvis_vr", "pelvis")
RANDOM = ("gmd_keyframes", "random_frames", "random_joints", "random")


def _jax_mask(mode, lengths, feature_mode, trans_length=10, n_keyframes=5):
    return np.asarray(jkf.get_keyframes_mask(
        jax.random.key(0), jnp.asarray(lengths, jnp.int32), T, edit_mode=mode,
        trans_length=trans_length, feature_mode=feature_mode, n_keyframes=n_keyframes))


def _port_mask(mode, lengths, feature_mode="pos_rot_vel", trans_length=10, n_keyframes=5,
               seed=0):
    return tkf.get_keyframes_mask(
        torch.tensor(lengths), T, edit_mode=mode, trans_length=trans_length,
        feature_mode=feature_mode, n_keyframes=n_keyframes,
        generator=torch.Generator().manual_seed(seed)).numpy()


def test_edit_modes_are_the_jax_packages():
    assert tkf.HML_EDIT_MODES == jkf.HML_EDIT_MODES
    assert set(tkf.HML_EDIT_MODES) == set(DETERMINISTIC + RANDOM)


@pytest.mark.parametrize("feature_mode", ["pos", "pos_rot", "pos_rot_vel"])
@pytest.mark.parametrize("mode", DETERMINISTIC)
def test_deterministic_modes_equal_jax(mode, feature_mode):
    got = _port_mask(mode, LENGTHS, feature_mode)
    want = _jax_mask(mode, LENGTHS, feature_mode)
    assert got.dtype == np.bool_ and got.shape == (len(LENGTHS), T, 263)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trans_length", [1, 7, 30, 59])
@pytest.mark.parametrize("mode", ["benchmark_sparse", "benchmark_clip"])
def test_transition_lengths_equal_jax(mode, trans_length):
    np.testing.assert_array_equal(
        _port_mask(mode, LENGTHS, trans_length=trans_length),
        _jax_mask(mode, LENGTHS, "pos_rot_vel", trans_length=trans_length))


@pytest.mark.parametrize("feature_mode", ["pos", "pos_rot", "pos_rot_vel"])
def test_joint_to_full_mask_equals_jax(feature_mode):
    jm = np.random.default_rng(3).random((4, T, 22)) < 0.3
    np.testing.assert_array_equal(
        tkf.joint_to_full_mask(torch.from_numpy(jm), feature_mode).numpy(),
        np.asarray(jkf.joint_to_full_mask(jnp.asarray(jm), feature_mode)))


def _frames(mask):
    return mask.any(axis=-1)  # [B, T]


SEEDS = range(25)


@pytest.mark.parametrize("mode,k", [("gmd_keyframes", 5), ("gmd_keyframes", 12),
                                    ("random_frames", 20)])
def test_fixed_count_modes_choose_exactly_min_k_length_frames(mode, k):
    for seed in SEEDS:
        m = _port_mask(mode, LENGTHS, n_keyframes=k, seed=seed)
        fm = _frames(m)
        for b, n in enumerate(LENGTHS):
            assert fm[b].sum() == min(k, n)
            assert not fm[b, n:].any()
        # every chosen frame observes all joints' features
        full = tkf.joint_to_full_mask(torch.ones(1, 1, 22, dtype=torch.bool)).numpy()[0, 0]
        assert (m[fm] == full).all()


def test_random_joints_semantics():
    seen_counts = set()
    for seed in SEEDS:
        m = _port_mask("random_joints", LENGTHS, seed=seed)
        fm = _frames(m)
        for b, n in enumerate(LENGTHS):
            assert not m[b, n:].any()
            assert (fm[b].sum() >= 1) == (n >= 1)
            assert fm[b].sum() <= max(n - 1, 1)  # num_kf ~ U[1, max(length, 2))
            # the root's position features (MAT_POS row 0) on every keyframe
            assert m[b][fm[b]][:, L.MAT_POS[0]].all()
            seen_counts.add(int(fm[b].sum()))
    assert len(seen_counts) > 5  # the keyframe count itself is drawn


def test_random_feature_mode_semantics():
    F = 263
    for seed in SEEDS:
        m = _port_mask("random", LENGTHS, seed=seed)
        fm = _frames(m)
        for b, n in enumerate(LENGTHS):
            assert not m[b, n:].any()
            per_frame = m[b].sum(axis=-1)
            # the forced adjustment: no keyframe is empty, none is full
            assert ((per_frame >= 1) & (per_frame <= F - 1))[fm[b]].all()
            assert fm[b].sum() <= max(n - 1, 1)


@pytest.mark.parametrize("mode", RANDOM)
def test_random_modes_follow_the_seed(mode):
    a, b = _port_mask(mode, LENGTHS, seed=1), _port_mask(mode, LENGTHS, seed=1)
    np.testing.assert_array_equal(a, b)
    assert any((_port_mask(mode, LENGTHS, seed=s) != a).any() for s in range(2, 6))
