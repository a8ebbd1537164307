"""The port's host-side evaluation pieces against the JAX package's, on the CPU.

Tolerances: exact. The metrics, the word vectorizer, `compute_kps_error`
and the evaluator's npz format are numpy in both packages with the same calls
in the same order, so the same arrays give the same bits (assert_array_equal,
including the global np.random draws of diversity and multimodality); the
parameter fingerprint gives the same hex as JAX's for the same tree (a
Flax-initialised tree, bf16 and int leaves, and the committed gate npz, whose
recorded hex is 0d69067e95b7d9da).
"""

import numpy as np
import pytest
import torch

from condmdi_tpu.evals import harness as jh
from condmdi_tpu.evals import metrics as jm
from condmdi_tpu_torch.evals import harness as th
from condmdi_tpu_torch.evals import metrics as tm

from torch_cli_helpers import REPO
from torch_eval_helpers import few_torch_threads  # noqa: F401  (autouse)

GATE_NPZ = REPO / "save" / "synthetic_unet_m" / "gate_ema_000100000.npz"


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(name, *args, **kw):
    """(JAX's result, the port's) of metrics function `name`."""
    return getattr(jm, name)(*args, **kw), getattr(tm, name)(*args, **kw)


@pytest.mark.parametrize("sum_all", [False, True])
def test_distance_r_precision_and_matching_are_the_same_bits(sum_all):
    a = _rng(0).standard_normal((40, 16)).astype(np.float32)
    b = (a + 0.5 * _rng(1).standard_normal((40, 16))).astype(np.float32)
    for want, got in (_pair("euclidean_distance_matrix", a, b),
                      _pair("calculate_R_precision", a, b, 3, sum_all=sum_all),
                      _pair("calculate_matching_score", a, b, sum_all=sum_all),
                      _pair("calculate_top_k", np.argsort(a @ b.T, axis=1), 5)):
        np.testing.assert_array_equal(got, want)


def test_activation_statistics_and_frechet_distance_are_the_same_bits():
    x = _rng(2).standard_normal((64, 12))
    y = _rng(3).standard_normal((64, 12)) + 0.3
    (mu_j, cov_j), (mu_t, cov_t) = _pair("calculate_activation_statistics", x)
    np.testing.assert_array_equal(mu_t, mu_j)
    np.testing.assert_array_equal(cov_t, cov_j)
    mu2, cov2 = jm.calculate_activation_statistics(y)
    want, got = _pair("calculate_frechet_distance", mu_j, cov_j, mu2, cov2)
    assert got == want and np.isfinite(got)
    # a singular covariance (fewer samples than dimensions, as at 32 samples in 512)
    z = _rng(4).standard_normal((8, 12))
    mu3, cov3 = jm.calculate_activation_statistics(z)
    want, got = _pair("calculate_frechet_distance", mu_j, cov_j, mu3, cov3)
    assert got == want


@pytest.mark.parametrize("name,shape,times", [("calculate_diversity", (50, 8), 20),
                                              ("calculate_multimodality", (10, 6, 8), 4)])
def test_diversity_and_multimodality_draw_the_global_stream_as_jax(name, shape, times):
    act = _rng(5).standard_normal(shape)
    np.random.seed(123)
    want = getattr(jm, name)(act, times)
    after_jax = np.random.random()
    np.random.seed(123)
    got = getattr(tm, name)(act, times)
    assert got == want and np.random.random() == after_jax  # same draws, same count
    # and from an explicit generator
    assert getattr(tm, name)(act, times, rng=_rng(6)) == getattr(jm, name)(act, times, rng=_rng(6))


def test_keyframe_trajectory_skating_and_statistics_are_the_same_bits():
    err = np.abs(_rng(7).standard_normal((6, 9))).astype(np.float32) * 0.4
    nkf = np.array([9, 3, 1, 5, 9, 2], np.int32)
    for want, got in (_pair("calculate_keyframe_error", err, nkf),
                      _pair("calculate_trajectory_error", err, nkf),
                      _pair("calculate_trajectory_error", err, nkf, strict=False),
                      _pair("get_metric_statistics", err, 6)):
        np.testing.assert_array_equal(got, want)
    traj = _rng(8).standard_normal((3, 4, 20, 3))
    want, got = _pair("calculate_trajectory_diversity", traj, [20, 12, 7])
    assert got == want
    motions = _rng(9).standard_normal((4, 30, 22, 3)).astype(np.float32) * 0.05
    motions[..., 1] = np.abs(motions[..., 1])  # feet near the floor: contacts
    for layout, m in (("btj3", motions), ("ref", np.transpose(motions, (0, 2, 3, 1)))):
        (r_j, v_j), (r_t, v_t) = _pair("calculate_skating_ratio", m, layout=layout)
        np.testing.assert_array_equal(r_t, r_j)
        np.testing.assert_array_equal(v_t, v_j)
    assert r_j.max() > 0  # some skating counted


@pytest.mark.parametrize("traj_only", [True, False])
def test_compute_kps_error_is_the_same_bits(traj_only):
    rng = _rng(10)
    cur = rng.standard_normal((5, 24, 22, 3)).astype(np.float32)
    gt = rng.standard_normal((5, 24, 22, 3)).astype(np.float32)
    mask = rng.random((5, 24)) < 0.3
    mask[2] = False  # a row with no keyframe
    for max_kf in (196, 4):
        want = jh.compute_kps_error(cur, gt, mask, traj_only=traj_only, max_keyframes=max_kf)
        got = th.compute_kps_error(cur, gt, mask, traj_only=traj_only, max_keyframes=max_kf)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_word_vectorizer_and_token_embeddings_are_the_same_bits():
    from condmdi_tpu.data import word_vectorizer as jw
    from condmdi_tpu_torch.data import word_vectorizer as tw

    tokens = [["a/DET", "person/NOUN", "walks/VERB", "left/ADV", "slowly/ADV"],
              ["the/DET", "tall/ADJ", "figure/NOUN"] * 9,  # past max_text_len: truncated
              ["kick/VERB", "unknownword/X", "chair"]]
    for item in ("walk/VERB", "left/NOUN", "zebra", "chair/NOUN"):
        (wj, pj), (wt, pt) = jw.HashWordVectorizer()[item], tw.HashWordVectorizer()[item]
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(pt, pj)
    want = jw.tokens_to_embeddings(tokens, jw.HashWordVectorizer())
    got = tw.tokens_to_embeddings(tokens, tw.HashWordVectorizer())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tw.POS_enumerator == jw.POS_enumerator and tw.VIP_dict == jw.VIP_dict


def test_word_vectorizer_raises_without_its_glove_files_and_the_loader_falls_back(tmp_path):
    from condmdi_tpu_torch.data.word_vectorizer import HashWordVectorizer, WordVectorizer
    from condmdi_tpu_torch.evals.common import load_word_vectorizer

    with pytest.raises(FileNotFoundError):
        WordVectorizer(tmp_path / "glove")
    assert isinstance(load_word_vectorizer(), HashWordVectorizer)


def _flax_tree():
    """A Flax-initialised tree with nested modules, a conv, norms and a
    non-param collection (the shapes of a UNet block's, at small widths)."""
    import flax.linen as nn
    import jax

    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.Conv(8, (5,), name="conv")(x)
            h = nn.GroupNorm(num_groups=2, name="norm")(h)
            amax = self.variable("act_scale", "amax", lambda: jax.numpy.zeros(()))
            return nn.Dense(4, name="out")(h) + amax.value

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Block(name="block2")(Block(name="block1")(x))

    v = Net().init(jax.random.key(3), np.zeros((1, 6, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, v)


def test_params_fingerprint_equals_jax_on_a_flax_tree():
    import jax.numpy as jnp

    from condmdi_tpu.utils.checkpoint import params_fingerprint as jfp
    from condmdi_tpu_torch.utils.checkpoint import params_fingerprint as tfp

    tree = _flax_tree()  # params and the act_scale collection
    assert tfp(tree) == jfp(tree)
    # flat path-tuple keys and torch leaves hash as the nested numpy tree does
    flat = {("params", "a", "kernel"): np.arange(6, dtype=np.float32).reshape(2, 3),
            ("params", "b", "step"): np.arange(3, dtype=np.int64)}
    nested = {"params": {"a": {"kernel": flat[("params", "a", "kernel")]},
                         "b": {"step": flat[("params", "b", "step")]}}}
    assert tfp(flat) == tfp(nested) == jfp(nested)
    assert tfp({k: torch.from_numpy(v) for k, v in flat.items()}) == jfp(nested)
    # bf16 storage fingerprints as its float32 values do, in both
    bf = {"params": {"a": {"kernel": jnp.asarray(nested["params"]["a"]["kernel"], jnp.bfloat16)}}}
    t_bf = {("params", "a", "kernel"): torch.from_numpy(flat[("params", "a", "kernel")]).bfloat16()}
    assert tfp(t_bf) == jfp(bf)


def test_params_fingerprint_of_the_gate_npz_is_the_committed_hex():
    from condmdi_tpu_torch.utils.checkpoint import params_fingerprint
    from condmdi_tpu_torch.weights import read_params

    with np.load(GATE_NPZ) as z:
        recorded = str(z["__params_fingerprint__"])
    assert recorded == "0d69067e95b7d9da"
    assert params_fingerprint(read_params(GATE_NPZ)) == recorded


def test_seed_all_pins_numpy_python_and_torch_as_jax_pins_the_first_two():
    import random

    from condmdi_tpu.utils.seed import seed_all as jseed
    from condmdi_tpu_torch.utils.seed import seed_all as tseed

    jseed(7)
    want = (np.random.random(), random.random())
    tseed(7)
    got = (np.random.random(), random.random())
    a = torch.rand(3)
    tseed(7)
    assert got == want and (np.random.random(), random.random()) == want
    assert torch.equal(torch.rand(3), a)


def test_evaluator_npz_round_trip_and_init_match_jax(tmp_path):
    from condmdi_tpu.evals import train_evaluator as je
    from condmdi_tpu_torch.evals import train_evaluator as te

    want, got = je.init_params(_rng(12)), te.init_params(_rng(12))

    def leaves(tree, prefix=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], prefix + (k,))
            else:
                yield prefix + (k,), tree[k]

    assert [p for p, _ in leaves(got)] == [p for p, _ in leaves(want)]
    for (_, g), (_, w) in zip(leaves(got), leaves(want)):
        np.testing.assert_array_equal(g, w)
    je.save_params_npz(want, tmp_path / "jax.npz")
    te.save_params_npz(got, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k])
    committed = REPO / "save" / "evaluator_synth" / "evaluator.npz"
    for (_, g), (_, w) in zip(leaves(te.load_params_npz(committed)),
                              leaves(je.load_params_npz(committed))):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
