"""The port's T2M evaluator and abs↔rel converters against the JAX package's, on the CPU.

Tolerances, each measured on these inputs:
  * the evaluator (committed save/evaluator_synth/evaluator.npz, random_init(0),
    and a reference-format torch checkpoint the test writes): co-embeddings and
    motion embeddings within EMB_ATOL = 1e-4 (measured <= 2e-6; float32 GRUs over
    up to 16 motion steps and 22 text steps, the input projection computed for all
    steps at once in the port and per step in JAX), and the same permutation: the
    lengths tie, and both packages order them with the same np.argsort call;
  * the converters (joints_to_rel_features, joints_to_abs_features, abs3d_to_rel,
    rel_to_abs3d, sample_to_motion, relative_to_global, global_to_relative) within
    CONVERT_ATOL = 1e-4 on normalized features and joints (measured <= 3e-5: the
    two float32 codecs are 2e-5 apart).
"""

import numpy as np
import pytest
import torch

from torch_cli_helpers import REPO
from torch_eval_helpers import few_torch_threads  # noqa: F401  (autouse)

EMB_ATOL = 1e-4
CONVERT_ATOL = 1e-4
B, T = 8, 64
LENGTHS = np.array([64, 48, 48, 32, 64, 16, 48, 32], np.int32)  # ties, as synthetic lengths


def _inputs(seed=0):
    from condmdi_tpu_torch.data.word_vectorizer import HashWordVectorizer, tokens_to_embeddings

    rng = np.random.default_rng(seed)
    motions = rng.standard_normal((B, T, 263)).astype(np.float32)
    for i, n in enumerate(LENGTHS):
        motions[i, n:] = 0
    words = ["a/DET", "person/NOUN", "walks/VERB", "slowly/ADV", "left/ADV", "tall/ADJ"]
    tokens = [[words[j] for j in rng.integers(0, len(words), size=3 + i)] for i in range(B)]
    word, pos, cap_lens = tokens_to_embeddings(tokens, HashWordVectorizer())
    return word, pos, cap_lens, motions, LENGTHS


def _both(source):
    from condmdi_tpu.evals import evaluator as je
    from condmdi_tpu.evals.train_evaluator import load_params_npz
    from condmdi_tpu_torch.evals import evaluator as te

    if source == "committed":
        params = load_params_npz(REPO / "save" / "evaluator_synth" / "evaluator.npz")
        return je.EvaluatorWrapper(params), te.EvaluatorWrapper(params, device="cpu")
    return je.EvaluatorWrapper.random_init(0), te.EvaluatorWrapper.random_init(0, device="cpu")


@pytest.mark.parametrize("source", ["committed", "random_init"])
def test_co_embeddings_and_motion_embeddings_match_jax(source):
    jw, tw = _both(source)
    word, pos, cap_lens, motions, m_lens = _inputs()
    want_t, want_m = jw.get_co_embeddings(word, pos, cap_lens, motions, m_lens)
    got_t, got_m = tw.get_co_embeddings(word, pos, cap_lens, motions, m_lens)
    for got, want in ((got_t, want_t), (got_m, want_m)):
        assert got.shape == want.shape == (B, 512) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(tw.get_motion_embeddings(motions, m_lens),
                               jw.get_motion_embeddings(motions, m_lens), rtol=0, atol=EMB_ATOL)
    assert np.abs(want_m).max() > 1e-2 and np.abs(want_t).max() > 1e-2


def test_the_sort_by_length_quirk_is_kept():
    """Motion embeddings come back in length-sorted order, text embeddings
    re-indexed by that order (reference evaluator_wrapper.py:160-171)."""
    from condmdi_tpu_torch.evals import evaluator as te

    tw = te.EvaluatorWrapper.random_init(0, device="cpu")
    word, pos, cap_lens, motions, m_lens = _inputs(1)
    text_emb, motion_emb = tw.get_co_embeddings(word, pos, cap_lens, motions, m_lens)
    order = np.argsort(m_lens)[::-1]
    for row, i in enumerate(order):  # each row of the output against one item alone
        one_t, one_m = tw.get_co_embeddings(word[i:i + 1], pos[i:i + 1], cap_lens[i:i + 1],
                                            motions[i:i + 1], m_lens[i:i + 1])
        np.testing.assert_allclose(motion_emb[row], one_m[0], rtol=0, atol=EMB_ATOL)
        np.testing.assert_allclose(text_emb[row], one_t[0], rtol=0, atol=EMB_ATOL)


def test_gru_reads_only_the_valid_prefix():
    """Values past what a sample's valid steps read change nothing (packed-sequence
    semantics): the two k4 s2 p1 convs reach 2 frames past the length."""
    from condmdi_tpu_torch.evals import evaluator as te

    tw = te.EvaluatorWrapper.random_init(0, device="cpu")
    word, pos, cap_lens, motions, m_lens = _inputs(2)
    noisy = motions.copy()
    for i, n in enumerate(m_lens):
        noisy[i, n + 3:] = 100.0
    np.testing.assert_allclose(tw.get_motion_embeddings(noisy, m_lens),
                               tw.get_motion_embeddings(motions, m_lens), rtol=0, atol=EMB_ATOL)


def _reference_checkpoint(params, path):
    """A `text_mot_match/model/finest.tar` in the reference's state-dict format."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def dense(p, pre):
        return {f"{pre}.weight": t(p["kernel"].T), f"{pre}.bias": t(p["bias"])}

    def bigru(p):
        sd = {**dense(p["input_emb"], "input_emb"), **dense(p["out1"], "output_net.0"),
              **dense(p["out2"], "output_net.3"),
              "output_net.1.weight": t(p["ln"]["scale"]), "output_net.1.bias": t(p["ln"]["bias"]),
              "hidden": t(p["h0"][:, None, :])}
        for d, suffix in (("gru_f", ""), ("gru_b", "_reverse")):
            for leaf, name in (("wi", "weight_ih_l0"), ("wh", "weight_hh_l0"),
                               ("bi", "bias_ih_l0"), ("bh", "bias_hh_l0")):
                sd[f"gru.{name}{suffix}"] = t(p[d][leaf])
        return sd

    mov = params["movement"]
    blob = {
        "movement_encoder": {
            "main.0.weight": t(mov["conv1"]["kernel"].transpose(2, 1, 0)),
            "main.0.bias": t(mov["conv1"]["bias"]),
            "main.3.weight": t(mov["conv2"]["kernel"].transpose(2, 1, 0)),
            "main.3.bias": t(mov["conv2"]["bias"]),
            **dense(mov["out"], "out_net"),
        },
        "motion_encoder": bigru(params["motion"]),
        "text_encoder": {**bigru(params["text"]), **dense(params["text"]["pos_emb"], "pos_emb")},
    }
    torch.save(blob, path)


def test_from_torch_checkpoint_matches_jax(tmp_path):
    from condmdi_tpu.evals import evaluator as je
    from condmdi_tpu_torch.evals import evaluator as te
    from condmdi_tpu_torch.evals.train_evaluator import init_params

    _reference_checkpoint(init_params(np.random.default_rng(4)), tmp_path / "finest.tar")
    jw = je.EvaluatorWrapper.from_torch_checkpoint(str(tmp_path / "finest.tar"))
    tw = te.EvaluatorWrapper.from_torch_checkpoint(str(tmp_path / "finest.tar"), device="cpu")
    word, pos, cap_lens, motions, m_lens = _inputs(3)
    for got, want in zip(tw.get_co_embeddings(word, pos, cap_lens, motions, m_lens),
                         jw.get_co_embeddings(word, pos, cap_lens, motions, m_lens)):
        np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)


def test_evaluator_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    from condmdi_tpu_torch.evals.evaluator import EvaluatorWrapper

    with pytest.raises(RuntimeError, match="CUDA"):
        EvaluatorWrapper.random_init(0)


# --------------------------------------------------------------------------- #
# data/convert.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def motion_data():
    """Normalized rel and abs features of a few synthetic items, their joints, and
    the two NormStats (the port's synthetic set; both packages get these arrays)."""
    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset
    from condmdi_tpu_torch.data.humanml_repr import recover_from_ric

    rel = SyntheticMotionDataset(DatasetConfig(max_motion_length=40), size=3, seed=2,
                                 device="cpu")
    abs_ = SyntheticMotionDataset(DatasetConfig(max_motion_length=40, abs_3d=True), size=3,
                                  seed=2, device="cpu")
    feats_rel = np.stack([it["motion"][:40] for it in rel.items])
    feats_abs = np.stack([it["motion"][:40] for it in abs_.items])
    joints = recover_from_ric(torch.from_numpy(feats_rel), 22).numpy()
    return dict(rel=rel.normalize(feats_rel), abs=abs_.normalize(feats_abs), joints=joints,
                rel_stats=rel.stats, abs_stats=abs_.stats)


CONVERTERS = ["joints_to_rel_features", "joints_to_abs_features", "abs3d_to_rel", "rel_to_abs3d",
              "sample_to_motion", "relative_to_global", "global_to_relative"]


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_matches_jax(name, motion_data):
    from condmdi_tpu.data import convert as jc
    from condmdi_tpu_torch.data import convert as tc

    d = motion_data
    args = {
        "joints_to_rel_features": (d["joints"], d["rel_stats"]),
        "joints_to_abs_features": (d["joints"], d["abs_stats"]),
        "abs3d_to_rel": (d["abs"], d["abs_stats"], d["rel_stats"]),
        "rel_to_abs3d": (d["rel"], d["rel_stats"], d["abs_stats"]),
        "sample_to_motion": (d["abs"], d["abs_stats"]),
        "relative_to_global": (d["rel"],),
        "global_to_relative": (d["abs"],),
    }[name]
    want = np.asarray(getattr(jc, name)(*args))
    got = getattr(tc, name)(torch.from_numpy(args[0]), *args[1:])
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONVERT_ATOL)
    assert np.abs(want).max() > 0.1
