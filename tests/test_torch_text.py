"""The port's text encoders (condmdi_tpu_torch/models/text.py) against the JAX
package's numpy module: the same embeddings bit for bit, the same modes, and
the CLIP modes refused until the CLIP tower is ported."""

import numpy as np
import pytest

from condmdi_tpu.models import text as jax_text
from condmdi_tpu_torch.models import text

CAPTIONS = ["a person walks forward", "someone jumps", "", "a person walks forward"]


def _write_npz(path, captions):
    emb = np.random.default_rng(0).standard_normal((len(captions), 512)).astype(np.float32)
    np.savez(path, captions=np.asarray(captions, dtype=object), embeddings=emb)
    return emb


def test_hash_encoder_equals_jax():
    got = text.HashTextEncoder().encode(CAPTIONS)
    want = jax_text.HashTextEncoder().encode(CAPTIONS)
    assert got.shape == (4, 512) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_cached_encoder_equals_jax_with_fallback(tmp_path):
    p = tmp_path / "emb.npz"
    _write_npz(p, ["known caption", "someone jumps"])
    ours, theirs = text.CachedTextEncoder.from_npz(str(p)), jax_text.CachedTextEncoder.from_npz(str(p))
    asked = ["someone jumps", "unknown one", "known caption", "unknown two"]
    with pytest.warns(UserWarning, match="not in"):
        got = ours.encode(asked)
    with pytest.warns(UserWarning, match="not in"):
        want = theirs.encode(asked)
    np.testing.assert_array_equal(got, want)


def test_modes(tmp_path, monkeypatch):
    monkeypatch.delenv("CONDMDI_CLIP_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)  # no save/clip/ViT-B-32.pt here
    assert isinstance(text.make_text_encoder(mode="hash"), text.HashTextEncoder)
    with pytest.warns(UserWarning, match="HashTextEncoder"):
        assert isinstance(text.make_text_encoder(mode="auto"), text.HashTextEncoder)
    p = tmp_path / "emb.npz"
    _write_npz(p, ["x"])
    for mode in ("auto", "cached"):
        enc = text.make_text_encoder(mode=mode, embeddings_path=str(p))
        assert isinstance(enc, text.CachedTextEncoder)
        np.testing.assert_array_equal(enc.encode(["x"]), np.load(p, allow_pickle=True)["embeddings"])
    with pytest.raises(ValueError, match="text_embeddings"):
        text.make_text_encoder(mode="cached")
    with pytest.raises(ValueError, match="unknown"):
        text.make_text_encoder(mode="glove")


def test_clip_modes_raise_until_the_tower_is_ported(tmp_path, monkeypatch):
    """The tower is ported now (tests/test_torch_clip.py): mode clip still raises
    without a checkpoint, as JAX's does; with one found, clip and auto build
    ClipTextEncoder, as JAX's do, where they raised before the port."""
    import torch
    from test_torch_clip import fake_clip_state_dict, write_merges

    from condmdi_tpu_torch.models.clip import ClipTextEncoder

    monkeypatch.delenv("CONDMDI_CLIP_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="CLIP"):
        text.make_text_encoder(mode="clip")
    ckpt = tmp_path / "save" / "clip" / "ViT-B-32.pt"
    ckpt.parent.mkdir(parents=True)
    torch.save(fake_clip_state_dict(layers=1), ckpt)
    monkeypatch.setenv("CONDMDI_CLIP_BPE", write_merges(tmp_path / "merges.txt.gz"))
    assert text.find_clip_checkpoint() == "save/clip/ViT-B-32.pt"
    for mode in ("clip", "auto"):  # JAX loads CLIP here, and so does the port
        enc = text.make_text_encoder(mode=mode, device="cpu")
        assert isinstance(enc, ClipTextEncoder) and text.encoder_name(enc) == "clip"
