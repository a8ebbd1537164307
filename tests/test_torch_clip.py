"""The CLIP text tower on the port against the JAX package, on the CPU, as
tests/test_clip.py holds the JAX tower: width 32, random weights, a merges file
the test writes.

  * a residual block and the whole tower (EOT pooling, causal mask) with JAX's
    weights carried across, within 1e-5;
  * `convert_clip_text_state_dict` gives JAX's tree for an OpenAI-layout state dict;
  * `ClipTokenizer` gives JAX's ids, special tokens, truncation and the 22-token
    context included;
  * `ClipTextEncoder` (the 22-token context padded to 77) against JAX's tower on
    the same ids, and `make_text_encoder`'s clip and auto modes building it from a
    checkpoint.
"""

import gzip

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from condmdi_tpu.models import clip as jclip
from condmdi_tpu_torch.models import clip as tclip
from condmdi_tpu_torch.models import text
from condmdi_tpu_torch.weights import load_flax_params

TOL = 1e-5
SMALL = dict(vocab_size=600, context_length=77, width=32, layers=2, heads=8, embed_dim=24)
MERGES = ["t h", "th e</w>", "p e", "pe r", "per s", "pers o", "perso n</w>", "w a", "wa l",
          "wal k", "walk s</w>", "j u", "ju m", "jum p", "a </w>", "i n</w>", "o n</w>"]
CAPTIONS = ["a person walks forward", "The person jumps!! in place &amp; turns",
            "someone waves 2 hands", "a person walks in a circle and then sits down on the "
            "floor slowly while waving the left hand over the head"]


def write_merges(path):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: test\n" + "\n".join(MERGES) + "\n")
    return str(path)


def fake_clip_state_dict(width=32, layers=2, vocab=600, ctx=77, embed=24, seed=0):
    """An OpenAI-layout CLIP text state dict of random values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: 0.1 * torch.randn(s, generator=g)  # noqa: E731
    sd = {"token_embedding.weight": r(vocab, width), "positional_embedding": r(ctx, width),
          "text_projection": r(width, embed), "ln_final.weight": 1 + r(width),
          "ln_final.bias": r(width)}
    for i in range(layers):
        pre = f"transformer.resblocks.{i}"
        sd.update({
            f"{pre}.ln_1.weight": 1 + r(width), f"{pre}.ln_1.bias": r(width),
            f"{pre}.ln_2.weight": 1 + r(width), f"{pre}.ln_2.bias": r(width),
            f"{pre}.attn.in_proj_weight": r(3 * width, width),
            f"{pre}.attn.in_proj_bias": r(3 * width),
            f"{pre}.attn.out_proj.weight": r(width, width), f"{pre}.attn.out_proj.bias": r(width),
            f"{pre}.mlp.c_fc.weight": r(4 * width, width), f"{pre}.mlp.c_fc.bias": r(4 * width),
            f"{pre}.mlp.c_proj.weight": r(width, 4 * width), f"{pre}.mlp.c_proj.bias": r(width),
        })
    return sd


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL * (1 + np.abs(want).max()), rtol=0)


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def test_converter_gives_jax_s_tree():
    sd = fake_clip_state_dict()
    _tree_equal(tclip.convert_clip_text_state_dict(sd), jclip.convert_clip_text_state_dict(sd))


def test_block_and_tower_match_jax():
    params = jclip.convert_clip_text_state_dict(fake_clip_state_dict())
    x = np.random.default_rng(0).standard_normal((2, 10, 32)).astype(np.float32)
    want = jclip.ClipResidualBlock(32, 4).apply({"params": params["params"]["block0"]},
                                                jnp.asarray(x))
    block = tclip.ClipResidualBlock(32, 4, device="cpu")
    block.load_state_dict(load_flax_params({"params": params["params"]["block0"]}))
    with torch.no_grad():
        _close(block(torch.from_numpy(x)).numpy(), want)

    ids = np.zeros((3, 77), np.int32)
    ids[0, :4] = [590, 5, 6, 599]  # EOT (the highest id) at position 3
    ids[1, :3] = [590, 7, 599]
    ids[2, :6] = [590, 11, 12, 13, 14, 599]
    want = jclip.ClipTextModel(**SMALL).apply(params, jnp.asarray(ids))
    tower = tclip.ClipTextModel(**SMALL, device="cpu")
    tower.load_state_dict(load_flax_params(params))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids))
        ids2 = ids.copy()
        ids2[0, 10] = 55  # after the EOT: the causal mask and the EOT pooling ignore it
        assert torch.equal(tower(torch.from_numpy(ids2))[0], got[0])
    assert got.shape == (3, 24)
    _close(got.numpy(), want)
    assert np.allclose(tclip.quick_gelu(torch.tensor([0.5])).numpy(),
                       np.asarray(jclip.quick_gelu(jnp.asarray([0.5]))), atol=1e-7)


def test_tokenizer_gives_jax_s_ids(tmp_path, monkeypatch):
    path = write_merges(tmp_path / "merges.txt.gz")
    jt, tt = jclip.ClipTokenizer(path), tclip.ClipTokenizer(path)
    for caption in CAPTIONS:
        assert tt.encode(caption) == jt.encode(caption)
    for ctx in (77, 22):
        np.testing.assert_array_equal(tt.tokenize(CAPTIONS, context_length=ctx),
                                      jt.tokenize(CAPTIONS, context_length=ctx))
    with pytest.raises(ValueError, match="too long"):
        tt.tokenize(CAPTIONS[-1:], context_length=8, truncate=False)
    monkeypatch.delenv("CONDMDI_CLIP_BPE", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):  # no vocabulary here
        tclip.ClipTokenizer()


def test_text_encoder_matches_jax_tower_on_the_22_token_context(tmp_path):
    path = write_merges(tmp_path / "merges.txt.gz")
    sd = fake_clip_state_dict()
    ckpt = tmp_path / "clip.pt"
    torch.save(sd, ckpt)
    enc = tclip.ClipTextEncoder.from_torch_checkpoint(str(ckpt), device="cpu",
                                                      tokenizer=tclip.ClipTokenizer(path))
    got = enc.encode(CAPTIONS)
    ids = jclip.ClipTokenizer(path).tokenize(CAPTIONS, context_length=22)
    ids = np.pad(ids, ((0, 0), (0, 77 - 22)))
    want = jclip.ClipTextModel(**SMALL).apply(jclip.convert_clip_text_state_dict(sd),
                                              jnp.asarray(ids))
    assert got.shape == (len(CAPTIONS), 24) and got.dtype == np.float32
    _close(got, want)
    assert text.encoder_name(enc) == "clip"


def test_make_text_encoder_builds_clip_from_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.delenv("CONDMDI_CLIP_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CONDMDI_CLIP_BPE", write_merges(tmp_path / "merges.txt.gz"))
    # the full tower's sizes; two layers keep the test small
    sd = fake_clip_state_dict(width=512, layers=2, vocab=600, embed=512)
    ckpt = tmp_path / "save" / "clip" / "ViT-B-32.pt"
    ckpt.parent.mkdir(parents=True)
    torch.save(sd, ckpt)
    for mode in ("clip", "auto"):
        enc = text.make_text_encoder(mode=mode, device="cpu")
        assert isinstance(enc, tclip.ClipTextEncoder)
        out = enc.encode(CAPTIONS[:2])
        assert out.shape == (2, 512) and np.isfinite(out).all()
