"""CLIP ViT-B/32 text tower, tokenizer and checkpoint converter on tensors.

Counterpart of condmdi_tpu/models/clip.py. The reference conditions on a
frozen CLIP text encoder (mdm.py load_and_freeze_clip, encode_text with the
context_length=22 + zero-pad-to-77 trick):

  * `ClipTextModel`: the text transformer (vocab 49408, ctx 77, width 512, 12
    pre-LN layers, 8 heads, QuickGELU, causal self-attention, ln_final,
    text_projection; the features at the EOT token, the argmax of the ids).
    The causal attention is the plain version (ops.attention._xla_attention),
    as the JAX package computes it with XLA and not with its Pallas kernel;
  * `convert_clip_text_state_dict`: an OpenAI CLIP state dict → the Flax tree,
    which weights.load_flax_params maps onto the tower (the same names);
  * `ClipTokenizer`: CLIP's lowercase byte-pair tokenizer; it needs the public
    `bpe_simple_vocab_16e6.txt.gz` (or any merges file given as `bpe_path`);
  * `ClipTextEncoder`: the drop-in text encoder, the tower on `device` (the
    card unless the caller passes "cpu"), the 22-token context padded to 77.

Neither the ViT-B/32 weights nor the vocabulary are in the repository: the
tower runs for real only where both are supplied.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.models.layers import Dense, LayerNorm
from condmdi_tpu_torch.ops.attention import _xla_attention

CLIP_VOCAB = 49408
CLIP_CTX = 77
CLIP_WIDTH = 512
CLIP_LAYERS = 12
CLIP_HEADS = 8


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipResidualBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)) (causal), then x + mlp(ln_2(x)) with QuickGELU."""

    def __init__(self, width: int = CLIP_WIDTH, heads: int = CLIP_HEADS, *, device=None,
                 dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.heads = heads
        self.ln_1 = LayerNorm(width, **dd)
        self.attn_in = Dense(width, 3 * width, **dd)
        self.attn_out = Dense(width, width, **dd)
        self.ln_2 = LayerNorm(width, **dd)
        self.mlp_fc = Dense(width, 4 * width, **dd)
        self.mlp_proj = Dense(4 * width, width, **dd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.attn_in(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.attn_out(_xla_attention(q, k, v, self.heads, causal=True))
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class ClipTextModel(nn.Module):
    """token ids [B, ctx] → text features [B, embed_dim]; parameters allocated empty
    (load a converted checkpoint with weights.load_flax_params)."""

    def __init__(self, vocab_size: int = CLIP_VOCAB, context_length: int = CLIP_CTX,
                 width: int = CLIP_WIDTH, layers: int = CLIP_LAYERS, heads: int = CLIP_HEADS,
                 embed_dim: int = 512, *, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        dd = dict(device=device, dtype=dtype)
        self.layers = layers
        self.token_embedding = nn.Parameter(torch.empty((vocab_size, width), **dd))
        self.positional_embedding = nn.Parameter(torch.empty((context_length, width), **dd))
        for i in range(layers):
            self.add_module(f"block{i}", ClipResidualBlock(width, heads, **dd))
        self.ln_final = LayerNorm(width, **dd)
        self.text_projection = nn.Parameter(torch.empty((width, embed_dim), **dd))

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        ids = token_ids.long()
        x = self.token_embedding[ids] + self.positional_embedding[None, : ids.shape[1]]
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_final(x)
        eot = ids.argmax(dim=-1)  # EOT has the highest token id
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection


def convert_clip_text_state_dict(sd: dict) -> dict:
    """OpenAI CLIP state dict (the text tower's keys) → {"params": Flax tree}."""

    def npy(t):
        if hasattr(t, "detach"):
            t = t.detach().cpu().float().numpy()
        return np.asarray(t, dtype=np.float32)

    def dense(pre):
        return {"kernel": npy(sd[f"{pre}.weight"]).T, "bias": npy(sd[f"{pre}.bias"])}

    def norm(pre):
        return {"scale": npy(sd[f"{pre}.weight"]), "bias": npy(sd[f"{pre}.bias"])}

    p: dict = {
        "token_embedding": npy(sd["token_embedding.weight"]),
        "positional_embedding": npy(sd["positional_embedding"]),
        "text_projection": npy(sd["text_projection"]),
        "ln_final": norm("ln_final"),
    }
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        pre = f"transformer.resblocks.{i}"
        p[f"block{i}"] = {
            "ln_1": norm(f"{pre}.ln_1"),
            "ln_2": norm(f"{pre}.ln_2"),
            "attn_in": {"kernel": npy(sd[f"{pre}.attn.in_proj_weight"]).T,
                        "bias": npy(sd[f"{pre}.attn.in_proj_bias"])},
            "attn_out": dense(f"{pre}.attn.out_proj"),
            "mlp_fc": dense(f"{pre}.mlp.c_fc"),
            "mlp_proj": dense(f"{pre}.mlp.c_proj"),
        }
        i += 1
    return {"params": p}


# --------------------------------------------------------------------------- #
# BPE tokenizer (CLIP's; needs the public vocabulary file)
# --------------------------------------------------------------------------- #
@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


class ClipTokenizer:
    """CLIP's lowercase BPE over byte-encoded text."""

    def __init__(self, bpe_path: Optional[str] = None):
        path = bpe_path or self._find_vocab()
        if path is None:
            raise FileNotFoundError("bpe_simple_vocab_16e6.txt.gz not found; set CONDMDI_CLIP_BPE")
        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {}
        self.pat = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
                              re.IGNORECASE)

    @staticmethod
    def _find_vocab() -> Optional[str]:
        import os

        for c in (os.environ.get("CONDMDI_CLIP_BPE", ""), "assets/bpe_simple_vocab_16e6.txt.gz",
                  "bpe_simple_vocab_16e6.txt.gz"):
            if c and Path(c).exists():
                return c
        return None

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        ids = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def tokenize(self, texts: Sequence[str], context_length: int = CLIP_CTX,
                 truncate: bool = True) -> np.ndarray:
        sot, eot = self.encoder["<|startoftext|>"], self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [sot] + self.encode(t) + [eot]
            if len(toks) > context_length:
                if not truncate:
                    raise ValueError(f"too long: {t}")
                toks = toks[: context_length - 1] + [eot]
            out[i, : len(toks)] = toks
        return out


class ClipTextEncoder:
    """Drop-in text encoder producing CLIP embeddings (numpy [B, embed_dim]).

    The reference's humanml trick: tokenize with context_length = max_text_len
    (20) + 2, zero-pad to 77. The tower's sizes are read from `params` (a
    {"params": Flax tree}), with CLIP's 8 heads.
    """

    def __init__(self, params: dict, tokenizer: Optional[ClipTokenizer] = None,
                 max_text_len: Optional[int] = 20, device: str | torch.device = "cuda"):
        from condmdi_tpu_torch.models.flax_init import load_params
        from condmdi_tpu_torch.weights import load_flax_params

        tree = params.get("params", params)
        vocab, width = np.shape(tree["token_embedding"])
        layers = sum(1 for k in tree if k.startswith("block"))
        self.model = ClipTextModel(vocab, np.shape(tree["positional_embedding"])[0], width,
                                   layers, CLIP_HEADS, np.shape(tree["text_projection"])[1],
                                   device=device)
        load_params(self.model, load_flax_params({"params": tree}))
        self.model.requires_grad_(False).eval()
        self.device = self.model.token_embedding.device
        self.tokenizer = tokenizer or ClipTokenizer()
        self.max_text_len = max_text_len

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kw) -> "ClipTextEncoder":
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.state_dict() if hasattr(blob, "state_dict") else blob
        return cls(convert_clip_text_state_dict(sd), **kw)

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if self.max_text_len is not None:
            ctx = self.max_text_len + 2
            ids = self.tokenizer.tokenize(texts, context_length=ctx)
            ids = np.pad(ids, ((0, 0), (0, CLIP_CTX - ctx)))
        else:
            ids = self.tokenizer.tokenize(texts)
        return self.model(torch.as_tensor(ids, device=self.device)).cpu().numpy()
