"""Text conditioning: captions → [B, 512] embeddings the denoisers condition on.

Counterpart of condmdi_tpu/models/text.py (a numpy module, copied here so the
port imports nothing of the JAX package):

  * `HashTextEncoder`: a deterministic unit-norm pseudo-embedding from a
    SHA-256 of the caption (tests, benches, asset-free runs);
  * `CachedTextEncoder`: a lookup of precomputed CLIP embeddings (the
    production path: embeddings computed once offline per caption set);
  * `make_text_encoder` in modes hash, cached, clip and auto, and
    `encoder_name`, the tag a run records.

Mode `clip` (and `auto` where a checkpoint is found) builds models/clip.py's
ClipTextEncoder, the CLIP ViT-B/32 text tower on `device`, from a reference
checkpoint; it needs the checkpoint and the BPE vocabulary, neither of which
is in the repository.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Optional, Protocol, Sequence

import numpy as np

CLIP_DIM = 512
_CLIP_CKPT_CANDIDATES = ("save/clip/ViT-B-32.pt", "dataset/ViT-B-32.pt")


class TextEncoder(Protocol):
    def encode(self, texts: Sequence[str]) -> np.ndarray:  # [B, 512]
        ...


class HashTextEncoder:
    """Deterministic unit-norm embedding from a SHA-256 of the caption."""

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), CLIP_DIM), dtype=np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(hashlib.sha256(t.encode("utf-8")).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(CLIP_DIM).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


class CachedTextEncoder:
    """Lookup table of precomputed CLIP embeddings keyed by caption string."""

    def __init__(self, table: dict[str, np.ndarray], fallback: TextEncoder | None = None):
        self.table = table
        self.fallback = fallback or HashTextEncoder()

    @classmethod
    def from_npz(cls, path: str) -> "CachedTextEncoder":
        # the table scripts/export_text_embeddings.py writes: captions as an object array
        with np.load(path, allow_pickle=True) as data:
            captions = [str(c) for c in data["captions"]]
            embeds = np.asarray(data["embeddings"], dtype=np.float32)
        return cls(dict(zip(captions, embeds)))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), CLIP_DIM), dtype=np.float32)
        missing = [t for t in texts if t not in self.table]
        if missing:
            warnings.warn(
                f"CachedTextEncoder: {len(missing)}/{len(texts)} captions not in the "
                f"embedding table (e.g. {missing[0]!r}); falling back to "
                f"{type(self.fallback).__name__} for those — outputs for them are NOT "
                "real CLIP embeddings",
                stacklevel=2,
            )
            fallback = iter(self.fallback.encode(missing))
        for i, t in enumerate(texts):
            out[i] = self.table[t] if t in self.table else next(fallback)
        return out


def encoder_name(enc: TextEncoder) -> str:
    """Short self-describing tag recorded in output artifacts."""
    return {
        "HashTextEncoder": "hash",
        "CachedTextEncoder": "cached",
        "ClipTextEncoder": "clip",
    }.get(type(enc).__name__, type(enc).__name__)


def find_clip_checkpoint() -> Optional[str]:
    """A CLIP ViT-B/32 checkpoint from $CONDMDI_CLIP_CKPT or the known locations."""
    for c in (os.environ.get("CONDMDI_CLIP_CKPT", ""), *_CLIP_CKPT_CANDIDATES):
        if c and os.path.isfile(c):
            return c
    return None


def _clip_encoder(ckpt: str, device):
    from condmdi_tpu_torch.models.clip import ClipTextEncoder

    return ClipTextEncoder.from_torch_checkpoint(ckpt, device=device)


def make_text_encoder(args=None, *, mode: Optional[str] = None,
                      embeddings_path: Optional[str] = None,
                      clip_checkpoint: Optional[str] = None,
                      device="cuda") -> TextEncoder:
    """Resolve the text encoder for a run.

      auto    cached npz if given, else CLIP if a checkpoint is discoverable,
              else HashTextEncoder with a loud warning;
      cached  requires an embeddings npz;
      hash    explicit opt-in to pseudo-embeddings;
      clip    requires a CLIP checkpoint (error if absent).
    The CLIP tower runs on `device` (the card unless the caller passes "cpu").
    """
    mode = mode or getattr(args, "text_encoder", "auto") or "auto"
    npz = embeddings_path if embeddings_path is not None else (
        getattr(args, "text_embeddings", "") or "")
    ckpt = clip_checkpoint if clip_checkpoint is not None else (
        getattr(args, "clip_checkpoint", "") or "")

    if mode == "hash":
        return HashTextEncoder()
    if mode == "cached":
        if not npz:
            raise ValueError("--text_encoder cached requires --text_embeddings <npz>")
        return CachedTextEncoder.from_npz(npz)
    if mode == "clip":
        ckpt = ckpt or find_clip_checkpoint()
        if not ckpt:
            raise ValueError(
                "--text_encoder clip requires a CLIP ViT-B/32 checkpoint: pass "
                "--clip_checkpoint, set $CONDMDI_CLIP_CKPT, or place it at "
                + " or ".join(_CLIP_CKPT_CANDIDATES)
            )
        return _clip_encoder(ckpt, device)
    if mode == "auto":
        if npz:
            return CachedTextEncoder.from_npz(npz)
        ckpt = ckpt or find_clip_checkpoint()
        if ckpt:
            return _clip_encoder(ckpt, device)
        warnings.warn(
            "no CLIP checkpoint or embedding table found — text conditioning falls back "
            "to HashTextEncoder (deterministic pseudo-embeddings). Outputs are NOT "
            "conditioned on real text semantics. Pass --text_embeddings <npz> or provide a "
            "CLIP checkpoint (--clip_checkpoint / $CONDMDI_CLIP_CKPT); use --text_encoder "
            "hash to silence this warning.",
            stacklevel=2,
        )
        return HashTextEncoder()
    raise ValueError(f"unknown --text_encoder {mode!r} (auto|clip|cached|hash)")
