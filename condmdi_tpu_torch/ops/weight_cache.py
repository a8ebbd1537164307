"""The key that says when a kernel's cached copy of a weight is stale.

The resblock halves cache their conv weight packed as the kernel reads it
(ops/resblock.py `PackedConvWeight`), MDM's float32 projections theirs split
into TF32 planes (ops/dense.py `SplitDenseWeight`), both `DerivedWeight`s, and
the int8 layers their codes (ops/quant.py `QuantizedWeight`). A cache is keyed on the weight's version
counter, data pointer, dtype, device and shape, so `load_state_dict`, an
in-place update and `.to()` invalidate it. An optimizer's step need not move
the version counter: `torch.optim.AdamW(fused=True)` updates its parameters in
one kernel that leaves it as it was (the card test
`test_resblock_follows_adamw_steps` found a half reading its old packed weight
after such a step). So every step of any torch optimizer advances a
generation, through torch.optim's global step hook, and the key holds it too:
after a step each cache is remade once, at its next use. The hook is global:
any optimizer's step anywhere in the process, also one that trains another
model (the evaluator's trainer), invalidates every cache, and each is remade
at its next use.

A CUDA graph runs none of this host code. A serving graph keeps the copies it
was captured with, and its holder (utils/cuda_graph.py) keys it on the same
`weight_key`s, capturing it again when they change. A train step's graph
changes its own weights: it is captured under `repack_on_every_call()`, in
which each cache re-packs its weight on every call into the buffer it already
holds, so that every replay packs the weights its previous AdamW step wrote;
and each replay advances the generation (`advance()`), as the eager step's
hook does, so that an eager call after it packs again.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

_generation = 0
_repacking = False


def advance() -> None:
    """Count one optimizer step: every cache is stale at its next use."""
    global _generation
    _generation += 1


def generation() -> int:
    """The optimizer steps counted so far (part of every `weight_key`)."""
    return _generation


register_optimizer_step_post_hook(lambda _optimizer, _args, _kwargs: advance())


@contextlib.contextmanager
def repack_on_every_call():
    """While open, the caches re-pack on every call, in place (see above)."""
    global _repacking
    saved, _repacking = _repacking, True
    try:
        yield
    finally:
        _repacking = saved


def repacking() -> bool:
    """Whether a train step is being captured (`repack_on_every_call`)."""
    return _repacking


def copy_into(held: Optional[torch.Tensor], fresh: Optional[torch.Tensor]):
    """`fresh` written into `held` where `held` can take it (the same shape, dtype and
    device), so that a captured graph keeps reading `held`; else `fresh` itself."""
    if (held is None or fresh is None or held.shape != fresh.shape
            or held.dtype != fresh.dtype or held.device != fresh.device):
        return fresh
    return held.copy_(fresh)


def weight_key(t: Optional[torch.Tensor]):
    """What a cached copy of `t` is valid for (None for no tensor)."""
    if t is None:
        return None
    return (_generation, t._version, t.data_ptr(), t.dtype, t.device, tuple(t.shape))


class DerivedWeight:
    """A kernel's copy of one weight (a subclass's `derive`), remade when the
    weight changes: keyed on `weight_key`, so that `load_state_dict`, an in-place
    update, `.to(dtype)`, `.to(device)` and an optimizer's step (fused AdamW's
    too, which leaves the version counter as it was) all invalidate it (a write
    through `weight.data` bypasses the version counter and is not seen). Under
    `repack_on_every_call()` it derives on every call into the tensor it holds,
    and from then on it re-derives into that tensor, which a train step's graph
    keeps writing and reading. Held by the calling module as a plain attribute:
    not a parameter, not a buffer, not in the state_dict.
    """

    def __init__(self):
        self._key = None
        self._copy = None
        self._pinned = False  # a captured graph writes and reads this very tensor

    @staticmethod
    def derive(w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get(self, w: torch.Tensor) -> torch.Tensor:
        key = weight_key(w)
        if repacking() or key != self._key:
            fresh = self.derive(w.detach())
            self._pinned = self._pinned or repacking()
            self._copy = copy_into(self._copy, fresh) if self._pinned else fresh
            self._key = key
        return self._copy

