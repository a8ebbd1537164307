"""The key that says when a kernel's cached copy of a weight is stale.

The resblock halves cache their conv weight packed as the kernel reads it
(ops/resblock.py `PackedConvWeight`), and the int8 layers their codes
(ops/quant.py `QuantizedWeight`). A cache is keyed on the weight's version
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
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

_generation = 0


def _advance(_optimizer, _args, _kwargs) -> None:
    global _generation
    _generation += 1


register_optimizer_step_post_hook(_advance)


def weight_key(t: Optional[torch.Tensor]):
    """What a cached copy of `t` is valid for (None for no tensor)."""
    if t is None:
        return None
    return (_generation, t._version, t.data_ptr(), t.dtype, t.device, tuple(t.shape))
