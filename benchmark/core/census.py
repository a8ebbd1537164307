"""The kernels' calls in one forward of the model at a cell's shapes, each timed
alone through the op's public entry, beside its bound (counts/).

The census hooks the port's modules (forward hooks, nothing of the port
changed): each resblock half (`Conv1dBlock`, `Conv1dAdaGNBlock`) records the
x, scale/shift and residual it is given; each transformer encoder layer records
the [B, S, D] its self-attention sees. Each distinct call is then timed with
`timing.device_ms` through `ops.resblock.fused_conv_gn_mish` or
`ops.attention.multihead_attention`, on fresh inputs of the same shapes, types
and `requires_grad`; with `backward`, the forward and its backward under
autograd (whatever implements the backward).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.core.timing import device_ms, sets_past_l2
from benchmark.counts import attention as attn_counts
from benchmark.counts import resblock as res_counts

DT = {torch.bfloat16: "bf16", torch.float32: "f32"}


@dataclass
class Call:
    kernel: str
    key: tuple
    count: int = 0
    bound_ms: float = 0.0
    time_ms: float = 0.0


def _hooks(model, calls: dict):
    from condmdi_tpu_torch.models.mdm import TransformerEncoderLayer
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock, Conv1dBlock

    def half(mod, args, kwargs):
        x = args[0]
        ada = isinstance(mod, Conv1dAdaGNBlock)
        res = None if ada else kwargs.get("res", args[1] if len(args) > 1 else None)
        w = mod.conv.weight
        dtype = w.dtype if x.dtype != w.dtype else x.dtype  # a bf16 x meets f32 weights in f32
        grads = (x.requires_grad, w.requires_grad,
                 bool(ada and args[1].requires_grad), bool(res is not None and res.requires_grad))
        key = (x.shape[0], x.shape[1], w.shape[1], x.shape[2], w.shape[0], ada, res is not None,
               DT[dtype], grads)
        calls.setdefault(("resblock", key), Call("resblock", key)).count += 1

    def layer(mod, args, kwargs):
        x = args[0]
        key = (x.shape[0], x.shape[1], x.shape[2], mod.num_heads, DT[x.dtype], x.requires_grad)
        calls.setdefault(("attention", key), Call("attention", key)).count += 1

    handles = []
    for m in model.modules():
        if isinstance(m, (Conv1dBlock, Conv1dAdaGNBlock)):
            handles.append(m.register_forward_pre_hook(half, with_kwargs=True))
        elif isinstance(m, TransformerEncoderLayer):
            handles.append(m.register_forward_pre_hook(layer, with_kwargs=True))
    return handles


def census(model, forward) -> list[Call]:
    """The kernel calls `forward()` makes through `model`'s modules."""
    calls: dict = {}
    handles = _hooks(model, calls)
    try:
        forward()
    finally:
        for h in handles:
            h.remove()
    return list(calls.values())


def _resblock_inputs(key, device, gen, backward):
    from condmdi_tpu_torch.ops.resblock import PackedConvWeight

    B, T, cin, xc, cout, ada, res, dtype, grads = key
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def rnd(shape, s=1.0, grad=False):
        t = (torch.randn(shape, generator=gen, device=device) * s).to(dt)
        return t.requires_grad_(grad and backward)

    x = torch.nn.functional.pad(rnd((B, T, cin)), (0, xc - cin)).requires_grad_(grads[0] and backward)
    args = [x, rnd((cout, cin, 5), (cin * 5) ** -0.5, grads[1]), rnd((cout,), 0.1, grads[1]),
            (1 + rnd((cout,), 0.1)).detach().requires_grad_(grads[1] and backward),
            rnd((cout,), 0.1, grads[1])]
    kw = {"packed": PackedConvWeight()}
    if ada:
        cond = rnd((B, 2 * cout), 0.2, grads[2])
        kw["scale"], kw["shift"] = cond[:, :cout], cond[:, cout:]
    if res:
        kw["res"] = rnd((B, T, cout), 1.0, grads[3])
    return args, kw


def time_calls(calls: list[Call], device, backward: bool = False, seed: int = 0) -> list[Call]:
    """Each call's device ms and bound ms (forward, or forward and backward)."""
    from condmdi_tpu_torch.ops.attention import multihead_attention
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish

    gen = torch.Generator(device=device).manual_seed(seed)
    for c in calls:
        if c.kernel == "resblock":
            B, T, cin, xc, cout, ada, res, dtype, _ = c.key
            per_set = res_counts.elements(B, T, cin, cout, ada, res) * (2 if dtype == "bf16" else 4)
            sets = [_resblock_inputs(c.key, device, gen, backward)
                    for _ in range(sets_past_l2(per_set))]
            c.bound_ms = res_counts.bound_ms(B, T, cin, cout, ada, res, dtype, backward=backward,
                                             x_grad=c.key[-1][0])

            def fn(args, kw):
                if not backward:
                    with torch.no_grad():
                        return fused_conv_gn_mish(*args, **kw, n_groups=8)
                y = fused_conv_gn_mish(*args, **kw, n_groups=8)
                leaves = [t for t in (*args, kw.get("scale"), kw.get("shift"), kw.get("res"))
                          if t is not None and t.requires_grad]
                return torch.autograd.grad(y, leaves, torch.ones_like(y)) if leaves else y

            c.time_ms = device_ms(fn, sets)
        else:
            B, S, D, H, dtype, _ = c.key
            dt = torch.bfloat16 if dtype == "bf16" else torch.float32
            per_set = 4 * B * S * D * (2 if dtype == "bf16" else 4)
            sets = [(torch.randn((B, S, 3 * D), generator=gen, device=device).to(dt),)
                    for _ in range(sets_past_l2(per_set))]
            c.bound_ms = attn_counts.bound_ms(B, S, D, H, dtype)

            def fn(qkv, _H=H):
                with torch.no_grad():
                    return multihead_attention(qkv, _H)

            c.time_ms = device_ms(fn, sets)
        del sets
    return calls


def roofline(calls: list[Call], kernel: str):
    """Σ bound ÷ Σ time over one forward's calls of `kernel`, in percent; None
    where the forward made none."""
    mine = [c for c in calls if c.kernel == kernel]
    spent = sum(c.time_ms * c.count for c in mine)
    if not mine or spent <= 0:
        return None
    return 100.0 * sum(c.bound_ms * c.count for c in mine) / spent
