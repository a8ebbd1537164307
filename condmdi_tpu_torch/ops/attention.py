"""Multi-head attention: the fused self-attention kernel and its plain version.

Counterpart of condmdi_tpu/ops/attention.py, with the same names:

  * `fused_self_attention` is a `torch.autograd.Function`. Its forward sends
    a CUDA tensor to one of the hand-written Hopper kernels of
    csrc/attention.cu (built and bound by ops/_build.py) or raises; it never
    falls back to the plain version. A CPU tensor takes `_xla_attention`, the
    plain PyTorch version. Which kernel runs is `attention_route`, a function
    of the shape and the type alone: the resident `wgmma` kernel in bf16
    ("wgmma"), the same kernel on hi and lo bf16 planes in float32
    ("wgmma_f32"), the streaming kernel for every other shape ("stream"),
    behind a pack pass (`pack_heads` is its plain version) where it needs one.
    Every shape the JAX package computes is taken: any head width, T, B and
    H, and q/k/v at any stride or alignment.
    Its backward recomputes the softmax in plain torch, formula for formula
    as the JAX package's `_fused_bwd` does in XLA: that backward was never a
    Pallas kernel.
  * `mha` sends self-attention (equal query and key lengths) on a CUDA
    tensor to `fused_self_attention`; cross-attention, causal attention and
    every CPU tensor go to `_xla_attention`.
  * `multihead_attention` splits a fused [B, T, 3D] QKV projection into
    three column views, so the kernel reads the heads in place.

`fused_self_attention.launches` counts kernel launches, and nothing else;
`fused_self_attention.routes` counts the calls by route: "wgmma", "wgmma_f32",
"stream" (q, k, v read in place) and "stream_packed" (through the pack pass).
Both count eager calls and the calls a graph capture makes; a replay adds to
`launches` (utils/cuda_graph.py) and not to `routes`, as `ops.dense`'s counters.
The layout follows the JAX package: q [B, Tq, D], k/v [B, Tk, D], heads are
the contiguous hd = D / H column blocks.
"""

from __future__ import annotations

import math

import torch

from condmdi_tpu_torch.ops import _build

_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 2)}  # the C entry's code, bytes a value
_ROUTE_CODES = {"stream": 0, "wgmma": 1, "wgmma_f32": 2}  # as csrc/attention.cu `route_of`
_WGMMA_HEAD_DIMS = (32, 64, 128)  # head widths the resident kernel is instantiated for
_WGMMA_SMEM_BUDGET = 232448 - 1024  # a block's shared memory on sm_90, less a reserve


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)  # [B, H, T, hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def _xla_attention(q, k, v, num_heads: int, causal: bool = False) -> torch.Tensor:
    """The plain version: softmax(q kᵀ / √hd) v per head, in float32; returns q's dtype."""
    Tq, Tk = q.shape[1], k.shape[1]
    hd = q.shape[-1] // num_heads
    qh, kh, vh = (_split_heads(t.float(), num_heads) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()  # col <= row
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return _merge_heads(torch.einsum("bhqk,bhkd->bhqd", probs, vh)).to(q.dtype)


def _fused_bwd(num_heads: int, q, k, v, g):
    """(dq, dk, dv) of self-attention, recomputing the softmax (JAX `_fused_bwd`)."""
    qh, kh, vh, gh = (_split_heads(t.float(), num_heads) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gh)
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    return tuple(_merge_heads(d).to(t.dtype) for d, t in ((dq, q), (dk, k), (dv, v)))


class fused_self_attention(torch.autograd.Function):  # noqa: N801 (the JAX package's name)
    """Self-attention of q, k, v [B, T, D]: the kernel forward, a recompute backward.

    Call as `fused_self_attention.apply(q, k, v, num_heads)`.
    """

    launches = 0
    routes = {"wgmma": 0, "wgmma_f32": 0, "stream": 0, "stream_packed": 0}

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return _xla_attention(q, k, v, num_heads)
        if q.device.type != "cuda":
            raise ValueError(f"fused_self_attention: unsupported device {q.device}")
        return _launch(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_fused_bwd(ctx.num_heads, q, k, v, g), None)


def mha(q, k, v, num_heads: int) -> torch.Tensor:
    """General multi-head attention. q [B, Tq, D]; k, v [B, Tk, D] → [B, Tq, D]."""
    if q.device.type == "cuda" and q.shape[1] == k.shape[1]:
        return fused_self_attention.apply(q, k, v, num_heads)
    return _xla_attention(q, k, v, num_heads)


def multihead_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from a fused QKV projection [B, T, 3D] → [B, T, D]."""
    q, k, v = qkv.chunk(3, dim=-1)
    return mha(q, k, v, num_heads)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def pack_heads(q, k, v, num_heads: int) -> torch.Tensor:
    """The plain version of the streaming route's pack pass (csrc/attention.cu
    `stream::pack_heads_kernel`): q, k, v [B, T, D] → planes [3, P, B*H, t16,
    hd16] in bf16, head-major, zero past T and past hd (t16 and hd16 are T and
    hd rounded up to 16). P = 2 for float32, hi = bf16(x) and lo = bf16(x - hi),
    so hi + lo keeps about 16 mantissa bits; P = 1 for bfloat16."""
    B, T, D = q.shape
    hd = D // num_heads
    x = torch.stack([_split_heads(t, num_heads).reshape(B * num_heads, T, hd) for t in (q, k, v)])
    if x.dtype == torch.float32:
        hi = x.bfloat16()
        planes = torch.stack([hi, (x - hi.float()).bfloat16()], dim=1)
    else:
        planes = x.bfloat16().unsqueeze(1)
    out = torch.zeros((3, planes.shape[1], B * num_heads, _round16(T), _round16(hd)),
                      dtype=torch.bfloat16, device=q.device)
    out[..., :T, :hd] = planes
    return out


def stream_reads_in_place(q, k, v, hd: int) -> bool:
    """Whether the streaming route reads these q, k, v where they lie, without
    the pack pass (csrc/attention.cu `stream::reads_in_place`): views whose head
    width is 16, 32 or a multiple of 64, so that a TMA box never crosses into the
    next head (in float32 at most 512, so that Q's split planes stay resident in
    shared memory, where the kernel splits float32 tiles itself), with 16-byte
    aligned pointers and row strides and a unit column stride (one stride pair
    for all three)."""
    if not (hd in (16, 32) or (hd % 64 == 0 and (q.dtype == torch.bfloat16 or hd <= 512))):
        return False
    strides, size = q.stride(), q.element_size()
    if strides[2] != 1 or k.stride() != strides or v.stride() != strides:
        return False
    return (q.data_ptr() | k.data_ptr() | v.data_ptr() | size * strides[0]
            | size * strides[1]) % 16 == 0


def stream_packs(lib, q, k, v, num_heads: int) -> bool:
    """Whether a launch on the streaming route goes through the pack pass: where
    the kernel cannot read q, k, v in place (`stream_reads_in_place`), and for
    float32 where the library says splitting in shared memory would cost more
    than the pass (csrc/attention.cu `stream::packs_float32`: several column
    blocks, or fewer items than SMs over more than one key tile)."""
    B, T, D = q.shape
    hd = D // num_heads
    return not stream_reads_in_place(q, k, v, hd) or bool(
        lib.condmdi_attention_stream_packs(B, T, num_heads, hd, _DTYPES[q.dtype][0]))


def resident_smem_bytes(T: int, hd: int, planes: int = 1) -> int:
    """Shared memory of the resident kernel (csrc/attention.cu `resident::smem_bytes`,
    which `attention_route` mirrors with it): K and V of one head in `planes`
    planes (1 in bf16; hi and lo in float32), rows padded to a multiple of 16;
    V at least as long as the 64-row product over a short K tile reads past K's
    last plane; 32 barriers."""
    one = 2 * hd * 16 * -(-T // 16)
    return 2 * planes * one + max(0, (64 - 16) * 128 - planes * one) + 32 * 8


def attention_route(B: int, T: int, H: int, hd: int, dtype: torch.dtype) -> str:
    """Which kernel of csrc/attention.cu a [B, T, H*hd] self-attention takes.

    "wgmma": bfloat16, a head width of 32, 64 or 128, and K and V of one head
    within a block's shared memory (T <= 448 at hd=128): all of K and V resident,
    both products on wgmma. "wgmma_f32": float32 at those head widths with the
    hi and lo bf16 planes of K and V within a block (T <= 224 at hd=128, 448 at
    64, 896 at 32): q, k, v split once by a pass before the same kernel, three
    bf16 products for each. "stream": every other shape (other head widths,
    longer T), in either type: K and V stream through a ring of TMA stages into
    wgmma, behind a pack pass into head-major planes where the kernel cannot
    read q, k, v in place. The answer depends on the shape and the type only,
    never on a build or a launch.

    This is csrc/attention.cu `route_of` (exported as `condmdi_attention_route`)
    once more in Python, so that the route can be asked where there is no card.
    The C entry refuses a launch whose route is not its own answer, and
    tests/test_torch_cuda.py holds the two together on the card.
    """
    planes = 2 if dtype == torch.float32 else 1
    if hd in _WGMMA_HEAD_DIMS and resident_smem_bytes(T, hd, planes) <= _WGMMA_SMEM_BUDGET:
        return "wgmma_f32" if planes == 2 else "wgmma"
    return "stream"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy from the allocator, whose rows are 16-byte aligned where
    the rows' bytes are a multiple of 16 (the resident routes' head widths)."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _launch(q, k, v, num_heads: int) -> torch.Tensor:
    """Check what the kernels take, launch one on the current stream, count the launch.

    Written for a short host path (a served step is bound by the host): no
    temporaries beyond the output and the planes a route needs, plain ints to
    ctypes, the stream's raw handle.
    """
    dtype, shape = q.dtype, q.shape
    known = _DTYPES.get(dtype)
    if known is None:
        raise TypeError(f"fused_self_attention: unsupported dtype {dtype}")
    code, size = known
    index = q.get_device()  # -1 on the CPU, which only the tests send here
    if (k.dtype is not dtype or v.dtype is not dtype
            or k.get_device() != index or v.get_device() != index):
        raise TypeError("fused_self_attention: q, k and v must share a dtype and a device")
    if len(shape) != 3 or k.shape != shape or v.shape != shape:
        raise ValueError(
            f"fused_self_attention: q, k, v must be one [B, T, D] shape, got "
            f"{tuple(shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, T, D = shape
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    hd = D // num_heads
    route = attention_route(B, T, num_heads, hd, dtype)
    strides = q.stride()
    if strides[2] != 1 or k.stride() != strides or v.stride() != strides:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        strides = q.stride()
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if route != "stream" and (q_ptr | k_ptr | v_ptr | (strides[0] * size)
                              | (strides[1] * size)) % 16:
        # the resident routes read rows in 16-byte pieces: aligned copies
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        strides = q.stride()
        q_ptr, k_ptr, v_ptr = q.data_ptr(), k.data_ptr(), v.data_ptr()
    lib = _build.load_attention()
    out = torch.empty(shape, device=q.device, dtype=dtype)
    taken = route
    if route == "wgmma_f32":  # hi and lo bf16 planes of q, k and v, written by its split pass
        scratch = torch.empty((3, 2, B, T, D), device=q.device, dtype=torch.bfloat16)
    elif route == "stream" and stream_packs(lib, q, k, v, num_heads):  # the pack pass's planes
        scratch = torch.empty((3, 2 if code == 0 else 1, B * num_heads, _round16(T), _round16(hd)),
                              device=q.device, dtype=torch.bfloat16)
        taken = "stream_packed"
    else:
        scratch = None

    err = lib.condmdi_attention_forward(
        q_ptr, k_ptr, v_ptr, out.data_ptr(), B, T, num_heads, hd, strides[0], strides[1],
        code, _ROUTE_CODES[route], torch._C._cuda_getCurrentRawStream(index),
        None if scratch is None else scratch.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(
            f"attention kernel launch failed (route {route}): {_build.error_string(lib, err)}"
        )
    fused_self_attention.launches += 1
    fused_self_attention.routes[taken] += 1
    return out
