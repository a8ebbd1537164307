"""Tensor parallelism for the denoisers (MDM trans_enc and the UNet) on torch.distributed.

Counterpart of condmdi_tpu/parallel/tp.py. The JAX package annotates the
parameters' shardings over a ('dp', 'tp') mesh and lets XLA place the
collectives; the rules and the placement are kept here as they are
(`MDM_TP_RULES`, `UNET_TP_RULES`, `tp_spec_for_path` over the Flax-layout
names of weights.py, `shard_params_tp` with its divisibility guard: a rank's
contiguous chunk along the 'tp' axis of its spec).

The forward is Megatron-style (`tensor_parallel(model, mesh)`): a copy of the
model in which each rank holds its slices and the collectives are explicit.
A column-parallel layer takes its input through `copy_to_tp` (the identity;
its backward all-reduces the input's gradient over tp) and keeps its output
columns; a row-parallel layer computes a partial sum over its input columns
and ends in `reduce_from_tp` (an all-reduce; its backward is the identity),
then adds its bias. With these two autograd Functions every rank's gradients
are those of the one loss: the slices' own, and the whole gradient for the
replicated parameters. (torch.distributed.nn.functional.all_reduce alone
would all-reduce the gradient of a replicated output as well, which counts it
once per rank.)

  * MDM (trans_enc, float): each encoder layer splits its heads over tp: qkv
    keeps the q, k and v rows of the rank's heads, the attention kernel runs
    on those heads, attn_out is row-parallel; ff1 column-parallel, ff2
    row-parallel. A dropout after ff1 draws the whole width's mask and keeps
    the rank's columns, so the step draws what one process draws.
  * UNet (float): in each ResidualTemporalBlock, time_mlp keeps the rank's
    AdaGN scale and shift rows; block1 is column-parallel on GroupNorm group
    boundaries, so the resblock kernel runs on the rank's channels with
    n_groups / tp groups; block2 is row-parallel: its GroupNorm needs the
    all-reduced conv output (the JAX package's psum), so at tp > 1 it runs as
    a conv partial (cuDNN), an all-reduce, then the GroupNorm, Mish and
    residual tail in plain torch, and the kernel runs 17 times a UNet-XL
    forward (block1 x 16 and final_block) instead of 33; at tp = 1 block2 is
    the normal fused half. The time MLP is column- then row-parallel; down-
    and upsample convs are column-parallel, their outputs gathered over tp
    (`gather_from_tp`); final_block is column-parallel and final_conv
    row-parallel. The residual convs, the embeddings and LinearAttention stay
    replicated.

The batch is split over 'dp' as in the data-parallel step (training/loop.py,
with the 2-D mesh): a (dp, tp) step equals the single-process step on the
global batch. `tp_global_norm` is the global gradient norm over the slices.
"""

from __future__ import annotations

import copy
from fnmatch import fnmatchcase
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from condmdi_tpu_torch.parallel.mesh import DATA_AXIS

TP_AXIS = "tp"

# (path suffix, spec): a rule applies when the last names of a leaf's Flax path
# match the suffix (fnmatch patterns); a spec names the mesh axis of each array
# dimension, () = replicated. The biases of row-parallel layers stay replicated:
# they are added after the all-reduce.
MDM_TP_RULES: Sequence[Tuple[Tuple[str, ...], tuple]] = (
    (("qkv", "kernel"), (None, TP_AXIS)),
    (("qkv", "bias"), (TP_AXIS,)),
    (("attn_out", "kernel"), (TP_AXIS, None)),
    (("ff1", "kernel"), (None, TP_AXIS)),
    (("ff1", "bias"), (TP_AXIS,)),
    (("ff2", "kernel"), (TP_AXIS, None)),
)

# the UNet's (Flax kernels: Dense [in, out], Conv [k, in, out])
UNET_TP_RULES: Sequence[Tuple[Tuple[str, ...], tuple]] = (
    (("time_fc1", "kernel"), (None, TP_AXIS)),
    (("time_fc1", "bias"), (TP_AXIS,)),
    (("time_fc2", "kernel"), (TP_AXIS, None)),
    (("time_mlp", "kernel"), (None, TP_AXIS)),
    (("time_mlp", "bias"), (TP_AXIS,)),
    (("block1", "conv", "kernel"), (None, None, TP_AXIS)),
    (("block1", "conv", "bias"), (TP_AXIS,)),
    (("block1", "norm", "scale"), (TP_AXIS,)),
    (("block1", "norm", "bias"), (TP_AXIS,)),
    (("block2", "conv", "kernel"), (None, TP_AXIS, None)),
    (("down*_downsample", "kernel"), (None, None, TP_AXIS)),
    (("down*_downsample", "bias"), (TP_AXIS,)),
    (("up*_upsample", "kernel"), (None, None, TP_AXIS)),
    (("up*_upsample", "bias"), (TP_AXIS,)),
    (("final_block", "conv", "kernel"), (None, None, TP_AXIS)),
    (("final_block", "conv", "bias"), (TP_AXIS,)),
    (("final_block", "norm", "scale"), (TP_AXIS,)),
    (("final_block", "norm", "bias"), (TP_AXIS,)),
    (("final_conv", "kernel"), (None, TP_AXIS, None)),
)


def make_mesh_2d(n_dp: int, n_tp: int, device_type: Optional[str] = None):
    """2-D ('dp', 'tp') DeviceMesh over the n_dp * n_tp processes of the default group
    (rank = dp index * n_tp + tp index: a tp group is n_tp consecutive ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d: no process group; call initialize_distributed first")
    need, have = n_dp * n_tp, dist.get_world_size()
    if have != need:
        raise ValueError(f"dp={n_dp} x tp={n_tp} needs {need} processes, the group has {have}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_dp, n_tp), mesh_dim_names=(DATA_AXIS, TP_AXIS))


def tp_spec_for_path(path, rules=MDM_TP_RULES) -> tuple:
    """The spec of the first rule whose suffix matches the path's last names (a path
    is a tuple of Flax-layout names); ()."""
    names = tuple(str(k) for k in path)
    for suffix, spec in rules:
        if len(names) >= len(suffix) and all(
                fnmatchcase(n, pat) for n, pat in zip(names[-len(suffix):], suffix)):
            return spec
    return ()


def tp_placement(path, shape, n_tp: int, rules=MDM_TP_RULES) -> tuple:
    """The spec a leaf gets: its rule's, or () where the tp size does not divide the
    dimension the rule splits (the 263-dim output, the keyframe input's 526)."""
    spec = tp_spec_for_path(path, rules)
    for ax, name in enumerate(spec):
        if name == TP_AXIS and shape[ax] % n_tp:
            return ()
    return spec


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def shard_params_tp(mesh, tree: dict, rules=MDM_TP_RULES) -> dict:
    """A Flax-layout tree (nested dicts of tensors or arrays) laid out as the JAX
    package lays it: each leaf replaced by this rank's contiguous chunk along its
    spec's tp axis, unmatched or indivisible leaves whole."""
    tp = mesh[TP_AXIS]
    n, r = tp.size(), tp.get_local_rank()
    out: dict = {}
    for path, x in _flat(tree):
        spec = tp_placement(path, tuple(x.shape), n, rules)
        if TP_AXIS in spec:
            ax = spec.index(TP_AXIS)
            size = x.shape[ax] // n
            x = x[(slice(None),) * ax + (slice(r * size, (r + 1) * size),)]
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


# --------------------------------------------------------------------------- #
# the collectives, as autograd Functions
# --------------------------------------------------------------------------- #
class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The ranks' equal slices of `dim` concatenated in rank order; the backward
    keeps the rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.n, ctx.r = dim, n, r
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.r].contiguous(), None, None


def copy_to_tp(x, group):
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x, group, dim=-1):
    return _GatherFromTP.apply(x, group, dim % x.ndim)


# --------------------------------------------------------------------------- #
# the tensor-parallel modules
# --------------------------------------------------------------------------- #
class _TP:
    """What every tensor-parallel module knows: its tp group, the rank in it and the
    size, and which of its parameters are slices of which full parameters."""

    def _tp_init(self, group):
        self.group = group
        self.n, self.r = dist.get_world_size(group), dist.get_rank(group)
        self.slices: dict[str, tuple[str, int, torch.Tensor]] = {}

    def _take(self, local: nn.Module, name: str, full: torch.Tensor, dim: int, idx):
        """local.name (a parameter of the slice's shape) = full[idx] along dim, marked
        as a slice (`tp_sharded`); returns idx."""
        idx = torch.as_tensor(idx, device=full.device)
        with torch.no_grad():
            getattr(local, name).copy_(full.index_select(dim, idx))
        getattr(local, name).tp_sharded = True
        return idx

    def _chunk(self, size: int):
        return _rank_chunk(size, self.group)


def _rank_chunk(size: int, group) -> torch.Tensor:
    """The rank's contiguous share of range(size) over the group."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return torch.arange(r * size // n, (r + 1) * size // n)


def _dense_like(dense, out_f, in_f, bias=True):
    from condmdi_tpu_torch.models.layers import Dense

    w = dense.weight
    return Dense(in_f, out_f, use_bias=bias, device=w.device, dtype=w.dtype)


class ColumnDense(nn.Module, _TP):
    """The rows `rows` of a Dense's output (weight [out, in])."""

    def __init__(self, dense, group, rows):
        super().__init__()
        self._tp_init(group)
        self.inner = _dense_like(dense, len(rows), dense.weight.shape[1])
        self.slices["inner.weight"] = ("weight", 0, self._take(self.inner, "weight", dense.weight,
                                                               0, rows))
        self.slices["inner.bias"] = ("bias", 0, self._take(self.inner, "bias", dense.bias, 0, rows))

    def forward(self, x):
        return self.inner(copy_to_tp(x, self.group))


class RowDense(nn.Module, _TP):
    """A Dense over the rank's slice of its input features, all-reduced, then its bias."""

    def __init__(self, dense, group, cols):
        super().__init__()
        self._tp_init(group)
        self.inner = _dense_like(dense, dense.weight.shape[0], len(cols), bias=False)
        self.slices["inner.weight"] = ("weight", 1, self._take(self.inner, "weight", dense.weight,
                                                               1, cols))
        self.bias = nn.Parameter(dense.bias.detach().clone())

    def forward(self, x_local):
        return reduce_from_tp(self.inner(x_local), self.group) + self.bias.to(x_local.dtype)


class _ColumnDraws:
    """A model's draws on a tensor-parallel rank for a tensor split by columns: the
    whole width's mask drawn, the rank's columns kept."""

    def __init__(self, draws, cols: slice, width: int):
        self.draws, self.cols, self.width = draws, cols, width

    def keep(self, shape, keep_prob, device):
        full = tuple(shape[:-1]) + (self.width,)
        return self.draws.keep(full, keep_prob, device)[..., self.cols]


class TPEncoderLayer(nn.Module, _TP):
    """MDM's post-LN encoder layer with its heads split over tp."""

    def __init__(self, layer, group):
        from condmdi_tpu_torch.models.mdm import QDense

        super().__init__()
        self._tp_init(group)
        H, D = layer.num_heads, layer.qkv.weight.shape[1]
        ff = layer.ff1.weight.shape[0]
        if layer.qkv.precision_mode != "float" or H % self.n or ff % self.n:
            raise NotImplementedError("tensor-parallel MDM: float mode, heads and ff width "
                                      f"divisible by tp={self.n}")
        self.num_heads, self.activation, self.dropout = H // self.n, layer.activation, \
            layer.dropout
        dd = dict(device=layer.qkv.weight.device, dtype=layer.qkv.weight.dtype)
        heads = self._chunk(D)  # the rank's heads' feature columns of q, k and v
        qkv_rows = torch.cat([heads, heads + D, heads + 2 * D])
        self.qkv = QDense(D, len(qkv_rows), **dd)
        self.slices["qkv.weight"] = ("qkv.weight", 0, self._take(self.qkv, "weight",
                                                                 layer.qkv.weight, 0, qkv_rows))
        self.slices["qkv.bias"] = ("qkv.bias", 0, self._take(self.qkv, "bias", layer.qkv.bias, 0,
                                                             qkv_rows))
        self.attn_out = RowDense(layer.attn_out, group, heads)
        self.norm1, self.norm2 = layer.norm1, layer.norm2
        self.ff_cols = self._chunk(ff)
        self.ff_slice = slice(int(self.ff_cols[0]), int(self.ff_cols[-1]) + 1)
        self.ff_width = ff
        self.ff1 = ColumnDense(layer.ff1, group, self.ff_cols)
        self.ff2 = RowDense(layer.ff2, group, self.ff_cols)
        for sub, prefix in ((self.attn_out, "attn_out"), (self.ff1, "ff1"), (self.ff2, "ff2")):
            for k, (src, dim, idx) in sub.slices.items():
                self.slices[f"{prefix}.{k}"] = (f"{prefix}.{src}", dim, idx)

    def forward(self, x, draws=None):
        from condmdi_tpu_torch.models.layers import dropout
        from condmdi_tpu_torch.models.mdm import activate
        from condmdi_tpu_torch.ops.attention import multihead_attention

        p = self.dropout
        a = self.attn_out(multihead_attention(self.qkv(copy_to_tp(x, self.group)),
                                              self.num_heads))
        x = self.norm1(x + dropout(a, p, draws))
        cols = None if draws is None else _ColumnDraws(draws, self.ff_slice, self.ff_width)
        h = dropout(activate(self.ff1(x), self.activation), p, cols)
        return self.norm2(x + dropout(self.ff2(h), p, draws))


def _half_like(half, in_ch, out_ch, n_groups, adagn):
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock, Conv1dBlock

    w = half.conv.weight
    dd = dict(device=w.device, dtype=w.dtype)
    k = w.shape[-1]
    if adagn:
        return Conv1dAdaGNBlock(in_ch, out_ch, k, n_groups=n_groups, **dd)
    return Conv1dBlock(in_ch, out_ch, k, n_groups=n_groups, **dd)


class ColumnHalf(nn.Module, _TP):
    """A resblock half (conv → GroupNorm → [AdaGN] → Mish) on the rank's output
    channels, whole groups of them: the fused kernel with n_groups / tp groups."""

    def __init__(self, half, group, adagn):
        super().__init__()
        self._tp_init(group)
        C = half.conv.weight.shape[0]
        if half.n_groups % self.n:
            raise NotImplementedError(f"tp={self.n} does not split {half.n_groups} groups")
        self.channels = self._chunk(C)
        self.inner = _half_like(half, half.conv.weight.shape[1], len(self.channels),
                                half.n_groups // self.n, adagn)
        for name, full in (("conv.weight", half.conv.weight), ("conv.bias", half.conv.bias),
                           ("norm.weight", half.norm.weight), ("norm.bias", half.norm.bias)):
            mod, _, leaf = name.rpartition(".")
            self.slices[f"inner.{name}"] = (name, 0, self._take(
                self.inner.get_submodule(mod), leaf, full, 0, self.channels))

    def forward(self, x, *args):
        return self.inner(copy_to_tp(x, self.group), *args)


class RowHalf(nn.Module, _TP):
    """block2 at tp > 1: the conv over the rank's input channels (a partial sum),
    all-reduced, the bias, then GroupNorm, Mish and the residual."""

    def __init__(self, half, group):
        super().__init__()
        self._tp_init(group)
        w = half.conv.weight  # [Cout, Cin, k]
        self.n_groups, self.padding = half.n_groups, w.shape[-1] // 2
        self.weight = nn.Parameter(torch.empty((w.shape[0], w.shape[1] // self.n, w.shape[2]),
                                               device=w.device, dtype=w.dtype))
        self.slices["weight"] = ("conv.weight", 1, self._take(self, "weight", w, 1,
                                                              self._chunk(w.shape[1])))
        self.bias = nn.Parameter(half.conv.bias.detach().clone())
        self.slices["bias"] = ("conv.bias", None, None)  # whole, under another name
        self.norm = half.norm

    def forward(self, h_local, res=None):
        from condmdi_tpu_torch.ops.resblock import mish

        y = F.conv1d(h_local.transpose(1, 2), self.weight, None, padding=self.padding)
        y = reduce_from_tp(y, self.group) + self.bias[:, None]
        y = mish(F.group_norm(y, self.n_groups, self.norm.weight, self.norm.bias, eps=1e-5))
        y = y.transpose(1, 2)
        return y if res is None else res + y


class ColumnConv(nn.Module, _TP):
    """A conv (a QConv, or the upsample's transposed conv) on the rank's output
    channels, gathered over tp: every rank ends with the whole output."""

    def __init__(self, conv, group, transposed=False, stride=1, padding=0):
        super().__init__()
        self._tp_init(group)
        self.transposed, self.stride, self.padding = transposed, stride, padding
        w = conv.weight  # Conv1d [out, in, k]; ConvTranspose1d [in, out, k]
        out_dim = 1 if transposed else 0
        self.channels = self._chunk(w.shape[out_dim])
        shape = list(w.shape)
        shape[out_dim] = len(self.channels)
        self.weight = nn.Parameter(torch.empty(shape, device=w.device, dtype=w.dtype))
        self.bias = nn.Parameter(torch.empty((len(self.channels),), device=w.device,
                                             dtype=w.dtype))
        self.slices["weight"] = ("weight", out_dim, self._take(self, "weight", w, out_dim,
                                                               self.channels))
        self.slices["bias"] = ("bias", 0, self._take(self, "bias", conv.bias, 0, self.channels))

    def forward(self, x):
        x = copy_to_tp(x, self.group).transpose(1, 2)
        if self.transposed:
            y = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride,
                                   padding=self.padding)
        else:
            y = F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=self.stride,
                         padding=self.padding)
        return gather_from_tp(y, self.group, dim=1).transpose(1, 2).contiguous()


class RowConv(nn.Module, _TP):
    """final_conv (1×1) over the rank's input channels, all-reduced, then its bias."""

    def __init__(self, conv, group):
        super().__init__()
        self._tp_init(group)
        w = conv.weight
        self.weight = nn.Parameter(torch.empty((w.shape[0], w.shape[1] // self.n, w.shape[2]),
                                               device=w.device, dtype=w.dtype))
        self.slices["weight"] = ("weight", 1, self._take(self, "weight", w, 1,
                                                         self._chunk(w.shape[1])))
        self.bias = nn.Parameter(conv.bias.detach().clone())

    def forward(self, x_local):
        y = F.conv1d(x_local.transpose(1, 2), self.weight.to(x_local.dtype), None)
        return (reduce_from_tp(y, self.group) + self.bias.to(y.dtype)[:, None]).transpose(1, 2)


def _swap(parent: nn.Module, name: str, new: nn.Module, slices: dict, prefix: str) -> None:
    setattr(parent, name, new)
    for k, (src, dim, idx) in new.slices.items():
        slices[f"{prefix}{name}.{k}"] = (f"{prefix}{name}.{src}", dim, idx)


def _split_resblock(blk: nn.Module, group, slices: dict, prefix: str) -> None:
    """A ResidualTemporalBlock made tensor-parallel in place: time_mlp keeps the
    rank's AdaGN scale and shift rows (its channels without AdaGN), block1 is
    column-parallel and, at tp > 1, block2 row-parallel; the residual conv stays."""
    C = blk.block2.conv.weight.shape[0]
    ch = _rank_chunk(C, group)
    rows = torch.cat([ch, ch + C]) if blk.adagn else ch
    _swap(blk, "time_mlp", ColumnDense(blk.time_mlp, group, rows), slices, prefix)
    _swap(blk, "block1", ColumnHalf(blk.block1, group, blk.adagn), slices, prefix)
    if dist.get_world_size(group) > 1:
        _swap(blk, "block2", RowHalf(blk.block2, group), slices, prefix)


def tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """A copy of `model` (MDM trans_enc or MDM_UNET, float mode) whose layers hold this
    rank's slices over the mesh's tp axis (a 2-D ('dp', 'tp') mesh, or a 1-D one
    named 'tp'). Its `tp_slices` maps each sliced parameter's name to (the full
    model's parameter name, the dimension, the indices taken; dimension None for a
    whole parameter kept under another name)."""
    from condmdi_tpu_torch.models.mdm import MDM, TransformerEncoderLayer
    from condmdi_tpu_torch.models.unet import MDM_UNET

    group = tp_group_of(mesh) or mesh.get_group()
    tpm = copy.deepcopy(model)
    slices: dict = {}
    if isinstance(tpm, MDM):
        if not tpm.arch.startswith("trans_enc") or not tpm.encoder:
            raise NotImplementedError("tensor-parallel MDM: the trans_enc architecture")
        for i in range(tpm.num_layers):
            layer = getattr(tpm, f"layer{i}")
            assert isinstance(layer, TransformerEncoderLayer)
            _swap(tpm, f"layer{i}", TPEncoderLayer(layer, group), slices, "")
    elif isinstance(tpm, MDM_UNET):
        if tpm.precision_mode != "float":
            raise NotImplementedError("tensor-parallel UNet: float mode")
        u = tpm.unet
        hidden = _rank_chunk(u.time_fc1.weight.shape[0], group)
        _swap(u, "time_fc1", ColumnDense(u.time_fc1, group, hidden), slices, "unet.")
        _swap(u, "time_fc2", RowDense(u.time_fc2, group, hidden), slices, "unet.")
        for name, mod in list(u.named_children()):
            if name.endswith(("_res1", "_res2")) or name in ("mid_block1", "mid_block2"):
                _split_resblock(mod, group, slices, f"unet.{name}.")
            elif name.endswith("_downsample"):
                _swap(u, name, ColumnConv(mod, group, stride=2, padding=1), slices, "unet.")
            elif name.endswith("_upsample"):
                _swap(u, name, ColumnConv(mod, group, transposed=True, stride=mod.stride,
                                             padding=mod.padding),
                      slices, "unet.")
        _swap(u, "final_block", ColumnHalf(u.final_block, group, adagn=False), slices, "unet.")
        _swap(u, "final_conv", RowConv(u.final_conv, group), slices, "unet.")
    else:
        raise NotImplementedError(f"tensor_parallel: {type(model).__name__}")
    tpm.tp_slices = slices
    tpm.tp_group = group
    return tpm


def full_slice(full: dict[str, torch.Tensor], tpm: nn.Module) -> dict[str, torch.Tensor]:
    """The tensor-parallel model's parameters taken from a full model's {name:
    tensor} (its own slices where sliced): what the rank would hold for `full`."""
    out = {}
    names = dict(tpm.named_parameters())
    for name in names:
        if name in tpm.tp_slices:
            src, dim, idx = tpm.tp_slices[name]
            out[name] = full[src] if dim is None else \
                full[src].index_select(dim, idx.to(full[src].device))
        else:
            out[name] = full[name]
    return out


def tp_group_of(mesh):
    """The tp process group of a mesh with a 'tp' axis, else None."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh[TP_AXIS].get_group() if TP_AXIS in names and len(names) > 1 else None


def tp_global_norm(tensors, sharded, group) -> torch.Tensor:
    """sqrt of the sum of squares over the whole model (optax.global_norm): the
    squares of the tensors marked in `sharded` (a rank's slices) summed over the tp
    group, the replicated ones counted once."""
    sq = [t.detach().float().pow(2).sum() for t in tensors]
    zero = torch.zeros((), device=tensors[0].device)
    sq_s = sum((q for q, s in zip(sq, sharded) if s), zero).clone()
    dist.all_reduce(sq_s, group=group)
    return torch.sqrt(sq_s + sum((q for q, s in zip(sq, sharded) if not s), zero))
