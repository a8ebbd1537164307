"""Process groups, the 1-D data-parallel mesh and its placement rules on torch.distributed.

Counterpart of condmdi_tpu/parallel/mesh.py. The JAX package places arrays
on a `jax.sharding` mesh and lets XLA insert the collectives; here each card
is one process (NCCL on the card, gloo on the CPU), the mesh is a
`DeviceMesh` with one axis named "dp", and the placements are explicit:

  * `shard_batch`: each rank keeps its rows of every leading dimension
    (rank r of n holds rows [r*B/n, (r+1)*B/n));
  * `replicate`: every tensor broadcast from rank 0, in place;
  * `shard_params_fsdp`: a leaf of at least `min_size` elements is split along
    its largest axis that the mesh size divides (`fsdp_axis`, the JAX
    package's choice), the rank keeping its chunk; smaller leaves stay whole.

`initialize_distributed` joins the process group: a no-op for one process,
otherwise from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, ...) or
from explicit arguments. The helpers below the placements are what the
data-parallel sampler and train step use: the rank's rows, the rows gathered
back in rank order, and a mean over the ranks.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "dp"


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join the default process group; True if one is initialised afterwards.

    A no-op (False) for a single process: no arguments and no WORLD_SIZE in the
    environment. Otherwise `init_method` (default "env://", torchrun's),
    `world_size` and `rank` (default WORLD_SIZE and RANK) and `backend` (NCCL
    where CUDA is present, else gloo); with NCCL the process takes the card
    LOCAL_RANK (default: rank). Already initialised: nothing is done.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and world_size in (None, 1) and "WORLD_SIZE" not in env:
        return False
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def make_mesh(device_type: Optional[str] = None, axis_name: str = DATA_AXIS):
    """1-D data-parallel DeviceMesh over every process of the default group
    (device type "cuda" under NCCL, else "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def dp_part(mesh):
    """The data-parallel axis of a mesh: the mesh itself where it is 1-D, its 'dp'
    sub-mesh where it is ('dp', 'tp'); None for None."""
    if mesh is None or mesh.ndim == 1:
        return mesh
    return mesh[DATA_AXIS]


def data_parallel_spec(mesh, leading_dim: bool = True) -> list:
    """The DTensor placement of a data-parallel tensor on `mesh`: its leading
    dimension split over the mesh, or replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if leading_dim else Replicate()]


def rows_of(mesh, n_global: int) -> slice:
    """This rank's rows of a leading dimension of n_global (which the mesh size
    must divide: every rank holds the same number of rows)."""
    n = mesh.size()
    if n_global % n:
        raise ValueError(f"batch {n_global} not divisible by mesh size {n}")
    b = n_global // n
    r = mesh.get_local_rank()
    return slice(r * b, (r + 1) * b)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch: Any) -> Any:
    """Every tensor or ndarray leaf of at least one dimension cut to this rank's
    rows of its leading dimension; other leaves (strings, scalars) pass."""

    def put(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
            return x[rows_of(mesh, x.shape[0])]
        return x

    return _map(batch, put)


def replicate(mesh, tree: Any) -> Any:
    """Broadcast every tensor of `tree` (or every parameter and buffer of a
    module) from rank 0, in place; returns `tree`."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else [])

    def put(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        return x

    if not tensors:
        _map(tree, put)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return tree


def fsdp_axis(shape, n: int, min_size: int = 2**16) -> Optional[int]:
    """The axis a leaf of `shape` is split along over n ranks: the largest one n
    divides (the first of equals), or None for a leaf under min_size elements or
    with no such axis."""
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return None
    axes = [i for i, d in enumerate(shape) if d % n == 0]
    if not axes:
        return None
    return max(axes, key=lambda i: shape[i])


def shard_params_fsdp(mesh, tree: Any, min_size: int = 2**16) -> Any:
    """FSDP/ZeRO-style placement: each tensor leaf of at least `min_size`
    elements replaced by this rank's chunk along `fsdp_axis`; the rest stay
    whole. No path of the port shards its parameters (replicated, they fit on
    one card, as in the JAX package, where this is optional too)."""
    n, r = mesh.size(), mesh.get_local_rank()

    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        ax = fsdp_axis(tuple(x.shape), n, min_size)
        return x if ax is None else x.chunk(n, dim=ax)[r]

    return _map(tree, put)


def all_gather_rows(mesh, local: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-sized row blocks concatenated in rank order (on the
    backend's device: a CPU tensor goes to the card under NCCL and back)."""
    n = mesh.size()
    src_dev = local.device
    if dist.get_backend(mesh.get_group()) == "nccl" and src_dev.type != "cuda":
        local = local.to(torch.device("cuda", torch.cuda.current_device()))
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=mesh.get_group())
    return torch.cat(parts, dim=0).to(src_dev)


def all_reduce_mean_(mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The mean of `tensor` over the ranks, in place."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return tensor.div_(mesh.size())
