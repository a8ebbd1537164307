"""Data-parallel sampling: each rank samples its rows of the batch.

Counterpart of condmdi_tpu/parallel/dp_sample.py. The JAX package runs the
whole denoising scan as one jitted program with the batch sharded over the
mesh's 'dp' axis; its counter-based RNG makes a draw the same however it is
sharded, so a data-parallel run reproduces the single-device samples. Here
every rank draws the global x_T [B, ...] and each step's global noise from a
generator seeded alike on every rank and keeps its rows, so a row gets the
noise it gets in a single-process run; the rank samples its B/n rows through
`pipe.sample` (on the card its `SamplingProgram` for the local shape is kept
and replayed from CUDA graphs, as the JAX package keeps its jitted function),
then `all_gather` puts the [B, ...] result together, the same on every rank.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from condmdi_tpu_torch.parallel.mesh import all_gather_rows, rows_of


def shard_sample_inputs(mesh, batch_size: int, tree: Any) -> Any:
    """Every tensor leaf whose leading dimension is the batch cut to this rank's
    rows; other leaves (None included) pass."""
    rows = rows_of(mesh, batch_size)

    def put(x):
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == batch_size:
            return x[rows]
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return x

    return put(tree)


class _RowNoise:
    """Step i's noise: the global [B, ...] draw from `generator`, made when step i
    asks for it (the order a single-process run draws in), cut to `rows`."""

    def __init__(self, generator, shape, rows, device):
        self.generator, self.shape, self.rows, self.device = generator, shape, rows, device

    def __getitem__(self, i):
        return torch.randn(self.shape, generator=self.generator, device=self.device)[self.rows]


def dp_sample(pipe, mesh, shape: tuple[int, ...], y: dict[str, Any],
              guidance_param: float = 1.0, obs_x0: Optional[torch.Tensor] = None,
              obs_mask: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
              inpaint=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """pipe.sample over the batch (global `shape`, global inputs) with the rows
    split over the mesh; returns the [B, ...] samples on every rank.

    `noise` is the global x_T where given; otherwise x_T and every step's noise
    are drawn globally from `generator` (seeded alike on every rank). Marginal
    imputation draws a second noise per step from the generator inside the
    sampler, at the local shape, so it is refused here.
    """
    B = shape[0]
    if B % mesh.size():
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size()}")
    if inpaint is not None and inpaint.imputate and inpaint.replacement_distribution == "marginal":
        raise NotImplementedError("dp_sample: marginal imputation draws its noise at the "
                                  "local shape; run it on one process")
    rows = rows_of(mesh, B)
    local = (rows.stop - rows.start,) + tuple(shape[1:])
    dev = pipe.device
    if noise is None:
        noise = torch.randn(tuple(shape), generator=generator, device=dev)
    step_noise = _RowNoise(generator, tuple(shape), rows, dev)
    y, obs_x0, obs_mask, noise = shard_sample_inputs(mesh, B, (y, obs_x0, obs_mask, noise))
    if inpaint is not None:
        from dataclasses import replace

        inpaint = replace(inpaint,
                          inpainted_motion=inpaint.inpainted_motion[rows],
                          inpainting_mask=inpaint.inpainting_mask[rows])
    sample = pipe.sample(local, y, guidance_param, obs_x0=obs_x0, obs_mask=obs_mask,
                         inpaint=inpaint, noise=noise, step_noise=step_noise)
    return all_gather_rows(mesh, sample)
