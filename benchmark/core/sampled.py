"""The reference's answer for served or sampled requests, and the comparison.

A request's answer is its motion after the 1000-step DDPM. The program drew
that run's noise from a `torch.Generator` on the card seeded per batch (the
batch's first request's seed in MotionServer, the batch's own in the offline
driver): x_T, then one draw a step, each at the batch's full (bucket) shape.
The reference draws the same from the same seed and takes each request's row,
so that it follows the same noise; it shares nothing else with the program.
Each request is compared by the relative rms of its motion against the
reference's, and a run by the largest over the sample.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.core import program
from benchmark.reference.diffusion import Schedule, ddpm_sample
from benchmark.reference.precision import Precision


@dataclass
class Placed:
    """Where one request ran: its batch's noise seed, bucket and row."""

    noise_seed: int
    bucket: int
    row: int
    text: torch.Tensor                    # [512]
    obs_x0: torch.Tensor | None = None    # [T, F]
    obs_mask: torch.Tensor | None = None  # [T, F] bool


class _RowNoise:
    """Each batch's stream drawn as the program draws it, the sample's rows taken."""

    def __init__(self, placed: list[Placed], shape_tf, device):
        self.streams = {}
        for p in placed:
            key = (p.noise_seed, p.bucket)
            if key not in self.streams:
                self.streams[key] = torch.Generator(device=device).manual_seed(p.noise_seed)
        self.placed, self.shape_tf, self.device = placed, tuple(shape_tf), device

    def draw(self):
        batch = {key: torch.randn((key[1],) + self.shape_tf, generator=g, device=self.device)
                 for key, g in self.streams.items()}
        return torch.stack([batch[(p.noise_seed, p.bucket)][p.row] for p in self.placed])


@torch.no_grad()
def reference_motions(config: dict, seed: int, dtype: str, placed: list[Placed], guidance: float,
                      device, precision: str = "f32", block: int = 16) -> torch.Tensor:
    """The reference's motions for `placed`, [k, frames, F], computed `block`
    requests at a time."""
    prec = Precision(precision)
    w = program.make_weights(config, seed, device, dtype)
    ref = program.reference_module(config).Model(w, config, prec)
    del w
    sched = Schedule(config["diffusion_steps"], device)
    shape_tf = (config["frames"], config["njoints"])
    outs = []
    with prec.products():
        for lo in range(0, len(placed), block):
            part = placed[lo:lo + block]
            noise = _RowNoise(part, shape_tf, device)
            x_T = noise.draw()
            zs = [noise.draw() for _ in range(sched.steps)]
            text = torch.stack([p.text for p in part]).to(device)
            obs = {}
            if part[0].obs_x0 is not None:
                obs = {"obs_x0": torch.stack([p.obs_x0 for p in part]).to(device),
                       "obs_mask": torch.stack([p.obs_mask for p in part]).to(device)}
            outs.append(ddpm_sample(ref, sched, x_T, zs.__getitem__, text, guidance, **obs))
            del zs
    return torch.cat(outs)


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per request: rms(got − want) / rms(want)."""
    d = (got.float() - want.float()).flatten(1)
    return d.pow(2).mean(1).sqrt() / want.float().flatten(1).pow(2).mean(1).sqrt()
