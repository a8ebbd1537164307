"""What the sampling drivers share: the served model's apply_fn, the sampling
pipeline, and the requests a traffic file describes, drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import program
from benchmark.core.seeds import derive


def pipeline(model, sched, dcfg, device, keyframes: bool):
    """SamplePipeline over the model, the sampler's math in float32 and the model in
    its own type (the port's serving layout: models/cfg.py doubles the batch)."""
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    dtype = next(model.parameters()).dtype
    if keyframes:
        def apply_fn(x, t, y, **obs):
            return model(x.to(dtype), t, y, **obs).float()
    else:
        def apply_fn(x, t, y, **_obs):  # a text model takes no keyframes
            return model(x.to(dtype), t, y).float()
    return SamplePipeline(apply_fn, sched, dcfg, SamplerConfig(method="ddpm"), device=device)


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Send times in [0, seconds): a Poisson process's gaps at rate `rate`, made
    as the same set of gaps for every seed (the exponential's quantiles at
    (i + ½)/n, n = rate·seconds), in an order drawn from the seed, scaled to
    fill the window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(derive(seed, "arrivals")).permutation(gaps)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def requests(n: int, frames: int, feats: int, seed: int, keyframes=None) -> list[dict]:
    """n requests: a text embedding N(0, 1) at CLIP's width each and, with
    `keyframes` = [lo, hi], lo..hi distinct observed frames (every feature), the
    counts the same multiset for every seed, values N(0, 1); a noise seed each."""
    rng = np.random.default_rng(derive(seed, "requests"))
    counts = None
    if keyframes:
        lo, hi = keyframes
        counts = rng.permutation([lo + i % (hi - lo + 1) for i in range(n)])
    out = []
    for i in range(n):
        r = {"text": rng.standard_normal(512).astype(np.float32),
             "noise_seed": int(derive(seed, f"request{i}") % 2**31)}
        if counts is not None:
            mask = np.zeros((frames, feats), bool)
            mask[rng.choice(frames, int(counts[i]), replace=False)] = True
            r["obs_x0"] = rng.standard_normal((frames, feats)).astype(np.float32)
            r["obs_mask"] = mask
        out.append(r)
    return out


def sample_of(n_done: int, k: int, seed: int) -> list[int]:
    """k of the finished requests' indices, drawn from the seed."""
    rng = np.random.default_rng(derive(seed, "check sample"))
    return sorted(int(i) for i in rng.choice(n_done, min(k, n_done), replace=False))


def buckets(max_batch: int) -> tuple[int, ...]:
    """Every bucket MotionServer can form up to max_batch: powers of two, and max_batch."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return tuple(out + [max_batch])


def build(run, dtype: str):
    cfg = run.cell.config
    model, sched, dcfg, _ = program.build(cfg, run.seed, run.device, dtype)
    keyframes = bool(run.cell.traffic.get("keyframes"))
    return model, pipeline(model, sched, dcfg, run.device, keyframes)


def step_flops(cfg: dict, rows: int) -> float:
    from benchmark.counts import models

    return models.forward(cfg, rows, cfg["frames"])


@torch.no_grad()
def census_forward(model, cfg, rows: int, device, keyframes: bool):
    """A forward of the model at `rows` (the CFG-doubled batch) for the census."""
    dtype = next(model.parameters()).dtype
    T, F = cfg["frames"], cfg["njoints"]
    x = torch.randn((rows, T, F), device=device).to(dtype)
    t = torch.full((rows,), 500, device=device)
    y = {"text_embed": torch.randn((rows, 512), device=device),
         "uncond": torch.arange(rows, device=device) >= rows // 2}
    kw = {}
    if keyframes:
        kw = {"obs_x0": torch.randn((rows, T, F), device=device),
              "obs_mask": torch.rand((rows, T, F), device=device) < 0.05}
    return lambda: model(x, t, y, **kw)
