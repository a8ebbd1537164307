"""Offline generation as `offline_batch` runs it, with three additions: keyframes,
the DiT's self-attention in the census, and the attention op's route counts.

The window, the samples/s and the comparison are `offline_batch.Session`'s;
this driver adds, by traffic key and by what the program has:

  * keyframes = [lo, hi]: each request of a batch gets lo..hi distinct observed
    frames, every feature observed, drawn from the seed as `serving.requests`
    draws them (the counts the same multiset for every seed); they go to the
    captured program, to every batch of the window and to the reference.
  * The census also finds the DiT's self-attention: a forward pre-hook on
    `models.dit._Attn` records its [B, S, D] input under the key `census` gives
    an encoder layer's, so `census.time_calls` times it through the op's public
    entry as it times MDM's.
  * The self-attention calls by route, `ops.attention.fused_self_attention.routes`
    (eager calls and a capture's calls, not replays), are read at the window's
    end into obs["attention_routes"]; a program without the counter leaves
    nothing there.

With --trace 1 the profiler's slice spans the boundary between two batches, so
that what the host does between them (the copy of the samples back, seeding the
next batch's noise, entering `SamplePipeline.sample`) lies inside it, as in
`offline_batch`'s whole-batch slice, while the trace stays a few hundred
thousand events at most: n = max(2, steps // 10) sampler steps (100 of the
1000-step schedule), the last n // 2 of the first batch whose step
steps - n // 2 comes after a third of the window has passed, and the first
n - n // 2 of the next. Where that batch is the window's last, the slice
closes with the window. One boundary in n steps weighs the host's gap more
than a whole batch's slice does (one in `steps`).

Traffic keys: offline_batch's, keyframes (or null).
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.core import census, sampled, serving, spec, timing
from benchmark.core.seeds import derive
from benchmark.core.trace import Slice

_base = spec.driver("offline_batch", Path(__file__).resolve().parent.parent)


def attention_census(model, forward) -> list:
    """`census.census` over `forward()`, with the DiT's self-attention calls too."""
    from condmdi_tpu_torch.models.dit import _Attn

    calls: dict = {}

    def attn(mod, args, kwargs):
        x = args[0]
        key = (x.shape[0], x.shape[1], x.shape[2], mod.num_heads, census.DT[x.dtype],
               x.requires_grad)
        calls.setdefault(("attention", key), census.Call("attention", key)).count += 1

    handles = [m.register_forward_pre_hook(attn, with_kwargs=True)
               for m in model.modules() if isinstance(m, _Attn)]
    try:
        found = census.census(model, forward)
    finally:
        for h in handles:
            h.remove()
    return found + list(calls.values())


def route_counts():
    """The attention op's calls by route, or None where the program has no counter."""
    from condmdi_tpu_torch.ops.attention import fused_self_attention

    routes = getattr(fused_self_attention, "routes", None)
    return None if routes is None else dict(routes)


class BoundarySlice:
    """`trace` opened before step steps - n // 2 of a batch, once `ready()`, and
    closed after n sampler steps, in the next batch: each graph of `program`
    wrapped in a step counter while the context is open; `batch()` marks a
    batch's first step."""

    def __init__(self, program, steps: int, trace: Slice, ready):
        self.program, self.steps, self.trace, self.ready = program, steps, trace, ready
        self.n = max(2, steps // 10)
        self.step, self.left = 0, 0

    def batch(self):
        self.step = 0

    def _wrap(self, graph):
        def replay(check=True):
            trace = self.trace
            if trace.t1 is None and not trace.running \
                    and self.step == self.steps - self.n // 2 and self.ready():
                trace.start()
                self.left = self.n
            out = graph(check=check)
            self.step += 1
            if trace.running:
                self.left -= 1
                if self.left == 0:
                    trace.stop()
            return out
        return replay

    def __enter__(self):
        self.held = dict(self.program.graphs)
        self.program.graphs.update({b: self._wrap(g) for b, g in self.held.items()})
        return self

    def __exit__(self, *exc):
        self.program.graphs.update(self.held)
        if self.trace.running:
            self.trace.stop()


class Session(_base.Session):
    def _keyframes(self, k: int):
        """Batch k's observed frames and values, [batch, frames, F] each, or (None, None)."""
        kf = self.tr.get("keyframes")
        if not kf:
            return None, None
        reqs = serving.requests(self.tr["batch"], self.cfg["frames"], self.cfg["njoints"],
                                derive(self.run.seed, f"batch{k} keyframes"), kf)
        return (np.stack([r["obs_x0"] for r in reqs]), np.stack([r["obs_mask"] for r in reqs]))

    def _obs(self, k: int) -> dict:
        obs_x0, obs_mask = self._keyframes(k)
        if obs_x0 is None:
            return {}
        dev = self.run.device
        return {"obs_x0": torch.from_numpy(obs_x0).to(dev),
                "obs_mask": torch.from_numpy(obs_mask).to(dev)}

    def _program(self):
        return next(iter(self.pipe.programs.values()))

    def _sample(self, k: int):
        cfg, tr, dev = self.cfg, self.tr, self.run.device
        text, noise_seed = self._inputs(k)
        gen = torch.Generator(device=dev).manual_seed(noise_seed)
        if self._slice is not None:
            self._slice.batch()
        with _base._mode(tr):
            out = self.pipe.sample((tr["batch"], cfg["frames"], cfg["njoints"]),
                                   {"text_embed": torch.from_numpy(text).to(dev)},
                                   guidance_param=tr["guidance"], generator=gen, **self._obs(k))
        return out.float().cpu().numpy()

    def setup(self):
        tr, dev = self.tr, self.run.device
        split = self.run.obs.setdefault("setup_split", {})
        t = time.perf_counter()
        self.model, self.pipe = serving.build(self.run, tr["precision"])
        split["model and weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self.steps = self.pipe.sched.num_timesteps
        text, _ = self._inputs(-1)
        with _base._mode(tr):
            prog = self.pipe.program((tr["batch"], self.cfg["frames"], self.cfg["njoints"]),
                                     {"text_embed": torch.from_numpy(text).to(dev)},
                                     tr["guidance"], **self._obs(-1))
            prog.warm()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        split[f"capture batch {tr['batch']}"] = time.perf_counter() - t

    def window(self):
        """offline_batch's window, the profiler's slice taken over a batch
        boundary (`BoundarySlice`) in place of a whole batch."""
        run, t0 = self.run, time.perf_counter()
        trace = Slice() if run.trace else None
        self._slice = None if trace is None else BoundarySlice(
            self._program(), self.steps, trace,
            lambda: time.perf_counter() - t0 >= run.seconds / 3.0)
        traced, run.trace = run.trace, False  # the base window takes no slice of its own
        try:
            with self._slice or contextlib.nullcontext():
                super().window()
        finally:
            run.trace = traced
        if trace is not None and trace.summary is not None:
            run.obs["trace"] = trace.summary
        routes = route_counts()
        if routes is not None:
            run.obs["attention_routes"] = routes

    def probe(self):
        run, tr, cfg = self.run, self.tr, self.cfg
        rows = 2 * tr["batch"]
        graph = next(iter(self._program().graphs.values()))
        with _base._mode(tr):
            ms = timing.replay_ms(lambda: graph(check=False), n=100)
            run.obs["step"] = {"device_ms": ms, "flops": serving.step_flops(cfg, rows),
                               "dtype": tr["precision"]}
            fwd = serving.census_forward(self.model, cfg, rows, run.device,
                                         bool(tr.get("keyframes")))
            calls = attention_census(self.model, fwd)
            run.obs["calls"] = census.time_calls(calls, run.device, seed=run.seed % 2**31)

    def check(self):
        run, tr = self.run, self.tr
        n = len(self.outputs) * tr["batch"]
        pick = serving.sample_of(n, tr["check"]["requests"], run.seed)
        placed = []
        for i in pick:
            k, row = divmod(i, tr["batch"])
            text, noise_seed = self._inputs(k)
            obs_x0, obs_mask = self._keyframes(k)
            placed.append(sampled.Placed(
                noise_seed, tr["batch"], row, torch.from_numpy(text[row]),
                None if obs_x0 is None else torch.from_numpy(obs_x0[row]),
                None if obs_mask is None else torch.from_numpy(obs_mask[row])))
        want = sampled.reference_motions(self.cfg, run.seed, tr["precision"], placed,
                                         tr["guidance"], run.device)
        got = torch.from_numpy(np.stack([self.outputs[i // tr["batch"]][i % tr["batch"]]
                                         for i in pick])).to(want.device)
        worst = float(sampled.rel_rms(got, want).max()) if pick else math.inf
        return [("motion_rel_rms_max", worst, tr["check"]["limit"])]
