"""Offline generation: back-to-back batches through SamplePipeline.sample, as an
evaluation protocol draws its samples.

Set-up builds the model with the seed's weights in the cell's type and the
SamplePipeline, and captures the sampler step at the batch's shape. The window
runs batch after batch, each a full DDPM run with its own noise seed, under the
cell's type, float32 with TF32 off as the evaluation CLIs run (`device.float32_exact`).
The batch running when the window closes is finished, and the window's share of
it counts, by its steps at the pace it ran: samples/s = steps completed in the
window × batch ÷ the schedule's steps ÷ the window's seconds.

Traffic keys: precision, batch, guidance, frames, check ({requests, limit}).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.core import census, sampled, serving, timing
from benchmark.core.seeds import derive
from benchmark.core.trace import Slice


def _mode(tr):
    """float32 as the evaluation CLIs run it (TF32 off); a lower type as it is."""
    import contextlib

    from condmdi_tpu_torch.device import float32_exact

    return float32_exact() if tr["precision"] == "f32" else contextlib.nullcontext()


class Session:
    def __init__(self, run):
        self.run, self.tr, self.cfg = run, run.cell.traffic, run.cell.config

    def _inputs(self, k: int):
        """Batch k's text embeddings and noise seed, from the seed."""
        rng = np.random.default_rng(derive(self.run.seed, f"batch{k}"))
        text = rng.standard_normal((self.tr["batch"], 512)).astype(np.float32)
        return text, int(derive(self.run.seed, f"batch{k} noise") % 2**31)

    def _sample(self, k: int):
        cfg, tr, dev = self.cfg, self.tr, self.run.device
        text, noise_seed = self._inputs(k)
        gen = torch.Generator(device=dev).manual_seed(noise_seed)
        with _mode(tr):
            out = self.pipe.sample((tr["batch"], cfg["frames"], cfg["njoints"]),
                                   {"text_embed": torch.from_numpy(text).to(dev)},
                                   guidance_param=tr["guidance"], generator=gen)
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
        with _mode(tr):
            prog = self.pipe.program((tr["batch"], self.cfg["frames"], self.cfg["njoints"]),
                                     {"text_embed": torch.from_numpy(text).to(dev)},
                                     tr["guidance"])
            prog.warm()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        split[f"capture batch {tr['batch']}"] = time.perf_counter() - t

    def window(self):
        run, tr = self.run, self.tr
        trace = Slice() if run.trace else None
        self.outputs, ends = [], []
        t0 = time.perf_counter()
        end = t0 + run.seconds
        k = 0
        while True:
            if trace is not None and trace.t1 is None and not trace.running \
                    and time.perf_counter() - t0 >= run.seconds / 3.0:
                trace.start()
            self.outputs.append(self._sample(k))
            ends.append(time.perf_counter())
            if trace is not None and trace.running:
                trace.stop()
            k += 1
            if ends[-1] >= end:
                break
        starts = [t0] + ends[:-1]
        last = (end - starts[-1]) / (ends[-1] - starts[-1])
        batches = (k - 1) + max(0.0, min(1.0, last))
        steps_done = batches * self.steps
        run.attempted, run.failed = k * tr["batch"], 0
        run.e2e["samples_per_s"] = steps_done * tr["batch"] / self.steps / run.seconds
        run.obs["batches_in_window"] = batches
        if trace is not None and trace.summary is not None:
            run.obs["trace"] = trace.summary

    def probe(self):
        run, tr, cfg = self.run, self.tr, self.cfg
        rows = 2 * tr["batch"]
        prog = next(iter(self.pipe.programs.values()))
        graph = next(iter(prog.graphs.values()))
        with _mode(tr):
            ms = timing.replay_ms(lambda: graph(check=False), n=100)
            run.obs["step"] = {"device_ms": ms, "flops": serving.step_flops(cfg, rows),
                               "dtype": tr["precision"]}
            fwd = serving.census_forward(self.model, cfg, rows, run.device, False)
            calls = census.census(self.model, fwd)
            run.obs["calls"] = census.time_calls(calls, run.device, seed=run.seed % 2**31)

    def release(self):
        del self.pipe, self.model
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        run, tr = self.run, self.tr
        n = len(self.outputs) * tr["batch"]
        pick = serving.sample_of(n, tr["check"]["requests"], run.seed)
        placed = []
        for i in pick:
            k, row = divmod(i, tr["batch"])
            text, noise_seed = self._inputs(k)
            placed.append(sampled.Placed(noise_seed, tr["batch"], row, torch.from_numpy(text[row])))
        want = sampled.reference_motions(self.cfg, run.seed, tr["precision"], placed,
                                         tr["guidance"], run.device)
        got = torch.from_numpy(np.stack([self.outputs[i // tr["batch"]][i % tr["batch"]]
                                         for i in pick])).to(want.device)
        worst = float(sampled.rel_rms(got, want).max()) if pick else math.inf
        return [("motion_rel_rms_max", worst, tr["check"]["limit"])]
