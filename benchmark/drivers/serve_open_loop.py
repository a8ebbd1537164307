"""Open-loop serving: requests sent to MotionServer on a fixed Poisson schedule.

Set-up builds the model with the seed's weights in the cell's type, the
SamplePipeline and the MotionServer (`max_batch`, `max_wait_ms`, CFG), and
captures the sampler step of every bucket the server can form. The window is
the sending window: each request is submitted at its scheduled time whatever
the server is doing; every request sent in it is then drained, and counts.
A request's latency runs from its scheduled send to its result on the host; a
request that fails or never comes counts as infinitely late.

Traffic keys: precision, rate_per_s, max_batch, max_wait_ms, guidance, frames,
keyframes ([lo, hi] observed frames a request, or null for text only),
drain_s, trace_slice_s (the traced run's slice, after the window), check
({requests, limit}).
"""

from __future__ import annotations

import gc
import math
import queue
import threading
import time

import numpy as np
import torch

from benchmark.core import census, sampled, serving, stats, timing
from benchmark.core.trace import Slice


class Session:
    def __init__(self, run):
        self.run = run
        self.tr = run.cell.traffic
        self.cfg = run.cell.config

    # ------------------------------------------------------------------ set-up
    def setup(self):
        from condmdi_tpu_torch.serving import MotionServer

        tr, cfg = self.tr, self.cfg
        split = self.run.obs.setdefault("setup_split", {})
        t = time.perf_counter()
        self.model, self.pipe = serving.build(self.run, tr["precision"])
        split["model and weights"] = time.perf_counter() - t
        self.server = MotionServer(self.pipe, cfg["frames"], cfg["njoints"],
                                   max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
                                   guidance_param=tr["guidance"])
        for b in serving.buckets(tr["max_batch"]):  # each bucket's graph captured
            t = time.perf_counter()
            self.server.warmup(buckets=(b,))
            split[f"capture bucket {b}"] = time.perf_counter() - t
        self.times = serving.arrivals(tr["rate_per_s"], self.run.seconds, self.run.seed)
        self.reqs = serving.requests(len(self.times), cfg["frames"], cfg["njoints"],
                                     self.run.seed, tr.get("keyframes"))
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    # ------------------------------------------------------------------ window
    def _serve(self, times, reqs, seconds: float):
        """Submit `reqs` at `times` (seconds from now) whatever the server is doing,
        keep sending until `seconds` have passed, then drain for up to `drain_s`.
        Returns each request's (latency from its scheduled send, output) and how
        late the sender ran at worst."""
        from condmdi_tpu_torch.serving import MotionRequest

        n = len(reqs)
        sent, done_at, outputs = [None] * n, [math.inf] * n, [None] * n
        pending: "queue.Queue[int]" = queue.Queue()
        drain_until = [math.inf]

        def wait_results():
            for _ in range(n):
                i = pending.get()
                while True:
                    try:
                        out = sent[i].result(timeout=0.5)
                    except TimeoutError:
                        if time.perf_counter() > drain_until[0]:
                            break
                        continue
                    except RuntimeError:  # the server's error for this request's batch
                        break
                    done_at[i] = time.perf_counter()
                    outputs[i] = out
                    break

        waiter = threading.Thread(target=wait_results, daemon=True)
        waiter.start()
        t0, late = time.perf_counter(), 0.0
        for i, (at, r) in enumerate(zip(times, reqs)):
            now = time.perf_counter() - t0
            if at > now:
                time.sleep(at - now)
            late = max(late, time.perf_counter() - t0 - at)
            kw = {"obs_x0": r["obs_x0"], "obs_mask": r["obs_mask"]} if "obs_x0" in r else {}
            sent[i] = self.server.submit(
                MotionRequest(text_embed=r["text"], seed=r["noise_seed"], **kw))
            pending.put(i)
        end = t0 + seconds
        while time.perf_counter() < end:
            time.sleep(min(0.05, end - time.perf_counter()))
        drain_until[0] = end + self.tr["drain_s"]
        waiter.join(timeout=self.tr["drain_s"] + 5)
        return [d - (t0 + a) for d, a in zip(done_at, times)], outputs, late

    def window(self):
        run, tr = self.run, self.tr
        lat, self.outputs, late = self._serve(self.times, self.reqs, run.seconds)
        run.attempted, run.failed = len(lat), sum(1 for v in lat if math.isinf(v))
        run.e2e["latency_p90_s"] = stats.percentile(lat, 90.0)
        run.obs.update({"latencies": lat, "batches": list(self.server.batches),
                        "max_batch": tr["max_batch"], "sender_late_max_s": late})
        self.batches_window = list(self.server.batches)
        if run.trace:
            self._traced_slice()

    def _traced_slice(self):
        """A short slice of the same traffic under the profiler, after the window:
        the profiler starts and stops while the server is idle (starting it while
        another thread replays graphs hung the process on the card), so the slice
        runs from an empty server through `trace_slice_s` of arrivals to the last
        result."""
        run, tr, cfg = self.run, self.tr, self.cfg
        times = serving.arrivals(tr["rate_per_s"], tr["trace_slice_s"], run.seed + 1)
        reqs = serving.requests(len(times), cfg["frames"], cfg["njoints"], run.seed + 1,
                                tr.get("keyframes"))
        slice_ = Slice()
        slice_.start()
        self._serve(times, reqs, tr["trace_slice_s"])
        slice_.stop()
        run.obs["trace"] = slice_.summary

    # ------------------------------------------------------------------ per-layer probes
    def probe(self):
        run, tr, cfg = self.run, self.tr, self.cfg
        rows = 2 * tr["max_batch"]  # CFG doubles the batch
        prog = next(p for p in self.pipe.programs.values() if p.shape[0] == tr["max_batch"])
        graph = next(iter(prog.graphs.values()))
        step_ms = timing.replay_ms(lambda: graph(check=False), n=100)
        run.obs["step"] = {"device_ms": step_ms, "flops": serving.step_flops(cfg, rows),
                           "dtype": tr["precision"]}
        fwd = serving.census_forward(self.model, cfg, rows, run.device, bool(tr.get("keyframes")))
        calls = census.census(self.model, fwd)
        run.obs["calls"] = census.time_calls(calls, run.device, seed=run.seed % 2**31)

    # ------------------------------------------------------------------ release and check
    def release(self):
        self.server.shutdown()
        del self.server, self.pipe, self.model
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def placed(self) -> list[sampled.Placed]:
        """Where each request ran: MotionServer takes requests in the order they were
        sent, so batch j holds the next n_j of them; its noise is seeded with its
        first request's seed, at its bucket's shape."""
        out, i = [], 0
        for n_j, bucket in self.batches_window:
            first = self.reqs[i]["noise_seed"]
            for row in range(n_j):
                r = self.reqs[i + row]
                out.append(sampled.Placed(
                    first, bucket, row, torch.from_numpy(r["text"]),
                    torch.from_numpy(r["obs_x0"]) if "obs_x0" in r else None,
                    torch.from_numpy(r["obs_mask"]) if "obs_mask" in r else None))
            i += n_j
        return out

    def check(self) -> list[tuple[str, float, float]]:
        run, tr = self.run, self.tr
        done = [i for i, o in enumerate(self.outputs) if o is not None]
        missing = len(self.reqs) - len(done)
        placed = self.placed()
        pick = [done[j] for j in serving.sample_of(len(done), tr["check"]["requests"], run.seed)]
        worst = math.inf
        if pick and len(placed) == len(self.reqs):
            want = sampled.reference_motions(self.cfg, run.seed, tr["precision"],
                                             [placed[i] for i in pick], tr["guidance"],
                                             run.device)
            got = torch.from_numpy(np.stack([self.outputs[i] for i in pick])).to(want.device)
            worst = float(sampled.rel_rms(got, want).max())
        return [("requests_missing", float(missing), 0.0),
                ("motion_rel_rms_max", worst, tr["check"]["limit"])]
