"""The profiler's view of a short steady slice of the window.

`Slice` runs `torch.profiler` (CPU and CUDA activities) around part of a run
and reduces its trace to: the seconds in which a kernel, copy or set ran on
the device (the union of their intervals), the slice's length on the host's
clock, the device operations that took most time, and the longest gaps with
nothing on the device, each named by the innermost host operation open at
its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


class Slice:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = summarize(events, self.t1 - self.t0)

    @property
    def running(self) -> bool:
        return self.prof is not None


def _union(intervals):
    total, end, merged = 0.0, None, []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def summarize(events, window_s: float, top: int = 10) -> dict:
    dev, host, by_name = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, a + d))
            name = e.get("name", "?")[:160]
            by_name[name] = by_name.get(name, 0.0) + d * 1e-6
        elif e.get("cat") in HOST_CATS:
            host.append((a, a + d, e.get("name", "?")[:160]))
    busy_us, merged = _union(dev)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        open_ops = [h for h in host if h[0] <= mid <= h[1]]
        label = min(open_ops, key=lambda h: h[1] - h[0])[2] if open_ops else "no host operation"
        named.append([label, (g1 - g0) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "kernels": len(dev),
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
