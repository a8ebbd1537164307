"""The arithmetic of the per-layer metrics, over what a run observed (`run.obs`).
Each returns None where the run found nothing to read; a share of a peak or of a
roofline is never reported as 0 for want of a reading."""

from __future__ import annotations

from benchmark.core import census, stats
from benchmark.counts.peaks import PEAK_FLOPS


def latency_p50(obs):
    lat = obs.get("latencies")
    return stats.median(lat) if lat else None


def batch_fill(obs):
    """Mean requests a batch over max_batch, in percent."""
    b = obs.get("batches")
    if not b:
        return None
    return 100.0 * sum(n for n, _ in b) / len(b) / obs["max_batch"]


def step_ms(obs):
    step = obs.get("step")
    return step["device_ms"] if step else None


def mfu(obs):
    """The step's model FLOPs over its device time, as a share of the peak of the
    configuration's stated type, in percent."""
    step = obs.get("step")
    if not step or step["device_ms"] <= 0:
        return None
    return 100.0 * step["flops"] / (step["device_ms"] * 1e-3) / PEAK_FLOPS[step["dtype"]]


def roofline(obs, kernel):
    calls = obs.get("calls")
    return census.roofline(calls, kernel) if calls else None


def idle(obs):
    """The share of the traced slice with nothing running on the device, in percent."""
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
