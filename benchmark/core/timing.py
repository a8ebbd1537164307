"""Device time of a call on the card, by CUDA events behind a spin kernel.

The method of the port's chip_smoke.py (`timed_ms`), copied so the yardstick
stays put: the calls cycle through input sets that together exceed the 50 MB
L2 (weights arrive cold, as in a forward), and each repeat starts behind a
spin kernel longer than the host takes to enqueue the calls, so the host's
time between launches is not counted. The result is the median over repeats
of the mean time a call.
"""

from __future__ import annotations

import statistics
import time

import torch

L2_BYTES = 50 * 2**20


def sets_past_l2(bytes_per_set: int, least: int = 2) -> int:
    """How many input sets make twice the L2."""
    return max(least, -(-2 * L2_BYTES // max(bytes_per_set, 1)))


def device_ms(fn, inputs, reps: int = 5, iters: int = 10) -> float:
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4e9 * host_s) + 2_000_000  # twice the host's time at up to 2 GHz
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        e0.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def replay_ms(replay, n: int = 100, reps: int = 3) -> float:
    """Device ms per call of `replay` (a captured graph's replay), `n` back to back
    behind a spin kernel, the median over `reps`."""
    return device_ms(lambda: replay(), [()], reps=reps, iters=n)
