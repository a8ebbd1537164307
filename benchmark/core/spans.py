"""The per-layer metrics that read the program's own spans
(`condmdi_tpu_torch.utils.tracing`), kept in memory by the process that ran the
cell. Each returns None where the program records none (a tree without the
recorder).

The window's records are found without the drivers' help: the window's requests
are the first len(obs["latencies"]) requests the process's server received
(set-up's warm-ups submit none, and the traced slice comes after the window),
its batches the first len(obs["batches"]) batches it closed. The server is the
newest one in the process, the one the cell built."""

from __future__ import annotations

import math

from benchmark.core import stats


def _spans():
    try:
        from condmdi_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def _served(obs):
    """The newest server's server.queue spans by request, server.gather and
    server.batch spans by batch, and sampler.run spans by their batch span's id;
    or None."""
    spans = _spans()
    if not spans or not obs.get("latencies"):
        return None
    names = ("server.queue", "server.gather", "server.batch")
    mine = [s for s in spans if s.name in names]
    if not mine:
        return None
    server = max(s.attrs["server"] for s in mine)
    by = {name: {} for name in names}
    for s in mine:
        if s.attrs["server"] == server:
            by[s.name][s.attrs["req" if s.name == "server.queue" else "batch"]] = s
    batch_ids = {s.id for s in by["server.batch"].values()}
    by["sampler.run"] = {s.parent: s for s in spans
                         if s.name == "sampler.run" and s.parent in batch_ids}
    return by


def queue_wait_p90_s(obs):
    """p90 over the window's requests of server.queue, seconds; a request never
    taken into a batch counts as infinitely long."""
    by = _served(obs)
    if by is None:
        return None
    queues = by["server.queue"]
    return stats.percentile([queues[i].seconds if i in queues else math.inf
                             for i in range(len(obs["latencies"]))], 90.0)


def service_p50_s(obs):
    """Median over the window's requests of their batch's server.batch, seconds.

    It depends on the seed where the window's batches fall into two buckets
    about equally often: in mdm.serve_text the median request rides a bucket-16
    batch (~1.1 s) on some seeds and a bucket-32 one (~2.0 s) on others, so the
    reading swings by 2x with no change to the program. Read it beside
    server.batch_fill; a change that only shifts the bucket mix moves it."""
    by = _served(obs)
    if by is None:
        return None
    queues, batches = by["server.queue"], by["server.batch"]
    times = [batches[queues[i].attrs["batch"]].seconds for i in range(len(obs["latencies"]))
             if i in queues and queues[i].attrs["batch"] in batches]
    return stats.median(times) if times else None


def batch_gap_ms(obs):
    """Median, over the window's batches that found a request already waiting when
    the previous batch ended, of the time from the previous batch's last result
    to this batch's sampler.run start (server.gather and server.load), ms."""
    by = _served(obs)
    if by is None or not obs.get("batches"):
        return None
    batches, gathers, runs = by["server.batch"], by["server.gather"], by["sampler.run"]
    gaps = []
    for j in range(1, len(obs["batches"])):
        prev, cur, g = batches.get(j - 1), batches.get(j), gathers.get(j)
        if prev is None or cur is None or g is None or g.attrs["queued"] < 1 \
                or cur.id not in runs:
            continue
        gaps.append((runs[cur.id].start_ns - prev.end_ns) * 1e-6)
    return stats.median(gaps) if gaps else None


def host_draw_ms(obs):
    """Median of train.host_draw over the process's steps after its first (the
    eager first step of the buffered step), ms. These are every step the process
    ran, the set-up's check steps included, not only the window's: the draw
    does not depend on which step it is."""
    spans = _spans()
    if not spans:
        return None
    draws = [s.seconds * 1e3 for s in spans if s.name == "train.host_draw"][1:]
    return stats.median(draws) if draws else None
