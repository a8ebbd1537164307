"""The readers of the program's spans (benchmark/core/spans.py) on tiny serving and
training cells on the CPU: each returns a finite number after a window, and the
spans account for the latency the harness measured."""

from __future__ import annotations

import math

import pytest
import torch

from bench_tiny import bench, tree

from benchmark import run as bench_run
from benchmark.core import spec, stats

SERVED = ["server.queue_wait_p90_s", "server.service_p50_s", "server.batch_gap_ms"]


def window(root, name: str, seed: int = 2**31 + 11):
    """Set-up, window and release of a tiny cell, as a run makes them; its obs."""
    cell = spec.load_cell(bench(), name, root)
    run = bench_run.Run(cell, seed, 2.0, False, torch.device("cpu"))
    session = spec.driver(cell.traffic["driver"], root).Session(run)
    session.setup()
    session.window()
    session.release()
    return run.obs


@pytest.mark.parametrize("cell", ["tiny.serve_kf", "tiny.serve_text"])
def test_served_readers_read_the_window(tmp_path, cell):
    from condmdi_tpu_torch.utils import tracing

    root = tree(tmp_path)
    obs = window(root, cell)
    values = {m: spec.reader(m, root).read(obs) for m in SERVED}
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in values.values()), values
    # the program's queue wait plus its batch's time to the request's result against
    # the harness's latency from the scheduled send, request by request
    server = max(s.attrs["server"] for s in tracing.spans("server.request"))

    def of(name, key):
        return {s.attrs[key]: s for s in tracing.spans(name) if s.attrs["server"] == server}

    requests, queues = of("server.request", "req"), of("server.queue", "req")
    batches = of("server.batch", "batch")
    gaps = []
    for i, lat in enumerate(obs["latencies"]):
        q, r = queues[i], requests[i]
        own = q.seconds + (r.end_ns - batches[q.attrs["batch"]].start_ns) * 1e-9
        gaps.append(abs(lat - own))
    assert stats.median(gaps) < 0.010, gaps


def test_the_host_draw_reader_reads_the_steps(tmp_path):
    root = tree(tmp_path)
    value = spec.reader("train.host_draw_ms", root).read(window(root, "tiny.train"))
    assert value is not None and math.isfinite(value) and value > 0


def test_readers_find_nothing_without_spans(tmp_path, monkeypatch):
    """A program that records no spans (as a tree without the recorder): each
    reader returns None and does not raise."""
    from benchmark.core import spans

    monkeypatch.setattr(spans, "_spans", lambda: [])
    obs = {"latencies": [1.0, 2.0], "batches": [(2, 2)]}
    for m in SERVED + ["train.host_draw_ms"]:
        assert spec.reader(m).read(obs) is None
