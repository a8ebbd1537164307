"""The port's span recorder (condmdi_tpu_torch/utils/tracing.py) on the CPU: spans
nest and share trace ids, the ring stays bounded, threads record without losing
any, the export lines up with torch.profiler's timeline, and the spans that
MotionServer, CudaGraph and the train step record account for what they time."""

import contextlib
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from condmdi_tpu_torch.diffusion import (
    DiffusionConfig,
    DiffusionSchedule,
    SamplerConfig,
    get_named_beta_schedule,
)
from condmdi_tpu_torch.models.unet import MDM_UNET
from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
from condmdi_tpu_torch.serving import MotionRequest, MotionServer
from condmdi_tpu_torch.utils import cuda_graph, tracing

T, F = 28, 263


@pytest.fixture
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def test_spans_nest_and_share_trace_ids():
    rec = tracing.Recorder()
    with rec.span("a", k=1) as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
        late = rec.begin("d", parent=b, start_ns=a.start_ns)
    rec.end(late, end_ns=a.start_ns + 5)
    with rec.span("e") as e:
        pass
    assert [s.name for s in rec.spans()] == ["c", "b", "a", "d", "e"]
    assert a.parent is None and a.trace == a.id and a.attrs == {"k": 1}
    assert (b.parent, c.parent, late.parent) == (a.id, b.id, b.id)
    assert a.trace == b.trace == c.trace == late.trace != e.trace == e.id
    assert late.end_ns - late.start_ns == 5
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    assert rec.spans("b") == [b]


def test_ring_stays_bounded_and_switches_off():
    """The ring keeps the newest spans; a paused thread records none, another
    thread records meanwhile."""
    rec = tracing.Recorder(capacity=8)
    for i in range(20):
        with rec.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in rec.spans()] == list(range(12, 20))
    other = []
    with rec.paused():
        with rec.span("paused") as s:
            assert rec.begin("off") is None
            t = threading.Thread(target=lambda: other.append(rec.begin("other")))
            t.start()
            t.join()
    assert s is None and other[0] is not None
    with rec.span("after") as s:
        pass
    assert s is not None and [x.name for x in rec.spans()][-1] == "after"
    assert not rec.spans("paused") and not rec.spans("off")
    rec.clear()
    assert rec.spans() == []


def test_threads_record_every_span_and_count():
    """A thread started before the recording (as MotionServer's is) records, and
    many threads lose no span under a short switch interval."""
    rec = tracing.Recorder()
    start = threading.Event()

    def work(k):
        start.wait(10)
        for i in range(200):
            with rec.span("w", k=k):
                pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        start.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    spans = rec.spans("w")
    assert len(spans) == 16 * 200
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.parent is None for s in spans)  # no thread nests in another's span
    assert len({s.thread for s in spans}) == 16


def test_export_lines_up_with_the_profiler(tmp_path):
    """A span around a main-thread record_function brackets the profiler's marker
    on its timeline, in the spans' own file and merged into the profiler's."""
    rec = tracing.Recorder()
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("outer", note=(1, 2)):
            with torch.profiler.record_function("marker"):
                for _ in range(20):
                    x = x @ x / 64.0
    prof_path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(prof_path))
    ptrace = json.loads(prof_path.read_text())
    base_us = ptrace.get("baseTimeNanoseconds", 0) / 1e3
    marker = next(e for e in ptrace["traceEvents"] if e.get("name") == "marker")
    m0, m1 = marker["ts"] + base_us, marker["ts"] + marker["dur"] + base_us

    rec.export_chrome(tmp_path / "spans.json")
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == 0
    (outer,) = spans["traceEvents"]
    assert outer["args"]["note"] == [1, 2]
    # the profiler's µs, taken from its own clock, are rounded: 1 µs either side
    assert outer["ts"] <= m0 + 1 and m1 <= outer["ts"] + outer["dur"] + 1

    rec.export_chrome(tmp_path / "joined.json", profiler_trace=prof_path)
    joined = json.loads((tmp_path / "joined.json").read_text())
    assert len(joined["traceEvents"]) == len(ptrace["traceEvents"]) + 1
    outer = next(e for e in joined["traceEvents"] if e.get("cat") == "span")
    assert outer["ts"] <= marker["ts"] + 1
    assert marker["ts"] + marker["dur"] <= outer["ts"] + outer["dur"] + 1


@pytest.fixture(scope="module")
def pipe():
    model = MDM_UNET(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
                     pad_frames_to=T, zero=False, device="cpu", seed=0)
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 4))
    return SamplePipeline(model, sched, DiffusionConfig(), SamplerConfig(), device="cpu")


class _HandoffEvent(threading.Event):
    """A request's result event that notes when the server set it and when its
    waiting caller ran again: the thread handoff between the two, which the
    operating system schedules (up to 6 ms seen on a loaded host)."""

    def set(self):
        self.set_ns = time.perf_counter_ns()
        super().set()

    def wait(self, timeout=None):
        done = super().wait(timeout)
        self.woke_ns = time.perf_counter_ns()
        return done


def test_server_spans_account_for_each_request(pipe, fresh):
    """Five concurrent requests at max_batch 4 and two single ones: a request's
    span is its queue wait plus its batch's time up to its own result, the
    batches' spans agree with MotionServer.batches, and a single request's span
    is the latency its caller saw, within 5 ms, once the caller thread's wake-up
    after the server handed it the result is taken out (measured here, not bounded:
    it is the scheduler's, and the span ends before the handoff begins)."""
    srv = MotionServer(pipe, T, F, max_batch=4, max_wait_ms=300, guidance_param=2.5)
    rng = np.random.default_rng(0)
    try:
        reqs = [srv.submit(MotionRequest(text_embed=rng.standard_normal(512).astype(np.float32),
                                         seed=i)) for i in range(5)]
        for r in reqs:
            r.result(timeout=120)
        seen = []
        for i in range(2):
            # the caller sees its result before the batching thread is back at the
            # queue: let it come back, so that this request finds the server idle
            time.sleep(0.5)
            handoff = _HandoffEvent()
            t0 = time.perf_counter_ns()
            srv.submit(MotionRequest(text_embed=rng.standard_normal(512).astype(np.float32),
                                     seed=9, _event=handoff)).result()
            seen.append((time.perf_counter_ns() - t0, handoff))
    finally:
        srv.shutdown()
    assert not srv._thread.is_alive()
    assert srv.batches == [(4, 4), (1, 1), (1, 1), (1, 1)]

    def of(name):
        return [s for s in tracing.spans(name) if s.attrs.get("server") == srv.id]

    requests = {s.attrs["req"]: s for s in of("server.request")}
    queues = {s.attrs["req"]: s for s in of("server.queue")}
    batches = sorted(of("server.batch"), key=lambda s: s.attrs["batch"])
    assert sorted(requests) == sorted(queues) == list(range(7))
    assert [(s.attrs["n"], s.attrs["bucket"]) for s in batches] == srv.batches
    assert [s.attrs["reqs"] for s in batches] == [[0, 1, 2, 3], [4], [5], [6]]
    for i, req in requests.items():
        q, b = queues[i], batches[req.attrs["batch"]]
        assert q.parent == req.id and q.trace == req.trace and q.attrs["batch"] == b.attrs["batch"]
        assert q.start_ns == req.start_ns and q.end_ns == b.start_ns
        assert req.end_ns - req.start_ns == (q.end_ns - q.start_ns) + (req.end_ns - b.start_ns)
        assert b.start_ns < req.end_ns <= b.end_ns
    for req, (caller_ns, handoff) in zip((requests[5], requests[6]), seen):
        assert req.end_ns <= handoff.set_ns <= handoff.woke_ns
        handoff_ns = handoff.woke_ns - handoff.set_ns
        assert 0 <= caller_ns - handoff_ns - (req.end_ns - req.start_ns) < 5e6
    for b in batches:
        kids = [s for s in tracing.spans() if s.parent == b.id]
        assert [s.name for s in kids] == ["server.load", "sampler.run", "server.deliver"]
        assert all(s.trace == b.trace for s in kids)
        assert kids[1].attrs == {"steps": 4}
        assert b.start_ns <= kids[0].start_ns and kids[-1].end_ns <= b.end_ns
    gathers = sorted(of("server.gather"), key=lambda s: s.attrs["batch"])
    assert [g.attrs["n"] for g in gathers] == [4, 1, 1, 1]
    assert all(g.end_ns <= b.start_ns for g, b in zip(gathers, batches))
    assert gathers[1].attrs["queued"] >= 1  # the fifth request waited behind the first batch
    assert gathers[2].attrs["queued"] == 0  # generate submits into an idle server


def test_a_failed_batch_ends_its_requests_spans(pipe, fresh):
    srv = MotionServer(pipe, T, F, max_batch=2, max_wait_ms=1)
    try:
        bad = srv.submit(MotionRequest(text_embed=np.zeros(7, np.float32)))
        with pytest.raises(RuntimeError, match="failed"):
            bad.result(timeout=60)
    finally:
        srv.shutdown()
    (req,) = [s for s in tracing.spans("server.request") if s.attrs["server"] == srv.id]
    assert "error" in req.attrs and req.attrs["batch"] == 0


class _Fake:
    """A stream, a graph and a capture context that do nothing, so that
    CudaGraph's capture runs on the CPU."""

    device = None

    def __init__(self, *_a, **_k):
        pass

    def wait_stream(self, _other):
        pass

    def replay(self):
        pass


def test_a_capture_records_its_span_and_nothing_of_its_body(monkeypatch, fresh):
    """CudaGraph._capture, with the card's stream and graph calls faked: the
    warm-up call's spans are kept, the capture body's are not, and each capture
    is one graph.capture span with its cause."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Fake())
    monkeypatch.setattr(torch.cuda, "Stream", _Fake)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Fake)
    monkeypatch.setattr(torch.cuda, "stream", lambda *_a: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda *_a, **_k: contextlib.nullcontext())
    w = torch.nn.Linear(2, 2)

    def fn():
        with tracing.span("inside"):
            pass
        return w.weight.sum()

    g = cuda_graph.CudaGraph(fn, [w])
    g()
    g()  # a replay
    with torch.no_grad():
        w.weight.add_(1.0)  # the key changes: a capture again
    g()
    captures = tracing.spans("graph.capture")
    assert [s.attrs["cause"] for s in captures] == ["first", "key changed"]
    inside = tracing.spans("inside")
    assert len(inside) == 2 and [s.parent for s in inside] == [s.id for s in captures]
    assert g.captures == 2 and g.replays == 1


def _train_setup():
    from condmdi_tpu_torch.training import loop as tloop

    model = MDM_UNET(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
                     pad_frames_to=T, zero=False, device="cpu", seed=1)
    model.train()
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 4))
    tc = tloop.TrainConfig(batch_size=2, keyframe_conditioned=True, keyframe_mask_prob=0.1)
    rng = np.random.default_rng(3)
    lengths = torch.tensor([20, 28])
    batch = {"motion": torch.from_numpy(rng.standard_normal((2, T, F)).astype(np.float32)),
             "time_mask": torch.arange(T)[None] < lengths[:, None], "lengths": lengths,
             "lengths_host": lengths,
             "text_embed": torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))}
    draws = tloop.StepDraws(torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
    return tloop, model, sched, tc, batch, draws


def test_train_steps_record_the_host_draw_and_the_eager_parts(fresh):
    """A buffered step records one train.host_draw a step and none of the step's
    parts; the eager step records its parts, host-timed on the CPU."""
    tloop, model, sched, tc, batch, draws = _train_setup()
    state = tloop.create_train_state(model, tc, sched)
    step = tloop.BufferedTrainStep(model, sched, tc,
                                   tloop._step_body(model, sched, DiffusionConfig(), tc))
    for _ in range(3):
        step(state, batch, draws)
    assert [s.name for s in tracing.spans()] == ["train.host_draw"] * 3
    assert all(s.attrs == {"rows": 2} for s in tracing.spans())

    tracing.clear()
    eager = tloop.make_train_step(model, sched, DiffusionConfig(), tc)
    for _ in range(2):
        eager(state, batch, draws)
    parts = ["train.host_draw", "train.forward", "train.backward", "train.optimizer"]
    spans = tracing.spans()
    assert [s.name for s in spans] == parts * 2
    assert all(s.parent is None and s.device_ms() is None for s in spans)
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns <= b.start_ns
