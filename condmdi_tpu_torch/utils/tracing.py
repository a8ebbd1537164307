"""The port's span recorder: where a request, a batch, a sampler run, a graph
capture or a train step spent its time, kept in memory by the program.

A span is a named interval on the host's `time.perf_counter_ns()` clock with
its own id, its parent's id, and a trace id that every span of one request (or
batch, or step) shares, plus a few attributes. The recorder keeps the newest `CAPACITY` finished spans in a ring (older ones
are dropped) and is safe to use from several threads: `MotionServer`'s batching
thread records beside the caller's.

What the port records (nothing per sampler step or per kernel: a span costs a
few microseconds against batches of seconds and train steps of a quarter second):

  server.request    `MotionServer.submit` → its result set (attrs: req, server,
                    batch, error when its batch failed)
  server.queue      child of server.request: submit → the start of its batch
  server.gather     the batching thread's wait from the first request taken to
                    the batch closed (`max_wait_ms`; attr queued: requests
                    already waiting when the thread came back for a batch)
  server.batch      batch closed → its last result set (attrs: n, bucket, reqs)
  server.load       child of server.batch: host assembly and copies to the card
  sampler.run       `SamplingProgram.run`, for every caller (the server's batch,
                    the CLIs, offline sampling; attr steps; a capture made
                    during the run is its child graph.capture)
  server.deliver    child of server.batch: the copy back and the results set
  graph.capture     `CudaGraph._capture`, warm-up call and capture (attr cause:
                    "first" or "key changed")
  train.host_draw   the host's draw of a step's keyframe masks from the batch's
                    `lengths_host` (the training loop's batches carry it): it
                    launches nothing and waits for nothing on the card. A batch
                    without it has its lengths read from the card in the span
  train.forward, train.backward, train.optimizer
                    the parts of a train step that runs eagerly on the card
                    (`make_train_step(..., cuda_graphs=False)`), each timed by a
                    pair of CUDA events as well (`Span.device_ms`)

Device-timed spans record CUDA events only where asked and never while the
current stream captures; nothing is recorded inside a CUDA-graph capture's
body (`paused`).

`export_chrome(path)` writes the spans as Chrome-trace JSON on torch.profiler's
timeline: `ts` is wall-clock microseconds (perf_counter_ns plus one offset to
time.time_ns taken when this module is imported), as a profiler event's `ts`
plus its trace's `baseTimeNanoseconds` is. Given a profiler trace, it writes
that trace's events and the spans in one file, so an idle gap on the device
shows which span the host was in.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Iterator, Optional

CAPACITY = 1 << 16  # finished spans kept

# wall-clock ns = perf_counter_ns + this
WALL_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


class Span:
    """One interval; `end_ns` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "trace", "attrs", "thread",
                 "_events")

    def __init__(self, name, start_ns, span_id, parent, trace, attrs, thread, events=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.id, self.parent, self.trace = span_id, parent, trace
        self.attrs, self.thread, self._events = attrs, thread, events

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def device_ms(self) -> Optional[float]:
        """The CUDA events' interval of a device-timed span (waits for its end
        event), else None."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)


class Recorder:
    def __init__(self, capacity: int = CAPACITY):
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()  # this thread's open spans and pause depth

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def begin(self, name: str, parent: Optional[Span] = None, device: bool = False,
              start_ns: Optional[int] = None, **attrs) -> Optional[Span]:
        """Open a span (None while this thread is `paused`). Its parent is `parent`, else
        the innermost span this thread has open in `span`; a span with no parent
        starts a trace of its own. `device`: also record a CUDA event pair on the
        current stream, unless it is capturing."""
        if getattr(self._local, "paused", 0) > 0:
            return None
        if parent is None:
            stack = self._stack()
            parent = stack[-1] if stack else None
        events = None
        if device:
            import torch

            if not torch.cuda.is_current_stream_capturing():
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
        span_id = next(self._ids)
        return Span(name, time.perf_counter_ns() if start_ns is None else start_ns, span_id,
                    None if parent is None else parent.id,
                    span_id if parent is None else parent.trace, attrs,
                    threading.get_ident(), events)

    def end(self, span: Optional[Span], end_ns: Optional[int] = None, **attrs) -> None:
        """Close `span` and keep it (nothing for None, a span opened while paused)."""
        if span is None:
            return
        if span._events is not None:
            span._events[1].record()
        span.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
        span.attrs.update(attrs)
        with self._lock:
            self._spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None, device: bool = False,
             **attrs) -> Iterator[Optional[Span]]:
        """`with span(name): ...` records the block; spans opened inside it on this
        thread are its children."""
        s = self.begin(name, parent, device, **attrs)
        if s is None:
            yield None
            return
        stack = self._stack()
        stack.append(s)
        try:
            yield s
        finally:
            stack.pop()
            self.end(s)

    @contextlib.contextmanager
    def paused(self):
        """Record nothing on this thread while open (a CUDA graph's capture body)."""
        self._local.paused = getattr(self._local, "paused", 0) + 1
        try:
            yield
        finally:
            self._local.paused -= 1

    def spans(self, name: Optional[str] = None) -> list[Span]:
        """The kept spans, in the order they ended; only `name`'s if given."""
        with self._lock:
            out = list(self._spans)
        return out if name is None else [s for s in out if s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def export_chrome(self, path, profiler_trace=None) -> None:
        """Write the kept spans to `path` as Chrome-trace JSON, `ts` in wall-clock
        microseconds (the file's baseTimeNanoseconds is 0). With `profiler_trace`,
        the path of a torch.profiler `export_chrome_trace` file, write that
        trace's events and the spans in one file on its time base."""
        base_ns, events = 0, []
        if profiler_trace is not None:
            with open(profiler_trace) as f:
                prof = json.load(f)
            base_ns = int(prof.get("baseTimeNanoseconds", 0))
            events = prof.get("traceEvents", [])
        pid = os.getpid()
        for s in self.spans():
            args = {"id": s.id, "parent": s.parent, "trace": s.trace, **s.attrs}
            if s._events is not None:
                args["device_ms"] = s.device_ms()
            events.append({"name": s.name, "cat": "span", "ph": "X", "pid": pid,
                           "tid": f"spans {s.thread}",
                           "ts": (s.start_ns + WALL_OFFSET_NS - base_ns) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                       "displayTimeUnit": "ms"}, f, default=repr)


RECORDER = Recorder()
begin, end, span, paused = RECORDER.begin, RECORDER.end, RECORDER.span, RECORDER.paused
spans, clear, export_chrome = RECORDER.spans, RECORDER.clear, RECORDER.export_chrome
