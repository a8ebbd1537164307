"""Serving runtime: request micro-batching over a SamplePipeline.

Counterpart of condmdi_tpu/serving.py:

  * a background thread coalesces concurrent requests up to `max_batch` or
    `max_wait_ms`, and pads the tail with dummy rows to a power-of-two
    bucket, so batch sizes stay few;
  * each bucket is warmed once where the JAX server compiled it: on the card
    its sampler step is captured as CUDA graphs (sampling/pipeline.py
    `SamplingProgram.warm`, on the calling thread) and each batch copies
    its inputs into that bucket's buffers and replays them from the server
    thread; elsewhere one denoiser forward builds the kernels;
  * per-request keyframes: obs_x0 / obs_mask rows are batched together with
    unconditioned rows, whose mask is all False;
  * a batch's noise comes from a `torch.Generator` on the pipeline's device
    seeded with the first request's seed;
  * every request and batch is recorded (utils/tracing.py): `server.request`
    from submit to its result, its child `server.queue` up to the start of the
    batch that carries it; `server.gather`, the wait that closes a batch;
    `server.batch` from its close to its last result, with its children
    `server.load`, `sampler.run` and `server.deliver`. A request's latency is
    its queue wait plus its batch's time up to its own result.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from condmdi_tpu_torch.utils import tracing

TEXT_DIM = 512  # CLIP text-embedding width the models condition on


@dataclass
class MotionRequest:
    text_embed: np.ndarray  # [512]
    obs_x0: Optional[np.ndarray] = None  # [T, F]
    obs_mask: Optional[np.ndarray] = None  # [T, F] bool
    seed: int = 0
    _event: threading.Event = field(default_factory=threading.Event, repr=False)
    _result: Optional[np.ndarray] = None
    _error: Optional[BaseException] = None
    _id: int = -1  # the server's count of requests submitted before it
    _span: Optional[tracing.Span] = field(default=None, repr=False)  # server.request

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("motion request timed out")
        if self._error is not None:
            raise RuntimeError("motion request failed") from self._error
        return self._result


_SERVERS = itertools.count()


class MotionServer:
    """Micro-batching inference server over a SamplePipeline. Its spans carry
    `server`, a number that tells this server's from another's in the process;
    requests (`req`) and batches (`batch`) are numbered from 0 in the order the
    server took them."""

    def __init__(
        self,
        pipe,  # sampling.pipeline.SamplePipeline
        n_frames: int,
        feature_dim: int = 263,
        max_batch: int = 32,
        max_wait_ms: float = 20.0,
        guidance_param: float = 1.0,
    ):
        self.pipe = pipe
        self.device = pipe.device
        self.T = n_frames
        self.F = feature_dim
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.guidance_param = guidance_param
        # (requests, bucket) of every batch run, in order
        self.batches: list[tuple[int, int]] = []
        self.id = next(_SERVERS)
        self._requests = itertools.count()
        self._closed = 0  # batches closed

        self._queue: "queue.Queue[MotionRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._warm: set[int] = set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def warmup(self, buckets=(1, 8, 32)):
        """Make each batch bucket's sampling program ready: on the card its sampler
        step captured as CUDA graphs (one per branch of the apply_fn), as the JAX
        server compiles a program per bucket; with graphs off or on the CPU, one
        denoiser forward, which builds the kernels."""
        for b in buckets:
            if b <= self.max_batch:
                self._warmup(self._bucket(b))

    @torch.no_grad()
    def _warmup(self, B: int):
        if B in self._warm:
            return
        dev = self.device
        x = torch.zeros((B, self.T, self.F), device=dev)
        prog = self.pipe.program(
            x.shape, {"text_embed": torch.zeros((B, TEXT_DIM), device=dev)},
            self.guidance_param, obs_x0=x,
            obs_mask=torch.zeros(x.shape, dtype=torch.bool, device=dev),
        )
        prog.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm.add(B)

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    # ------------------------------------------------------------------ #
    def submit(self, req: MotionRequest) -> MotionRequest:
        req._id = next(self._requests)
        req._span = tracing.begin("server.request", req=req._id, server=self.id)
        self._queue.put(req)
        return req

    def generate(self, text_embed: np.ndarray, **kw) -> np.ndarray:
        return self.submit(MotionRequest(text_embed=text_embed, **kw)).result()

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=60)

    # ------------------------------------------------------------------ #
    def _loop(self):
        while not self._stop.is_set():
            queued = self._queue.qsize()
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            gather = tracing.begin("server.gather", server=self.id, batch=self._closed,
                                   queued=queued)
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            tracing.end(gather, n=len(batch))
            j = self._closed
            self._closed += 1
            try:
                self._run_batch(batch, j)
            except Exception as exc:  # the server keeps running; each caller sees the error
                for r in batch:
                    r._error = exc
                    tracing.end(r._span, batch=j, error=repr(exc))
                    r._event.set()

    def _run_batch(self, batch: list[MotionRequest], j: int):
        n = len(batch)
        B = self._bucket(n)
        with tracing.span("server.batch", server=self.id, batch=j, n=n, bucket=B,
                          reqs=[r._id for r in batch]) as span:
            for r in batch:
                if r._span is not None:
                    tracing.end(tracing.begin("server.queue", parent=r._span,
                                              start_ns=r._span.start_ns, server=self.id,
                                              req=r._id, batch=j),
                                end_ns=None if span is None else span.start_ns)
            self._warmup(B)
            dev = self.device
            with tracing.span("server.load"):
                text = np.zeros((B, TEXT_DIM), np.float32)
                obs_x0 = np.zeros((B, self.T, self.F), np.float32)
                obs_mask = np.zeros((B, self.T, self.F), bool)
                for i, r in enumerate(batch):
                    text[i] = r.text_embed
                    if r.obs_x0 is not None:
                        obs_x0[i] = r.obs_x0
                        obs_mask[i] = r.obs_mask
                gen = torch.Generator(device=dev).manual_seed(batch[0].seed)
                y = {"text_embed": torch.from_numpy(text).to(dev)}
                obs_x0 = torch.from_numpy(obs_x0).to(dev)
                obs_mask = torch.from_numpy(obs_mask).to(dev)
            out = self.pipe.sample((B, self.T, self.F), y, guidance_param=self.guidance_param,
                                   obs_x0=obs_x0, obs_mask=obs_mask, generator=gen)
            with tracing.span("server.deliver"):
                out = out.float().cpu().numpy()
                self.batches.append((n, B))
                for i, r in enumerate(batch):
                    r._result = out[i]
                    tracing.end(r._span, batch=j)
                    r._event.set()
