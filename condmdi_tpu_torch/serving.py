"""Serving runtime: request micro-batching over a SamplePipeline.

Counterpart of condmdi_tpu/serving.py:

  * a background thread coalesces concurrent requests up to `max_batch` or
    `max_wait_ms`, and pads the tail with dummy rows to a power-of-two
    bucket, so batch sizes stay few;
  * each bucket is warmed once (one denoiser forward, which builds the
    kernels) where the JAX server compiled it;
  * per-request keyframes: obs_x0 / obs_mask rows are batched together with
    unconditioned rows, whose mask is all False;
  * a batch's noise comes from a `torch.Generator` on the pipeline's device
    seeded with the first request's seed.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

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

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("motion request timed out")
        if self._error is not None:
            raise RuntimeError("motion request failed") from self._error
        return self._result


class MotionServer:
    """Micro-batching inference server over a SamplePipeline."""

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

        self._queue: "queue.Queue[MotionRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._warm: set[int] = set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def warmup(self, buckets=(1, 8, 32)):
        """Run one denoiser forward at each batch bucket."""
        for b in buckets:
            if b <= self.max_batch:
                self._warmup(self._bucket(b))

    @torch.no_grad()
    def _warmup(self, B: int):
        if B in self._warm:
            return
        dev = self.device
        x = torch.zeros((B, self.T, self.F), device=dev)
        denoise = self.pipe.denoiser(
            {"text_embed": torch.zeros((B, TEXT_DIM), device=dev)}, self.guidance_param,
            obs_x0=x, obs_mask=torch.zeros(x.shape, dtype=torch.bool, device=dev),
        )
        denoise(x, torch.zeros((B,), dtype=torch.long, device=dev))
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
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
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
            try:
                self._run_batch(batch)
            except Exception as exc:  # the server keeps running; each caller sees the error
                for r in batch:
                    r._error = exc
                    r._event.set()

    def _run_batch(self, batch: list[MotionRequest]):
        n = len(batch)
        B = self._bucket(n)
        self._warmup(B)
        text = np.zeros((B, TEXT_DIM), np.float32)
        obs_x0 = np.zeros((B, self.T, self.F), np.float32)
        obs_mask = np.zeros((B, self.T, self.F), bool)
        for i, r in enumerate(batch):
            text[i] = r.text_embed
            if r.obs_x0 is not None:
                obs_x0[i] = r.obs_x0
                obs_mask[i] = r.obs_mask
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(batch[0].seed)
        out = self.pipe.sample(
            (B, self.T, self.F),
            {"text_embed": torch.from_numpy(text).to(dev)},
            guidance_param=self.guidance_param,
            obs_x0=torch.from_numpy(obs_x0).to(dev),
            obs_mask=torch.from_numpy(obs_mask).to(dev),
            generator=gen,
        )
        out = out.float().cpu().numpy()
        self.batches.append((n, B))
        for i, r in enumerate(batch):
            r._result = out[i]
            r._event.set()
