"""The port's MotionServer (condmdi_tpu_torch/serving.py) on the CPU at the tiny
config of tests/test_serving.py: single requests, concurrent coalescing into
power-of-two buckets, keyframe rows, and results equal to SamplePipeline.sample
run directly with the same bucket, inputs and seed."""

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

T, F = 28, 263
GUIDANCE = 2.5


@pytest.fixture(scope="module")
def pipe():
    model = MDM_UNET(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
                     pad_frames_to=T, zero=False, device="cpu", seed=0)
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 4))
    return SamplePipeline(model, sched, DiffusionConfig(), SamplerConfig(), device="cpu")


@pytest.fixture
def server(pipe):
    srv = MotionServer(pipe, T, F, max_batch=4, max_wait_ms=300, guidance_param=GUIDANCE)
    yield srv
    srv.shutdown()
    assert not srv._thread.is_alive()


def direct(pipe, bucket, rows, seed):
    """SamplePipeline.sample on the server's padded bucket; rows = [(text, obs, mask)]."""
    text = np.zeros((bucket, 512), np.float32)
    obs = np.zeros((bucket, T, F), np.float32)
    mask = np.zeros((bucket, T, F), bool)
    for i, (tx, ob, mk) in enumerate(rows):
        text[i] = tx
        if ob is not None:
            obs[i], mask[i] = ob, mk
    out = pipe.sample((bucket, T, F), {"text_embed": torch.from_numpy(text)},
                      guidance_param=GUIDANCE, obs_x0=torch.from_numpy(obs),
                      obs_mask=torch.from_numpy(mask),
                      generator=torch.Generator().manual_seed(seed))
    return out.numpy()


def keyframes(seed):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, F)).astype(np.float32)
    mask = np.zeros((T, F), bool)
    mask[::7] = True
    return obs, mask


def test_single_request_equals_direct_sampling(pipe, server):
    text = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    got = server.generate(text, seed=5)
    assert got.shape == (T, F) and np.isfinite(got).all()
    assert server.batches == [(1, 1)]
    np.testing.assert_array_equal(got, direct(pipe, 1, [(text, None, None)], 5)[0])


def test_keyframe_request_equals_direct_sampling(pipe, server):
    text = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    obs, mask = keyframes(3)
    got = server.generate(text, obs_x0=obs, obs_mask=mask, seed=9)
    np.testing.assert_array_equal(got, direct(pipe, 1, [(text, obs, mask)], 9)[0])


def test_concurrent_requests_coalesce_into_buckets(pipe, server):
    """Five requests at max_batch 4: one full bucket of 4, then a bucket of 1.
    Keyframe rows and text-only rows share a batch."""
    rng = np.random.default_rng(4)
    rows = []
    for i in range(5):
        text = rng.standard_normal(512).astype(np.float32)
        obs, mask = keyframes(10 + i) if i % 2 == 0 else (None, None)
        rows.append((text, obs, mask))
    reqs = [server.submit(MotionRequest(text_embed=tx, obs_x0=ob, obs_mask=mk, seed=7 + i))
            for i, (tx, ob, mk) in enumerate(rows)]
    outs = [r.result(timeout=120) for r in reqs]
    assert server.batches == [(4, 4), (1, 1)]
    first = direct(pipe, 4, rows[:4], 7)  # a batch's seed is its first request's
    for i in range(4):
        np.testing.assert_array_equal(outs[i], first[i])
    np.testing.assert_array_equal(outs[4], direct(pipe, 1, rows[4:], 11)[0])


def test_bucketing(server):
    assert [server._bucket(n) for n in (1, 2, 3, 4, 9)] == [1, 2, 4, 4, 4]


def test_warmup_runs_one_forward_per_bucket(server):
    server.warmup(buckets=(1, 3, 8))
    assert server._warm == {1, 4}


def test_failed_batch_raises_in_the_caller(pipe):
    srv = MotionServer(pipe, T, F, max_batch=2, max_wait_ms=1)
    try:
        bad = srv.submit(MotionRequest(text_embed=np.zeros(7, np.float32)))
        with pytest.raises(RuntimeError, match="failed"):
            bad.result(timeout=60)
        # the server keeps serving after a failed batch
        assert srv.generate(np.zeros(512, np.float32)).shape == (T, F)
    finally:
        srv.shutdown()
