"""Processes of tests/test_torch_parallel.py: each joins a gloo group through a
FileStore and checks the port's data-parallel paths against the single-process
result, which it computes itself. Imports torch and the port only (the
processes start without JAX)."""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

F, T, B = 263, 24, 4
SAMPLE_TOL = 1e-5  # one process at B against each rank's B/n rows: float32 reassociation
STEP_TOL = 1e-5  # parameters after 3 AdamW steps at lr 1e-3 (updates ~1e-3)
# tensor parallelism reassociates more: the UNet's block2 conv summed over split input
# channels, its GroupNorm over split groups. The last step's gradients agree to 1.2e-4 of
# each tensor's largest (the conv biases before a GroupNorm have no gradient but rounding),
# and AdamW, which scales every element's step to ~lr, turns that into parameter
# differences up to 1.0e-4 of their scale (0.14 lr); MDM's agree to 2e-6 (its key bias apart)
TP_GRAD_TOL = 5e-4
TP_STEP_TOL = 2e-4


def run_ranks(fn, world: int, store: str, timeout: float = 240.0, *args) -> None:
    """fn(rank, world, store, *args) in `world` spawned processes; raises if one
    fails or the whole does not end within `timeout` seconds (then they are killed)."""
    ctx = mp.start_processes(fn, args=(world, store) + args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: the {world} processes did not end in {timeout} s")


def _join(rank, world, store):
    from condmdi_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                           backend="gloo")
    return make_mesh()


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / (1 + np.abs(want).max())
    assert err <= tol, f"{what}: relative difference {err:.3e} > {tol:.0e}"


def _unet(seed=0):
    from condmdi_tpu_torch.models.unet import MDM_UNET

    return MDM_UNET(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
                    pad_frames_to=T, zero=False, device="cpu", seed=seed).eval()


def sampling_ranks(rank, world, store):
    """dp_sample and generate_eval_batch(mesh=) against one process."""
    try:
        from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset, collate
        from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule
        from condmdi_tpu_torch.diffusion.schedule import get_named_beta_schedule
        from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
        from condmdi_tpu_torch.evals.harness import EvalConfig, generate_eval_batch
        from condmdi_tpu_torch.models.text import HashTextEncoder
        from condmdi_tpu_torch.parallel.dp_sample import dp_sample
        from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

        mesh = _join(rank, world, store)
        model = _unet()
        sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 6))
        pipe = SamplePipeline(model, sched, DiffusionConfig(), SamplerConfig(method="ddpm"),
                              device="cpu")
        rng = np.random.default_rng(1)
        y = {"text_embed": torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))}
        obs = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
        mask = torch.from_numpy(rng.random((B, T, F)) < 0.2)
        with torch.no_grad():
            one = pipe.sample((B, T, F), y, 2.5, obs_x0=obs, obs_mask=mask,
                              generator=torch.Generator().manual_seed(5))
            dp = dp_sample(pipe, mesh, (B, T, F), y, 2.5, obs_x0=obs, obs_mask=mask,
                           generator=torch.Generator().manual_seed(5))
        assert dp.shape == one.shape
        _close(dp, one, SAMPLE_TOL, "dp_sample")

        rel = DatasetConfig(max_motion_length=T, abs_3d=False, split="test")
        ab = DatasetConfig(max_motion_length=T, abs_3d=True, split="test")
        ds_rel = SyntheticMotionDataset(rel, size=B, seed=1, device="cpu")
        ds_abs = SyntheticMotionDataset(ab, size=B, seed=1, device="cpu")
        np.random.seed(0)
        batch = collate([ds_rel[i] for i in range(B)], T, HashTextEncoder())
        cfg = EvalConfig(guidance_param=1.0, max_frames=T, batch_size=B)
        outs = [generate_eval_batch(pipe, batch, 7, cfg, ds_abs.stats, ds_rel.stats, mesh=m)
                for m in (None, mesh)]
        for name in ("motions_rel", "dist_error", "keyframe_error", "skate_ratio"):
            _close(getattr(outs[1], name), getattr(outs[0], name), 1e-4, name)
        np.testing.assert_array_equal(outs[1].num_keyframes, outs[0].num_keyframes)
    except BaseException:
        traceback.print_exc()
        raise


def train_ranks(rank, world, store):
    """A data-parallel train step (eager, and BufferedTrainStep on its buffers)
    against the single-process step on the global batch, for the keyframe UNet
    and for MDM with dropout and condition dropout."""
    try:
        from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule
        from condmdi_tpu_torch.diffusion.schedule import get_named_beta_schedule
        from condmdi_tpu_torch.models.mdm import MDM
        from condmdi_tpu_torch.parallel.mesh import shard_batch
        from condmdi_tpu_torch.training.loop import (
            BufferedTrainStep, StepDraws, TrainConfig, _step_body, create_train_state,
            make_train_step,
        )

        mesh = _join(rank, world, store)
        sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 8))
        rng = np.random.default_rng(3)
        lengths = np.array([T, T - 6, T, T - 3])
        batch = {"motion": torch.from_numpy((0.5 * rng.standard_normal((B, T, F))).astype(np.float32)),
                 "time_mask": torch.from_numpy(np.arange(T)[None] < lengths[:, None]),
                 "lengths": torch.from_numpy(lengths),
                 "text_embed": torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))}
        batch["lengths_host"] = batch["lengths"]
        mine = shard_batch(mesh, batch)

        def build(kind):
            if kind == "unet":
                return _unet(seed=2).train()
            return MDM(njoints=F, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
                       dropout=0.1, cond_mask_prob=0.1, device="cpu", seed=2).train()

        for kind in ("unet", "mdm"):
            tcfg = TrainConfig(lr=1e-3, keyframe_conditioned=kind == "unet", keyframe_mask_prob=0.5)
            dcfg = DiffusionConfig()
            results = []
            for variant in ("single", "dp", "dp_buffered"):
                model = build(kind)
                state = create_train_state(model, tcfg, sched)
                draws = StepDraws(torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))
                if variant == "single":
                    step, feed = make_train_step(model, sched, dcfg, tcfg, cuda_graphs=False), batch
                elif variant == "dp":
                    step, feed = make_train_step(model, sched, dcfg, tcfg, mesh=mesh), mine
                else:
                    body = _step_body(model, sched, dcfg, tcfg, mesh)
                    step, feed = BufferedTrainStep(model, sched, tcfg, body), mine
                losses = [float(step(state, feed, draws)["loss"]) for _ in range(3)]
                results.append((losses, {k: v.detach().clone() for k, v in state.params.items()},
                                {k: v.clone() for k, v in state.ema.items()}))
            (l1, p1, e1) = results[0]
            for name, (l2, p2, e2) in zip(("dp", "dp_buffered"), results[1:]):
                _close(l2, l1, 1e-5, f"{kind} {name} losses")
                for k in p1:
                    for tree2, tree1, what in ((p2, p1, k), (e2, e1, f"ema {k}")):
                        got, want = tree2[k], tree1[k]
                        if k.endswith("qkv.bias"):
                            # the key bias has no gradient (softmax ignores a shift shared
                            # by every key): its gradient is rounding noise, which AdamW
                            # turns into steps of up to lr each, in either direction
                            d = got.shape[0] // 3
                            key = slice(d, 2 * d)
                            assert (got[key] - want[key]).abs().max() <= 2 * 3 * tcfg.lr, k
                            got, want = torch.cat([got[:d], got[2 * d:]]), \
                                torch.cat([want[:d], want[2 * d:]])
                        _close(got, want, STEP_TOL, f"{kind} {name} {what}")
            # the buffered step replays the eager DP step's arithmetic
            for k in results[1][1]:
                assert torch.equal(results[1][1][k], results[2][1][k]), f"{kind} buffered {k}"
    except BaseException:
        traceback.print_exc()
        raise


def tp_ranks(rank, world, store):
    """At 2 x 2 (dp, tp): the tensor-parallel forward of MDM and the keyframe UNet
    against the full model, then three train steps against the single-process
    step on the global batch (each rank's slices against the same slices of the
    single-process parameters)."""
    try:
        from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule
        from condmdi_tpu_torch.diffusion.schedule import get_named_beta_schedule
        from condmdi_tpu_torch.models.mdm import MDM
        from condmdi_tpu_torch.parallel.mesh import initialize_distributed, shard_batch
        from condmdi_tpu_torch.parallel.tp import full_slice, make_mesh_2d, tensor_parallel
        from condmdi_tpu_torch.training.loop import (
            StepDraws, TrainConfig, create_train_state, make_train_step,
        )

        torch.set_num_threads(1)
        initialize_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                               backend="gloo")
        mesh = make_mesh_2d(2, 2)
        sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 8))
        rng = np.random.default_rng(4)
        lengths = np.array([T, T - 6, T, T - 3])
        batch = {"motion": torch.from_numpy((0.5 * rng.standard_normal((B, T, F))).astype(np.float32)),
                 "time_mask": torch.from_numpy(np.arange(T)[None] < lengths[:, None]),
                 "lengths": torch.from_numpy(lengths),
                 "text_embed": torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))}
        batch["lengths_host"] = batch["lengths"]
        mine = shard_batch(mesh["dp"], batch)

        def build(kind):
            if kind == "unet":
                return MDM_UNET_small(seed=2)
            return MDM(njoints=F, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
                       dropout=0.1, cond_mask_prob=0.1, device="cpu", seed=2)

        for kind in ("unet", "mdm"):
            full = build(kind).eval()
            tpm = tensor_parallel(full, mesh).eval()
            x, t = batch["motion"], torch.tensor([1, 3, 5, 7])
            y = {"text_embed": batch["text_embed"]}
            kw = dict(obs_x0=x, obs_mask=torch.from_numpy(rng.random((B, T, F)) < 0.2)) \
                if kind == "unet" else {}
            with torch.no_grad():
                _close(tpm(x, t, y, **kw), full(x, t, y, **kw), 1e-5, f"{kind} tp forward")

            tcfg = TrainConfig(lr=1e-3, keyframe_conditioned=kind == "unet", keyframe_mask_prob=0.5)
            dcfg = DiffusionConfig()
            single = build(kind).train()
            tp_model = tensor_parallel(build(kind), mesh).train()
            runs = []
            for model, step_mesh, feed in ((single, None, batch), (tp_model, mesh, mine)):
                state = create_train_state(model, tcfg, sched)
                draws = StepDraws(torch.Generator().manual_seed(11),
                                  torch.Generator().manual_seed(12))
                step = make_train_step(model, sched, dcfg, tcfg, cuda_graphs=False, mesh=step_mesh)
                ms = [step(state, feed, draws) for _ in range(3)]
                runs.append((ms, state))
            (m1, s1), (m2, s2) = runs
            for a, b in zip(m1, m2):
                for key in ("loss", "grad_norm", "param_norm"):
                    _close(b[key], a[key], 1e-5, f"{kind} tp {key}")
            # the last step's gradients (after the clip), each against its own scale
            want_g = full_slice({k: v.grad for k, v in s1.params.items()}, tp_model)
            for k, v in s2.params.items():
                g, w = v.grad.numpy().astype(np.float64), want_g[k].numpy().astype(np.float64)
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)
                assert err <= TP_GRAD_TOL, f"{kind} tp gradient {k}: {err:.2e}"
            want_p = full_slice({k: v.detach() for k, v in s1.params.items()}, tp_model)
            want_e = full_slice(s1.ema, tp_model)
            for k, v in s2.params.items():
                got, want = v.detach(), want_p[k]
                if k.endswith("qkv.bias"):  # the key bias: rounding noise under AdamW
                    d = got.shape[0] // 3
                    assert (got[d:2 * d] - want[d:2 * d]).abs().max() <= 2 * 3 * tcfg.lr, k
                    got, want = torch.cat([got[:d], got[2 * d:]]), torch.cat([want[:d], want[2 * d:]])
                _close(got, want, TP_STEP_TOL, f"{kind} tp {k}")
                _close(s2.ema[k], want_e[k], TP_STEP_TOL, f"{kind} tp ema {k}")
    except BaseException:
        traceback.print_exc()
        raise


def MDM_UNET_small(seed=0):
    from condmdi_tpu_torch.models.unet import MDM_UNET

    return MDM_UNET(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
                    pad_frames_to=T, zero=False, device="cpu", seed=seed)
