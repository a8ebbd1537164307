"""The sampler step and the train step over static buffers, as a CUDA graph replays them, on the CPU.

On the card the port replays its sampler step and its train step from CUDA
graphs (utils/cuda_graph.py); a replay reads and writes static buffers that
the host fills each step. Here, without a card, the same bodies run on the
same buffers, and each is held bit for bit to the eager loop, and to the JAX
package where the step has a JAX counterpart:

  * the sampler step through its buffers against the eager loop: DDPM and
    DDIM, plain, CFG, conditional and marginal imputation, injected step
    noise, zero noise and the trajectory; two requests through one
    program's buffers against separate runs;
  * the mixed-step denoiser at the model timesteps k_float-1, k_float and
    k_float+1 against JAX's `lax.cond` over the int8_static model and its
    float clone, with t a tensor that raises if it is read on the host, and
    the branches a whole run takes;
  * the buffered train step against the eager step for 3 steps, and against
    JAX's train step with JAX's draws replayed (tests/torch_train_helpers.py)
    at the three-step test's 1e-5; the learning-rate tensor at each step of
    an anneal;
  * the pieces of a graph's validity key, the caches' in-place re-pack, the
    host copy of the timestep map.

The card's own checks (capture, replay, re-capture; capturable AdamW, which
the CPU refuses) are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.training import loop as jloop
from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, SamplerConfig
from condmdi_tpu_torch.diffusion import gaussian as tg
from condmdi_tpu_torch.diffusion.sampling import at_model_step, current_model_step
from condmdi_tpu_torch.diffusion.schedule import get_named_beta_schedule
from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
from condmdi_tpu_torch.models.unet import MixedStepDenoiser
from condmdi_tpu_torch.ops import weight_cache
from condmdi_tpu_torch.ops.quant import QuantizedWeight
from condmdi_tpu_torch.ops.resblock import PackedConvWeight, packed_for_kernel
from condmdi_tpu_torch.sampling.pipeline import (
    SamplePipeline,
    SamplingProgram,
    branch_of,
    build_inpainting_state,
    networks_of,
)
from condmdi_tpu_torch.serving import MotionServer
from condmdi_tpu_torch.training import loop as tloop
from condmdi_tpu_torch.utils.cuda_graph import CudaGraph, implementation_key, tensors_of
from condmdi_tpu_torch.weights import load_flax_params, to_flax_params
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)
from torch_train_helpers import (
    STEPS,
    assert_close,
    jax_batch,
    jax_step_draws,
    make_batch,
    model_pair,
    torch_batch,
)

B, T, F = 2, 24, 263
SMALL = dict(njoints=F, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
             pad_frames_to=T, zero=False)
STEP_TOL = 1e-5  # tests/test_torch_train_step.py's three-step tolerance
QUANT_MEAN_REL = 1e-4  # tests/test_torch_quant.py assert_module_close: int8 forwards


class NoHostRead(torch.Tensor):
    """A tensor that raises where its values would be read on the host."""

    def _refuse(self, *_args, **_kw):
        raise AssertionError("a timestep was read on the host")

    __int__ = __float__ = __bool__ = __index__ = item = tolist = _refuse


def schedule(steps=8, total=1000, rescale=False):
    use = range(0, total, total // steps)
    return DiffusionSchedule.create(get_named_beta_schedule("cosine", total), use_timesteps=use,
                                    rescale_timesteps=rescale)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(5)
    model = TorchUNet(**SMALL, device="cpu", seed=3).requires_grad_(False)
    text = torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))
    obs = torch.from_numpy((0.5 * rng.standard_normal((B, T, F))).astype(np.float32))
    mask = torch.zeros((B, T, F), dtype=torch.bool)
    mask[:, ::5] = True
    return dict(model=model, text=text, obs=obs, mask=mask)


def request(seed):
    rng = np.random.default_rng(seed)
    text = torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))
    obs = torch.from_numpy((0.5 * rng.standard_normal((B, T, F))).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, T, F)) < 0.2)
    return text, obs, mask


def sampler_inputs(s, form, method, sched):
    """(SamplerConfig, sample() keywords) of one form of a run."""
    sampler = SamplerConfig(method=method, eta=0.5 if method == "ddim" else 0.0,
                            zero_noise=form == "zero_noise",
                            return_trajectory=form == "trajectory")
    kw = dict(y={"text_embed": s["text"]}, obs_x0=s["obs"], obs_mask=s["mask"])
    if form == "cfg":
        kw["guidance_param"] = 2.5
    if form in ("imputation", "marginal"):
        kw["inpaint"] = build_inpainting_state(
            s["obs"], s["mask"], imputate=True, stop_imputation_at=2,
            replacement_distribution="conditional" if form == "imputation" else "marginal",
            diffusion_steps=sched.num_timesteps)
    if form == "step_noise":
        rng = np.random.default_rng(9)
        kw["step_noise"] = [torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
                            for _ in range(sched.num_timesteps)]
    return sampler, kw


def buffered_run(pipe, kw, generator, noise=None):
    """One run through a program's static buffers, as the card replays it."""
    kw = dict(kw)
    step_noise = kw.pop("step_noise", None)
    prog = SamplingProgram(pipe, (B, T, F), kw.pop("y"), kw.pop("guidance_param", 1.0),
                           kw.pop("obs_x0", None), kw.pop("obs_mask", None), kw.pop("inpaint", None),
                           buffered=True)
    assert prog.buffered
    return prog, prog.run(noise, generator, step_noise)


# --------------------------------------------------------------------------- #
# the sampler step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", ["ddpm", "ddim"])
@pytest.mark.parametrize("form", ["plain", "cfg", "imputation", "marginal", "step_noise",
                                  "zero_noise", "trajectory"])
def test_step_on_static_buffers_equals_the_eager_loop(small, method, form):
    sched = schedule()
    sampler, kw = sampler_inputs(small, form, method, sched)
    pipe = SamplePipeline(small["model"], sched, DiffusionConfig(), sampler, device="cpu")
    want = pipe.sample((B, T, F), generator=torch.Generator().manual_seed(11), **kw)
    prog, got = buffered_run(pipe, kw, torch.Generator().manual_seed(11))
    assert set(prog.graphs) == {None}  # one branch: the model
    if form == "trajectory":
        assert got[1].shape == (sched.num_timesteps, B, T, F)
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_two_requests_through_one_programs_buffers(small, method):
    """The serving form (CFG, keyframes): request B loaded into the buffers that
    ran request A gives what a fresh run of B gives."""
    sched = schedule()
    pipe = SamplePipeline(small["model"], sched, DiffusionConfig(),
                          SamplerConfig(method=method), device="cpu")
    (ta, oa, ma), (tb, ob, mb) = request(1), request(2)
    prog, got_a = buffered_run(pipe, dict(y={"text_embed": ta}, guidance_param=2.5, obs_x0=oa,
                                          obs_mask=ma), torch.Generator().manual_seed(3))
    prog.load({"text_embed": tb}, ob, mb)
    got_b = prog.run(generator=torch.Generator().manual_seed(4))
    for (text, obs, mask), seed, got in (((ta, oa, ma), 3, got_a), ((tb, ob, mb), 4, got_b)):
        want = pipe.sample((B, T, F), {"text_embed": text}, guidance_param=2.5, obs_x0=obs,
                           obs_mask=mask, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(got, want)
    assert not torch.equal(got_a, got_b)


def test_a_denoiser_refuses_a_request_of_another_layout(small):
    pipe = SamplePipeline(small["model"], schedule(), DiffusionConfig(), device="cpu")
    denoise = pipe.denoiser({"text_embed": small["text"]}, 2.5, small["obs"], small["mask"])
    denoise(torch.zeros(B, T, F), torch.zeros(B, dtype=torch.long))
    with pytest.raises(ValueError, match="buffer"):
        denoise.load({"text_embed": torch.zeros(B, 256)}, small["obs"], small["mask"])


def test_reconstruction_guidance_stays_eager(small):
    sched = schedule()
    inpaint = build_inpainting_state(small["obs"], small["mask"], reconstruction_guidance=True,
                                     reconstruction_weight=0.05, diffusion_steps=8)
    pipe = SamplePipeline(small["model"], sched, DiffusionConfig(), device="cpu")
    prog = SamplingProgram(pipe, (B, T, F), {"text_embed": small["text"]}, 1.0, small["obs"],
                           small["mask"], inpaint, buffered=True)
    assert not prog.buffered and not prog.step.capturable


def test_the_cpu_pipeline_keeps_no_program(small):
    pipe = SamplePipeline(small["model"], schedule(), DiffusionConfig(), device="cpu")
    pipe.sample((B, T, F), {"text_embed": small["text"]}, obs_x0=small["obs"],
                obs_mask=small["mask"], generator=torch.Generator().manual_seed(0))
    assert pipe.programs == {} and pipe.cuda_graphs


# --------------------------------------------------------------------------- #
# the mixed step's branch
# --------------------------------------------------------------------------- #
MIXED = dict(njoints=F, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
             pad_frames_to=32)
K_FLOAT = 100


@pytest.fixture(scope="module")
def mixed_pair():
    """JAX's int8_static UNet (act scales from one calibration pass), its float
    clone, and the port's MixedStepDenoiser over the same variables."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 28, F)).astype(np.float32)
    obs = (0.5 * rng.standard_normal((B, 28, F))).astype(np.float32)
    mask = np.zeros((B, 28, F), bool)
    mask[:, ::5] = True
    text = rng.standard_normal((B, 512)).astype(np.float32)
    jm = JaxUNet(**MIXED, precision_mode="int8_static")
    kw = dict(obs_x0=jnp.asarray(obs), obs_mask=jnp.asarray(mask))
    y = {"text_embed": jnp.asarray(text)}
    v = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray([10, 700]), y, **kw)
    prng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * prng.standard_normal(p.shape), jnp.float32),
        v["params"])
    _, upd = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray([10, 700]), y, **kw,
                      mutable=["act_scale"])
    variables = {"params": params, **upd}
    tm = TorchUNet(**MIXED, precision_mode="int8_static", device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(jax.tree_util.tree_map(np.asarray, variables)))
    tm.requires_grad_(False)

    def jax_mixed(t):  # condmdi_tpu/evals/run.py's apply_fn, t[0] < K picking the branch
        model = jm.clone(precision_mode="float")
        return jax.lax.cond(t[0] < K_FLOAT,
                            lambda: model.apply(variables, jnp.asarray(x), t, y, **kw),
                            lambda: jm.apply(variables, jnp.asarray(x), t, y, **kw))

    inputs = tuple(torch.from_numpy(np.array(a)) for a in (x, obs, mask, text))
    return jax_mixed, MixedStepDenoiser(tm, K_FLOAT), inputs


@pytest.mark.parametrize("k", [K_FLOAT - 1, K_FLOAT, K_FLOAT + 1])
def test_mixed_step_at_the_boundary_matches_jax_without_reading_t(mixed_pair, k):
    jax_mixed, mixed, (x, obs, mask, text) = mixed_pair
    want = np.asarray(jax_mixed(jnp.full((B,), k, jnp.int32)), np.float64)
    t = torch.full((B,), k).as_subclass(NoHostRead)
    with pytest.raises(AssertionError, match="on the host"):
        int(t[0])
    with torch.no_grad(), at_model_step(k):
        got = mixed(x, t, {"text_embed": text}, obs_x0=obs, obs_mask=mask)
    assert mixed.branch(k) == ("float" if k < K_FLOAT else "int8")
    got = np.asarray(got.as_subclass(torch.Tensor).numpy(), np.float64)
    assert np.isfinite(got).all()
    mean_rel = np.abs(got - want).mean() / np.abs(want).mean()
    outside = np.mean(np.abs(got - want) > 1e-3 * (1 + np.abs(want)))
    assert mean_rel <= QUANT_MEAN_REL and outside <= 1e-3, (mean_rel, outside)


def test_mixed_step_run_takes_its_branches_from_the_sampler(mixed_pair):
    """A whole buffered run: the steps whose model timestep is below k_float run
    the float twin, the others the int8 model, one program branch each; t is
    never read on the host; the run equals the eager loop bit for bit."""
    _, mixed, (x, obs, mask, text) = mixed_pair
    sched = schedule(steps=10)  # model timesteps 900, 800, ..., 100, 0
    seen = []
    handles = [m.register_forward_pre_hook(lambda mod, args, tag=tag: seen.append(tag))
               for m, tag in ((mixed.model, "int8"), (mixed.twin, "float"))]
    pipe = SamplePipeline(mixed, sched, DiffusionConfig(), device="cpu")
    prog = SamplingProgram(pipe, x.shape, {"text_embed": text}, 1.0, obs, mask, None,
                           buffered=True)
    prog.warm()
    prog.buffers.t = prog.buffers.t.as_subclass(NoHostRead)
    seen.clear()
    try:
        got = prog.run(generator=torch.Generator().manual_seed(2))
    finally:
        for h in handles:
            h.remove()
    want = pipe.sample(x.shape, {"text_embed": text}, obs_x0=obs, obs_mask=mask,
                       generator=torch.Generator().manual_seed(2))
    expected = [mixed.branch(sched.model_t_host(ti)) for ti in range(9, -1, -1)]
    assert expected == ["int8"] * 9 + ["float"]
    assert seen == expected and set(prog.graphs) == {"int8", "float"}
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert current_model_step() is None


def test_mixed_step_outside_a_sampler_raises(mixed_pair):
    _, mixed, (x, obs, mask, text) = mixed_pair
    with pytest.raises(RuntimeError, match="sampler"):
        mixed(x, torch.full((B,), 5), {"text_embed": text}, obs_x0=obs, obs_mask=mask)
    assert networks_of(mixed) == [mixed.model, mixed.twin]


def test_server_warms_a_mixed_bucket_on_the_cpu(mixed_pair):
    _, mixed, _ = mixed_pair
    pipe = SamplePipeline(mixed, schedule(steps=4), DiffusionConfig(), device="cpu")
    srv = MotionServer(pipe, 28, F, max_batch=2, guidance_param=2.5)
    try:
        srv.warmup(buckets=(2,))
    finally:
        srv.shutdown()
    assert srv._warm == {2}


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #
TRAIN_CFG = {
    "unet": dict(lr=1e-4, weight_decay=0.01, grad_clip=1.0, avg_model_beta=0.9,
                 lr_anneal_steps=10, keyframe_conditioned=True, keyframe_mask_prob=0.5),
    "mdm": dict(lr=1e-4, weight_decay=0.01, grad_clip=0.5, avg_model_beta=0.9),
}


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def train_setup(kind, **overrides):
    from condmdi_tpu_torch.diffusion.schedule import get_named_beta_schedule as named

    kw = dict(cond_mask_prob=0.3)
    if kind != "unet":
        kw["dropout"] = 0.1
    _, _, tm = model_pair(kind, seed=21, **kw)
    tm.train()
    sched = DiffusionSchedule.create(named("cosine", STEPS))
    tc = tloop.TrainConfig(**{**TRAIN_CFG[kind], **overrides})
    dcfg = tg.DiffusionConfig(lambda_vel=0.2)
    return tm, sched, dcfg, tc


@pytest.mark.parametrize("kind", ["unet", "mdm"])
def test_buffered_train_step_equals_the_eager_step(kind):
    results = []
    for buffered in (False, True):
        tm, sched, dcfg, tc = train_setup(kind)
        state = tloop.create_train_state(tm, tc, sched)
        if buffered:
            step = tloop.BufferedTrainStep(tm, sched, tc, tloop._step_body(
                tm, sched, dcfg, tc))
        else:
            step = tloop.make_train_step(tm, sched, dcfg, tc)
        draws = tloop.StepDraws(torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
        metrics = [step(state, torch_batch(make_batch(80 + i)), draws) for i in range(3)]
        if buffered:
            assert step.model_draws.calls  # condition dropout (and MDM's dropout) were buffered
            assert (len(step.model_draws.calls) > 1) == (kind == "mdm")
        results.append((metrics, [p.detach().clone() for p in tm.parameters()],
                        [e.clone() for e in state.ema.values()], state.step))
    (m_e, p_e, e_e, s_e), (m_b, p_b, e_b, s_b) = results
    assert s_e == s_b == 3
    for a, b in zip(m_e, m_b):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p_e + e_e, p_b + e_b))


@pytest.mark.parametrize("kind", ["unet", "mdm"])
def test_buffered_train_step_matches_jax(kind):
    """tests/test_torch_train_step.py's three steps against JAX's raw step, with
    JAX's draws replayed, through the buffered step."""
    from condmdi_tpu.diffusion import gaussian as jg
    from condmdi_tpu.diffusion import schedule as js

    kw = dict(cond_mask_prob=0.3)
    if kind != "unet":
        kw["dropout"] = 0.1
    jm, params, tm = model_pair(kind, seed=21, **kw)
    betas = js.get_named_beta_schedule("cosine", STEPS)
    jsched, tsched = js.DiffusionSchedule.create(betas), DiffusionSchedule.create(betas)
    cfg = TRAIN_CFG[kind]
    jtc, ttc = jloop.TrainConfig(**cfg), tloop.TrainConfig(**cfg)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, x, t, y, train=False, rngs=None, **k: jm.apply(p, x, t, y, train=train,
                                                                  rngs=rngs, **k),
        jsched, jg.DiffusionConfig(lambda_vel=0.2), jtc, raw=True))
    jstate = jloop.create_train_state(params, jtc, jsched)
    tm.train()
    tdcfg = tg.DiffusionConfig(lambda_vel=0.2)
    tstep = tloop.BufferedTrainStep(tm, tsched, ttc, tloop._step_body(
        tm, tsched, tdcfg, ttc))
    tstate = tloop.create_train_state(tm, ttc, tsched)
    for i in range(3):
        batch = make_batch(30 + i)
        rng = jax.random.key(40 + i)
        draws = jax_step_draws(jm, params, rng, batch, jtc, STEPS)
        jstate, jm_metrics = jstep(jstate, jax_batch(batch), rng)
        tm_metrics = tstep(tstate, torch_batch(batch), draws)
        assert set(tm_metrics) == set(jm_metrics)
        for k in jm_metrics:
            assert_close(float(tm_metrics[k]), float(jm_metrics[k]), STEP_TOL)
    assert tstate.step == int(jstate.step) == 3
    got_p, want_p = flat(to_flax_params(tm.state_dict())), flat(jstate.params)
    got_e, want_e = flat(to_flax_params(tstate.ema)), flat(jstate.ema_params)
    assert set(got_p) == set(want_p) == set(got_e)
    for path in want_p:
        for got, want in ((got_p[path], want_p[path]), (got_e[path], want_e[path])):
            if path.endswith("['qkv']['bias']"):
                d = want.shape[0] // 3  # [q | k | v]: the key third is rounding noise
                assert np.abs(got[d:2 * d] - want[d:2 * d]).max() <= 2 * cfg["lr"] * 3
                got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
            assert_close(got, want, STEP_TOL)


def test_learning_rate_tensor_follows_the_anneal():
    """The tensor that a captured AdamW step reads holds learning_rate(count) in
    float32 at every step of an anneal (set_learning_rate), and the buffered
    step writes it before each step."""
    tc = tloop.TrainConfig(lr=1e-3, lr_anneal_steps=5)
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([w], lr=torch.tensor(tc.lr), foreach=False)
    for count in range(8):
        tloop.set_learning_rate(opt, tloop.learning_rate(tc, count))
        assert opt.param_groups[0]["lr"].item() == np.float32(tloop.learning_rate(tc, count))
    assert opt.param_groups[0]["lr"].item() == 0.0  # annealed to 0 past lr_anneal_steps

    tm, sched, dcfg, _ = train_setup("unet")
    tc = tloop.TrainConfig(**{**TRAIN_CFG["unet"], "lr_anneal_steps": 3})
    state = tloop.create_train_state(tm, tc, sched)
    lr = torch.tensor(tc.lr)
    state.optimizer = torch.optim.AdamW(list(state.params.values()), lr=lr, foreach=False,
                                        betas=(0.9, tc.adam_beta2), eps=1e-8,
                                        weight_decay=tc.weight_decay)
    step = tloop.BufferedTrainStep(tm, sched, tc, tloop._step_body(tm, sched, dcfg, tc))
    draws = tloop.StepDraws(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    for count in range(5):
        step(state, torch_batch(make_batch(count)), draws)
        assert state.optimizer.param_groups[0]["lr"] is lr
        assert lr.item() == np.float32(tloop.learning_rate(tc, count))


def test_train_state_keeps_its_learning_rate_tensor_across_a_resume():
    tm, sched, _, tc = train_setup("mdm")
    state = tloop.create_train_state(tm, tc, sched)
    lr = torch.tensor(0.5)
    state.optimizer.param_groups[0]["lr"] = lr
    saved = state.state_dict()
    saved["optimizer"]["param_groups"][0]["lr"] = torch.tensor(2e-4)
    state.load_state_dict(saved)
    assert state.optimizer.param_groups[0]["lr"] is lr and lr.item() == np.float32(2e-4)


# --------------------------------------------------------------------------- #
# the pieces of a graph's key, the caches, the timestep map
# --------------------------------------------------------------------------- #
def test_graph_key_follows_weights_optimizer_steps_and_swaps(monkeypatch, small):
    model = TorchUNet(**SMALL, device="cpu", seed=4)
    graph = CudaGraph(lambda: None, [model, model])
    assert len(tensors_of([model, model])) == len(list(model.parameters())) + len(
        list(model.buffers()))
    key = graph.validity_key()
    with torch.no_grad():
        model(torch.zeros(B, T, F), torch.zeros(B, dtype=torch.long),
              {"text_embed": small["text"]}, obs_x0=small["obs"], obs_mask=small["mask"])
    assert graph.validity_key() == key  # a forward changes nothing
    model.load_state_dict(TorchUNet(**SMALL, device="cpu", seed=5).state_dict())
    assert graph.validity_key() != key
    key = graph.validity_key()
    weight_cache.advance()  # an optimizer's step anywhere
    assert graph.validity_key() != key
    key = graph.validity_key()
    import condmdi_tpu_torch.ops.attention as attention

    monkeypatch.setattr(attention, "_launch", lambda q, k, v, h: attention._xla_attention(
        q, k, v, h))
    assert implementation_key() != key[0] and graph.validity_key() != key


def test_networks_of_finds_the_modules_behind_an_apply_fn(small):
    model = small["model"]

    def apply_fn(x, t, y, **_):
        return model(x, t, y)

    assert networks_of(model) == [model] and networks_of(apply_fn) == [model]
    assert networks_of(lambda x, t, y: x) == []
    assert branch_of(apply_fn) is None


def test_a_wrapped_mixed_denoiser_keeps_its_branches(mixed_pair):
    """A mixed denoiser behind a wrapper (a bf16 cast, as the server wraps it) is
    still found: its networks key the graphs and its branch splits them."""
    _, mixed, _ = mixed_pair

    def bf16_apply(x, t, y, **kw):
        return mixed(x.to(torch.bfloat16), t, y, **kw).float()

    assert networks_of(bf16_apply) == [mixed.model, mixed.twin]
    assert branch_of(bf16_apply) == mixed.branch
    pipe = SamplePipeline(bf16_apply, schedule(steps=10), DiffusionConfig(), device="cpu")
    prog = SamplingProgram(pipe, (B, 28, F), {"text_embed": torch.zeros(B, 512)}, 2.5, None,
                           None, None, buffered=True)
    assert [prog._branch(ti) for ti in (9, 1, 0)] == ["int8", "int8", "float"]


def test_caches_repack_in_place_while_a_train_step_is_captured():
    w = torch.nn.Parameter(torch.randn(8, 40, 5))
    cache = PackedConvWeight()
    first = cache.get(w)
    with weight_cache.repack_on_every_call():
        assert weight_cache.repacking()
        with torch.no_grad():
            w.mul_(2.0)
        held = cache.get(w)
        assert held is first and torch.equal(held, packed_for_kernel(w.detach()))
    assert not weight_cache.repacking()
    with torch.no_grad():
        w.add_(1.0)
    assert cache.get(w) is first  # pinned: the graph keeps reading this tensor
    assert torch.equal(first, packed_for_kernel(w.detach()))

    q = QuantizedWeight()
    weight, bias = torch.randn(6, 8, 3), torch.randn(6)
    before = q.get(weight, bias)
    with weight_cache.repack_on_every_call():
        weight.mul_(-1.0)
        after = q.get(weight, bias)
    assert all(a is b for a, b in zip(after, before) if a is not None)
    assert torch.equal(after.wq, -QuantizedWeight().get(-weight, bias).wq)


@pytest.mark.parametrize("rescale", [False, True])
def test_host_timestep_map_is_model_t(rescale):
    sched = schedule(steps=10, rescale=rescale)
    for ti in range(sched.num_timesteps):
        want = sched.model_t(torch.tensor([ti]))[0]
        host = sched.model_t_host(ti)
        assert host == (want.item() if rescale else int(want))
    assert sched.to("cpu").host_timestep_map == sched.host_timestep_map
