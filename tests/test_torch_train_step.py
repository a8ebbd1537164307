"""The port's train step against the JAX package's, on the CPU.

  * the optimizer chain (optax's global-norm clip, AdamW with weight decay on
    every leaf, the linear anneal read before the count's increment) against
    optax over 5 steps of injected gradients, within 1e-6 relative;
  * three whole train steps of the small keyframe UNet, the small MDM and the
    small DiT (condition dropout on; dropout on in MDM and DiT, at the cards'
    0.1) against `make_train_step(..., raw=True)`, JAX's draws (t, noise,
    keyframe mask, keyframe drop, the condition keep vector, every dropout
    mask, read from Flax's nn.Dropout in its call order) replayed into the
    port's step, each mask used once, at the configs' lr 1e-4: params and
    EMA within 1e-5 * (1 + |jax|) and metrics within 1e-5 * (1 + |jax|); the
    attention's key bias, whose gradient is zero up to rounding (softmax
    ignores a constant added to every key), is moved by Adam's normalised
    rounding noise in both frameworks and is held to the most Adam can move
    it, 2 * lr a step;
  * one step with use_bf16 (bfloat16 activations into float32 parameters,
    JAX's promotion) against JAX's: the loss within 2e-3 relative (bfloat16's
    rounding of the first convolution's operands, placed differently);
  * LossAwareState against JAX's for the same (t, loss) history;
  * the loss decreases over 15 steps of the small MDM on one batch (as
    tests/test_training.py asserts); remat gives the plain step's result; the
    model's dropout and condition dropout draw from the step's generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from condmdi_tpu.diffusion import gaussian as jg
from condmdi_tpu.diffusion import schedule as js
from condmdi_tpu.diffusion.resample import LossAwareState as JaxLossAware
from condmdi_tpu.training import loop as jloop
from condmdi_tpu_torch.diffusion import gaussian as tg
from condmdi_tpu_torch.diffusion import schedule as ts
from condmdi_tpu_torch.diffusion.resample import LossAwareState, create_named_schedule_sampler
from condmdi_tpu_torch.models.layers import TrainDraws, dropout
from condmdi_tpu_torch.training import loop as tloop
from condmdi_tpu_torch.weights import to_flax_params
from torch_train_helpers import (
    STEPS,
    assert_close,
    jax_batch,
    jax_step_draws,
    make_batch,
    model_pair,
    torch_batch,
)
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

OPT_TOL = 1e-6
STEP_TOL = 1e-5
BF16_LOSS_TOL = 2e-3


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def schedules():
    betas = js.get_named_beta_schedule("cosine", STEPS)
    return js.DiffusionSchedule.create(betas), ts.DiffusionSchedule.create(betas)


# --------------------------------------------------------------------------- #
# the optimizer chain
# --------------------------------------------------------------------------- #
def test_optimizer_chain_matches_optax():
    cfg = dict(lr=3e-3, weight_decay=0.05, adam_beta2=0.99, grad_clip=1.0, lr_anneal_steps=4)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (0.05, 2.0, 0.01, 5.0, 0.3)]  # under and over the clip
    opt = jloop.make_optimizer(jloop.TrainConfig(**cfg))
    jp, state = dict(params), opt.init(params)
    tcfg = tloop.TrainConfig(**cfg)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = tloop.make_optimizer(tp.values(), tcfg)
    for step, g in enumerate(grads):
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        gl = [p.grad for p in tp.values()]
        norm = tloop.global_norm(gl)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=OPT_TOL)
        tloop.clip_by_global_norm_(gl, tcfg.grad_clip, norm)
        for group in topt.param_groups:
            group["lr"] = tloop.learning_rate(tcfg, step)
        topt.step()
        for k in params:
            assert_close(tp[k].detach().numpy(), jp[k], OPT_TOL)


def test_learning_rate_reads_the_count_before_the_update():
    cfg = tloop.TrainConfig(lr=1e-3, lr_anneal_steps=5)
    sched = optax.linear_schedule(1e-3, 0.0, 5)
    for count in range(8):
        np.testing.assert_allclose(tloop.learning_rate(cfg, count), float(sched(count)),
                                   rtol=1e-6, atol=1e-12)
    assert tloop.learning_rate(tloop.TrainConfig(lr=2e-4), 100) == 2e-4


# --------------------------------------------------------------------------- #
# whole train steps with JAX's draws replayed
# --------------------------------------------------------------------------- #
STEP_CONFIGS = {
    "unet": dict(lr=1e-4, weight_decay=0.01, grad_clip=1.0, avg_model_beta=0.9,
                 lr_anneal_steps=10, keyframe_conditioned=True, keyframe_mask_prob=0.5),
    "mdm": dict(lr=1e-4, weight_decay=0.01, grad_clip=0.5, avg_model_beta=0.9),
}
STEP_CONFIGS["dit"] = STEP_CONFIGS["mdm"]
DROPOUT = 0.1  # the motion_mdm card's


def setup_pair(kind, use_bf16=False, **model_kw):
    cfg = dict(STEP_CONFIGS[kind], use_bf16=use_bf16)
    kw = dict(cond_mask_prob=0.3)
    if kind != "unet":
        kw["dropout"] = DROPOUT
    jm, params, tm = model_pair(kind, seed=21, **kw, **model_kw)
    jsched, tsched = schedules()
    jtc, ttc = jloop.TrainConfig(**cfg), tloop.TrainConfig(**cfg)
    dcfg_kw = dict(lambda_vel=0.2)
    jstep = jax.jit(jloop.make_train_step(  # the raw step, compiled once here
        lambda p, x, t, y, train=False, rngs=None, **k: jm.apply(p, x, t, y, train=train,
                                                                  rngs=rngs, **k),
        jsched, jg.DiffusionConfig(**dcfg_kw), jtc, raw=True))
    jstate = jloop.create_train_state(params, jtc, jsched)
    tm.train()
    tstep = tloop.make_train_step(tm, tsched, tg.DiffusionConfig(**dcfg_kw), ttc)
    tstate = tloop.create_train_state(tm, ttc, tsched)
    return jm, params, tm, jtc, jstep, jstate, tstep, tstate


@pytest.mark.parametrize("kind", ["unet", "mdm", "dit"])
def test_three_train_steps_match_jax(kind):
    jm, params, tm, jtc, jstep, jstate, tstep, tstate = setup_pair(kind)
    for i in range(3):
        batch = make_batch(30 + i)
        rng = jax.random.key(40 + i)
        draws = jax_step_draws(jm, params, rng, batch, jtc, STEPS)
        jstate, jm_metrics = jstep(jstate, jax_batch(batch), rng)
        tm_metrics = tstep(tstate, torch_batch(batch), draws)
        assert draws.model_draws.used == len(draws.dropout_masks)
        assert (len(draws.dropout_masks) > 0) == (kind != "unet")
        assert set(tm_metrics) == set(jm_metrics)
        for k in jm_metrics:
            assert_close(float(tm_metrics[k]), float(jm_metrics[k]), STEP_TOL)
    assert tstate.step == int(jstate.step) == 3
    got_p, want_p = flat(to_flax_params(tm.state_dict())), flat(jstate.params)
    got_e, want_e = flat(to_flax_params(tstate.ema)), flat(jstate.ema_params)
    assert set(got_p) == set(want_p) == set(got_e)
    lr = STEP_CONFIGS[kind]["lr"]
    for path in want_p:
        for got, want in ((got_p[path], want_p[path]), (got_e[path], want_e[path])):
            if path.endswith("['qkv']['bias']"):
                d = want.shape[0] // 3  # [q | k | v]: the key third is rounding noise
                assert np.abs(got[d:2 * d] - want[d:2 * d]).max() <= 2 * lr * 3
                got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
            assert_close(got, want, STEP_TOL)


def test_bf16_step_follows_jax_promotion():
    """use_bf16 on the keyframe UNet: the same one step in both frameworks."""
    jm, params, tm, jtc, jstep, jstate, tstep, tstate = setup_pair("unet", use_bf16=True)
    batch, rng = make_batch(50), jax.random.key(51)
    draws = jax_step_draws(jm, params, rng, batch, jtc, STEPS)
    _, want = jstep(jstate, jax_batch(batch), rng)
    got = tstep(tstate, torch_batch(batch), draws)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=BF16_LOSS_TOL)
    # the parameters and the EMA stay float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(v.dtype == torch.float32 for v in tstate.ema.values())


def test_bf16_flow_computes_only_the_first_convs_in_bf16():
    """JAX's promotion: the first block's residual conv in bfloat16, its first
    half from bfloat16-rounded operands in float32, everything after float32."""
    _, _, tm = model_pair("unet", seed=2)
    seen = {}
    for name, mod in tm.named_modules():
        if name.endswith(("residual_conv", "block1", "block2", "final_conv")):
            mod.register_forward_hook(
                lambda m, i, o, name=name: seen.setdefault(name, o.dtype) and None)
    b = make_batch(3)
    x = torch.from_numpy(b["motion"]).bfloat16()
    mask = torch.zeros(x.shape, dtype=torch.bool)
    out = tm(x, torch.zeros(4, dtype=torch.long), {"text_embed": torch.from_numpy(b["text_embed"])},
             obs_x0=x, obs_mask=mask)
    assert out.dtype == torch.float32
    assert seen["unet.down0_res1.residual_conv"] == torch.bfloat16
    assert {v for k, v in seen.items() if k != "unet.down0_res1.residual_conv"} == {torch.float32}


# --------------------------------------------------------------------------- #
# the loss-aware sampler
# --------------------------------------------------------------------------- #
def test_loss_aware_state_matches_jax():
    S, K = 6, 3
    rng = np.random.default_rng(5)
    j = JaxLossAware.create(S, history_per_term=K)
    p = LossAwareState.create(S, history_per_term=K)
    for i in range(12):
        ts_ = rng.integers(0, S, 5)
        losses = rng.random(5).astype(np.float32)
        j = j.update(jnp.asarray(ts_), jnp.asarray(losses))
        p = p.update(torch.from_numpy(ts_), torch.from_numpy(losses))
        np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
        np.testing.assert_allclose(p.history.numpy(), np.asarray(j.history), rtol=0, atol=0)
        np.testing.assert_allclose(p.weights().numpy(), np.asarray(j.weights()), rtol=1e-6)
    assert bool((p.counts == K).all())  # warmed: importance weights, not uniform
    t, w = p.sample(4096, torch.Generator().manual_seed(0))
    freq = np.bincount(t.numpy(), minlength=S) / 4096
    np.testing.assert_allclose(freq, p.weights().numpy(), atol=0.03)
    np.testing.assert_allclose(w.numpy(), 1.0 / (S * p.weights().numpy()[t.numpy()]), rtol=1e-6)
    assert create_named_schedule_sampler("uniform", S) is None
    with pytest.raises(NotImplementedError):
        create_named_schedule_sampler("nope", S)


# --------------------------------------------------------------------------- #
# the port's step on its own draws
# --------------------------------------------------------------------------- #
def torch_step(kind, generator_seed=0, **cfg):
    _, _, tm = model_pair(kind, seed=60)
    _, tsched = schedules()
    tc = tloop.TrainConfig(**{**STEP_CONFIGS[kind], **cfg})
    tm.train()
    step = tloop.make_train_step(tm, tsched, tg.DiffusionConfig(), tc)
    state = tloop.create_train_state(tm, tc, tsched)
    draws = tloop.StepDraws(torch.Generator().manual_seed(generator_seed),
                            torch.Generator().manual_seed(generator_seed + 1))
    return tm, step, state, draws


def test_loss_decreases():
    tm, step, state, draws = torch_step("mdm", lr=1e-3, grad_clip=1.0)
    batch = torch_batch(make_batch(70))
    losses = [float(step(state, batch, draws)["loss"]) for _ in range(15)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


@pytest.mark.parametrize("kind", ["unet", "mdm"])
def test_remat_step_matches_plain(kind):
    batch = torch_batch(make_batch(71))
    results = []
    for remat in (False, True):
        tm, step, state, draws = torch_step(kind, remat=remat)
        m = step(state, batch, draws)
        results.append((float(m["loss"]), [p.detach().clone() for p in tm.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_model_draws_come_from_the_step_generator():
    """Dropout and condition dropout in MDM's training forward: a function of
    the generator's state alone, and off outside training."""
    _, _, tm = model_pair("mdm", seed=80, dropout=0.3, cond_mask_prob=0.5)
    b = make_batch(81)
    x, t = torch.from_numpy(b["motion"]), torch.zeros(4, dtype=torch.long)
    y = {"text_embed": torch.from_numpy(b["text_embed"])}
    with torch.no_grad():
        a1 = tm(x, t, y, draws=TrainDraws(torch.Generator().manual_seed(3)))
        a2 = tm(x, t, y, draws=TrainDraws(torch.Generator().manual_seed(3)))
        a3 = tm(x, t, y, draws=TrainDraws(torch.Generator().manual_seed(4)))
        e1, e2 = tm(x, t, y), tm(x, t, y)
    assert torch.equal(a1, a2) and not torch.equal(a1, a3) and torch.equal(e1, e2)
    h = torch.ones(20000)
    kept = dropout(h, 0.25, TrainDraws(torch.Generator().manual_seed(0)))
    assert set(kept.unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert abs(float((kept > 0).float().mean()) - 0.75) < 0.02
    assert dropout(h, 0.25, None) is h
