"""The gate checkpoint's sampler in the port against the JAX package in float32,
from the same noise, at the evaluation protocol's configuration (slow: ~2 min).

`evals.run` samples the gate UNet (save/synthetic_unet_m/gate_ema_000100000.npz)
with the full 1000-step DDPM at guidance 1.0, keyframes from benchmark_sparse at
the committed reports' transition length of 30. The two frameworks draw their
noise from different generators, so the protocol's metrics can only be compared
statistically; this test removes the noise from the comparison: both samplers
start from one x_T and add the same step noise at every step (the port through
`step_noise`, JAX through its `p_mean_variance` in a jitted step with the
sampler's update, condmdi_tpu/diffusion/sampling.py ddpm_sample_loop), on the
JAX package's own loader of the restored Orbax checkpoint and the port's of the
flat npz. Tolerances, measured on these inputs: one forward within FWD_ATOL =
1e-4 (measured 2.9e-5 at |out| up to 13), the sample after 1000 steps within
DDPM_ATOL = 1e-3 (measured 4.7e-5 at |x| up to 31).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_cli_helpers import REPO
from torch_eval_helpers import few_torch_threads  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow

GATE = REPO / "save" / "synthetic_unet_m"
FWD_ATOL = 1e-4
DDPM_ATOL = 1e-3
B, T, F = 2, 196, 263
ARGV = ["--edit_mode", "benchmark_sparse", "--guidance_param", "1.0", "--seed", "10"]


def _step_noise(i):
    return np.random.default_rng((1, i)).standard_normal((B, T, F)).astype(np.float32)


class _StepNoise:
    """The port's step_noise, made on demand (1000 steps at once would take 0.8 GB)."""

    def __getitem__(self, i):
        return torch.from_numpy(_step_noise(i))


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    import importlib.util

    from condmdi_tpu.sampling.synthesize import load_model_for_sampling as jax_load
    from condmdi_tpu.utils.config import EvalArgs as JaxEvalArgs
    from condmdi_tpu.utils.config import parse_args as jax_parse
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling
    from condmdi_tpu_torch.training.keyframes import get_keyframes_mask
    from condmdi_tpu_torch.utils.config import EvalArgs, parse_args

    spec = importlib.util.spec_from_file_location("gate_params_io",
                                                  REPO / "scripts" / "gate_params_io.py")
    gate_params_io = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate_params_io)
    run_dir = tmp_path_factory.mktemp("gate")
    shutil.copy(GATE / "args.json", run_dir / "args.json")
    ckpt = gate_params_io.restore(GATE / "gate_ema_000100000.npz", run_dir)
    jm, params, jsched, jdcfg = jax_load(jax_parse(JaxEvalArgs, ARGV + ["--model_path", str(ckpt)]))
    tm, tsched, tdcfg = load_model_for_sampling(
        parse_args(EvalArgs, ARGV + ["--model_path", str(GATE / "gate_ema_000100000.npz")]), "cpu")
    rng = np.random.default_rng(0)
    inputs = dict(xT=rng.standard_normal((B, T, F)).astype(np.float32),
                  obs=rng.standard_normal((B, T, F)).astype(np.float32),
                  text=rng.standard_normal((B, 512)).astype(np.float32))
    inputs["mask"] = get_keyframes_mask(torch.tensor([196, 150]), T, edit_mode="benchmark_sparse",
                                        trans_length=30, feature_mode="pos_rot_vel",
                                        n_keyframes=5).numpy()
    assert inputs["mask"].any() and jsched.num_timesteps == tsched.num_timesteps == 1000
    return dict(jax=(jm, params, jsched, jdcfg), port=(tm, tsched, tdcfg), **inputs)


def _denoisers(g):
    jm, params = g["jax"][:2]
    tm = g["port"][0]
    yj = {"text_embed": jnp.asarray(g["text"])}
    yt = {"text_embed": torch.from_numpy(g["text"])}
    kj = dict(obs_x0=jnp.asarray(g["obs"]), obs_mask=jnp.asarray(g["mask"]))
    kt = dict(obs_x0=torch.from_numpy(g["obs"]), obs_mask=torch.from_numpy(g["mask"]))
    return (lambda x, t: jm.apply(params, x, t, yj, **kj), lambda x, t: tm(x, t, yt, **kt))


@pytest.mark.parametrize("t", [999, 500, 10])
def test_gate_forward_matches_jax(gate, t):
    jden, tden = _denoisers(gate)
    want = np.asarray(jden(jnp.asarray(gate["xT"]), jnp.full((B,), t)))
    with torch.no_grad():
        got = tden(torch.from_numpy(gate["xT"]), torch.full((B,), t)).numpy()
    assert np.abs(want).max() > 1
    print(f"gate forward at t={t}: max |port - jax| {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def test_gate_ddpm_from_the_same_noise_matches_jax(gate):
    from condmdi_tpu.diffusion.gaussian import p_mean_variance
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig, ddpm_sample_loop

    jden, tden = _denoisers(gate)
    _, _, jsched, jdcfg = gate["jax"]
    _, tsched, tdcfg = gate["port"]

    @jax.jit
    def step(x, t, z):
        out = p_mean_variance(jden, jsched, jdcfg, x, t)
        nonzero = (t != 0).astype(x.dtype).reshape(-1, 1, 1)
        return out["mean"] + nonzero * jnp.exp(0.5 * out["log_variance"]) * z

    x = jnp.asarray(gate["xT"])
    for i, t in enumerate(range(jsched.num_timesteps - 1, -1, -1)):
        x = step(x, jnp.full((B,), t, jnp.int32), jnp.asarray(_step_noise(i)))
    want = np.asarray(x)
    got = ddpm_sample_loop(tden, tsched, tdcfg, (B, T, F), noise=torch.from_numpy(gate["xT"]),
                           sampler=SamplerConfig(), step_noise=_StepNoise()).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 1
    print(f"gate DDPM, 1000 steps: max |port - jax| {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=DDPM_ATOL, rtol=0)
