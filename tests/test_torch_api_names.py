"""The last public names of the JAX package that the port lacked, against JAX on the
CPU: the 6D rotation (`cont6d_to_matrix`, `Skeleton.forward_kinematics_cont6d`,
`recover_from_rot`), `qslerp` and `lerp` with their gradients, the KIT skeleton and
`Skeleton.offsets_from_reference_pose`, `GaussianDiffusion`, `GuidanceParams`,
`create_model_and_diffusion` and `conv1d_f32`. Each tolerance is stated beside its
comparison; the inputs are made with numpy and handed to both frameworks."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.data import humanml_repr as jrepr
from condmdi_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from condmdi_tpu.diffusion.sampling import GuidanceParams as JaxGuidance
from condmdi_tpu.geometry import quaternion as jq
from condmdi_tpu.geometry import skeleton as jskel
from condmdi_tpu.models import factory as jfactory
from condmdi_tpu.ops.quant import conv1d_f32 as jax_conv1d_f32
from condmdi_tpu.utils import config as jconfig
from condmdi_tpu_torch import data as tdata
from condmdi_tpu_torch import diffusion as tdiffusion
from condmdi_tpu_torch import geometry as tgeometry
from condmdi_tpu_torch import models as tmodels
from condmdi_tpu_torch.data import humanml_repr as trepr
from condmdi_tpu_torch.diffusion import gaussian as tgauss
from condmdi_tpu_torch.geometry import quaternion as tq
from condmdi_tpu_torch.geometry import skeleton as tskel
from condmdi_tpu_torch.models import factory as tfactory
from condmdi_tpu_torch.ops.quant import conv1d_f32
from condmdi_tpu_torch.utils import config as tconfig

TOL = 1e-5  # float32 on both sides, the same operations in the same order up to fusion


def rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("package", ["data", "diffusion", "geometry", "models", "evals", "ops",
                                     "sampling", "training", "utils"])
def test_packages_export_the_names_jax_exports(package):
    """Each subpackage's `__init__` re-exports every name JAX's `__init__` imports
    (read from its source, so that submodules other tests happened to import do
    not count)."""
    import ast
    import importlib
    from pathlib import Path

    init = Path(importlib.import_module(f"condmdi_tpu.{package}").__file__)
    wanted = {alias.asname or alias.name for node in ast.parse(init.read_text()).body
              if isinstance(node, ast.ImportFrom) for alias in node.names}
    tpkg = importlib.import_module(f"condmdi_tpu_torch.{package}")
    assert wanted and wanted <= set(vars(tpkg)), sorted(wanted - set(vars(tpkg)))


# ------------------------------------------------------------------- 6D rotations


def test_cont6d_to_matrix_matches_jax():
    c = rng(0).standard_normal((5, 7, 6)).astype(np.float32)
    c[0, 0] = 0.0  # a degenerate input: the eps guards keep it finite on both sides
    c[0, 1, 3:] = c[0, 1, :3]  # y parallel to x
    got = tq.cont6d_to_matrix(torch.from_numpy(c)).numpy()
    want = np.asarray(jq.cont6d_to_matrix(jnp.asarray(c)))
    assert got.shape == (5, 7, 3, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("do_root_rot", [True, False])
def test_forward_kinematics_cont6d_matches_jax(do_root_rot):
    r = rng(1)
    cont6d = r.standard_normal((2, 9, 22, 6)).astype(np.float32)
    root = r.standard_normal((2, 9, 3)).astype(np.float32)
    offsets = (jskel.T2M_RAW_OFFSETS * r.uniform(0.05, 0.4, (22, 1))).astype(np.float32)
    got = tskel.t2m_skeleton.forward_kinematics_cont6d(
        torch.from_numpy(cont6d), torch.from_numpy(root), torch.from_numpy(offsets),
        do_root_rot=do_root_rot).numpy()
    want = np.asarray(jskel.t2m_skeleton.forward_kinematics_cont6d(
        jnp.asarray(cont6d), jnp.asarray(root), jnp.asarray(offsets), do_root_rot=do_root_rot))
    assert got.shape == (2, 9, 22, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("abs_3d", [False, True])
def test_recover_from_rot_matches_jax(abs_3d):
    """Features → joints through the rotation channels, offsets from a reference
    pose (chains of up to 6 bones, so 1e-4: each 3 x 3 product rounds)."""
    r = rng(2)
    data = (0.3 * r.standard_normal((2, 16, 263))).astype(np.float32)
    pose = r.standard_normal((22, 3)).astype(np.float32)
    offsets = tskel.t2m_skeleton.offsets_from_reference_pose(pose)
    np.testing.assert_array_equal(offsets, jskel.t2m_skeleton.offsets_from_reference_pose(pose))
    got = trepr.recover_from_rot(torch.from_numpy(data), 22, torch.from_numpy(offsets),
                                 abs_3d=abs_3d).numpy()
    want = np.asarray(jrepr.recover_from_rot(jnp.asarray(data), 22, jnp.asarray(offsets),
                                             abs_3d=abs_3d))
    assert got.shape == (2, 16, 22, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the package export and the KIT skeleton, passed explicitly
    kit_pose = r.standard_normal((21, 3)).astype(np.float32)
    kit_offsets = tskel.kit_skeleton.offsets_from_reference_pose(kit_pose)
    kit_data = (0.3 * r.standard_normal((1, 8, 251))).astype(np.float32)
    got = tdata.recover_from_rot(torch.from_numpy(kit_data), 21, torch.from_numpy(kit_offsets),
                                 skeleton=tskel.kit_skeleton, abs_3d=abs_3d).numpy()
    want = np.asarray(jrepr.recover_from_rot(jnp.asarray(kit_data), 21, jnp.asarray(kit_offsets),
                                             skeleton=jskel.kit_skeleton, abs_3d=abs_3d))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_kit_skeleton_and_reference_offsets_equal_jax():
    np.testing.assert_array_equal(tskel.KIT_RAW_OFFSETS, jskel.KIT_RAW_OFFSETS)
    assert tskel.KIT_KINEMATIC_CHAIN == jskel.KIT_KINEMATIC_CHAIN
    for t, j in ((tskel.kit_skeleton, jskel.kit_skeleton), (tskel.t2m_skeleton,
                                                            jskel.t2m_skeleton)):
        assert t.parents == j.parents and t.n_joints == j.n_joints
        pose = rng(t.n_joints).standard_normal((t.n_joints, 3)).astype(np.float32)
        np.testing.assert_array_equal(t.offsets_from_reference_pose(pose),
                                      j.offsets_from_reference_pose(pose))


# --------------------------------------------------------------- slerp and lerp


def unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_qslerp_matches_jax_on_both_branches():
    """Random pairs (half of them with a negative dot product: q1 is flipped onto
    the shorter arc), t per row and t as one scalar, and pairs with q0 = q1 (the
    lerp branch, sin θ < 1e-6)."""
    r = rng(3)
    q0 = unit(r.standard_normal((12, 4)))
    q1 = unit(r.standard_normal((12, 4)))
    q1[:6] = -np.abs(q1[:6]) * np.sign(q0[:6])  # negative dot products
    q1[10:] = q0[10:]  # equal pairs
    t = r.uniform(0, 1, 12).astype(np.float32)
    assert (np.sum(q0 * q1, -1)[:6] < 0).all()
    for tt in (t, np.float32(0.3)):
        got = tq.qslerp(torch.from_numpy(q0), torch.from_numpy(q1), torch.as_tensor(tt)).numpy()
        want = np.asarray(jq.qslerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(tt)))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    p0, p1 = r.standard_normal((2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeometry.qslerp(torch.from_numpy(q0), torch.from_numpy(q0), 0.5).numpy(), q0, atol=TOL)
    np.testing.assert_allclose(tq.lerp(torch.from_numpy(p0), torch.from_numpy(p1), 0.25).numpy(),
                               np.asarray(jq.lerp(jnp.asarray(p0), jnp.asarray(p1), 0.25)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("q", [[0.8, 0.2, 0.1, 0.3], [0.5, 0.5, 0.5, 0.5], [1.0, 0.0, 0.0, 0.0],
                               [0.3, -0.6, 0.2, 0.7]])
def test_qslerp_gradient_at_q0_equal_q1_is_finite_and_jaxs(q):
    """At q0 = q1 torch.autograd's gradient (wrt q0, q1 and t) is finite and equal to
    jax.grad's (1e-5) wherever JAX's is finite: there the normalised dot product
    rounds below 1 and both take the same slerp branch. Where it rounds to exactly 1
    JAX's arccos has no derivative and its gradient is NaN, which the port's
    `where`s avoid: there the port's gradient is jax.grad's of the lerp branch
    that both values take."""
    q = np.asarray(q, np.float32)
    t = np.float32(0.3)

    def torch_grads():
        a, b = (torch.tensor(q, requires_grad=True) for _ in range(2))
        tt = torch.tensor(t, requires_grad=True)
        (tq.qslerp(a, b, tt) * torch.arange(1.0, 5.0)).sum().backward()
        return [v.grad.numpy() for v in (a, b, tt)]

    weights = jnp.arange(1.0, 5.0)
    f = lambda a, b, tt: (jq.qslerp(a, b, tt) * weights).sum()  # noqa: E731
    want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(q),
                                                                 jnp.asarray(t))]
    got = torch_grads()
    assert all(np.isfinite(g).all() for g in got)
    if not all(np.isfinite(g).all() for g in want):
        lerp_branch = lambda a, b, tt: (jq.qnormalize(  # noqa: E731
            (1.0 - tt) * jq.qnormalize(a) + tt * jq.qnormalize(b)) * weights).sum()
        want = [np.asarray(g) for g in jax.grad(lerp_branch, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(q), jnp.asarray(t))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


# -------------------------------------------------------------- diffusion wrapper


def both_diffusions(argv):
    targs = tconfig.parse_args(tconfig.CondSyntArgs, argv)
    jargs = jconfig.parse_args(jconfig.CondSyntArgs, argv)
    tsched, tcfg = tfactory.create_gaussian_diffusion(targs)
    jsched, jcfg = jfactory.create_gaussian_diffusion(jargs)
    return tdiffusion.GaussianDiffusion(tsched, tcfg), JaxDiffusion(jsched, jcfg)


@pytest.mark.parametrize("argv", [["--diffusion_steps", "50"],
                                  ["--diffusion_steps", "50", "--predict_xstart", "false"]])
def test_gaussian_diffusion_methods_match_jax(argv):
    """Each member against JAX's (1e-5, except p_mean_variance's log variance, 1e-4
    at its largest magnitudes), and against the port's module function it wraps
    (bit for bit)."""
    tdiff, jdiff = both_diffusions(argv)
    assert tdiff.num_timesteps == jdiff.num_timesteps == 50
    r = rng(5)
    B, T, F = 3, 8, 6
    x0, xt, noise = (r.standard_normal((B, T, F)).astype(np.float32) for _ in range(3))
    t = np.array([0, 17, 49])
    W = (0.3 * r.standard_normal((F, F))).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 5:] = False
    tx0, txt, tnoise, tt = (torch.from_numpy(a) for a in (x0, xt, noise, t))
    jx0, jxt, jnoise, jt = (jnp.asarray(a) for a in (x0, xt, noise, t))

    def tden(x, tm):
        return (x @ torch.from_numpy(W)) * (1.0 + tm.float() / 1000.0)[:, None, None]

    def jden(x, tm):
        return (x @ jnp.asarray(W)) * (1.0 + tm.astype(jnp.float32) / 1000.0)[:, None, None]

    np.testing.assert_allclose(tdiff.q_sample(tx0, tt, tnoise).numpy(),
                               np.asarray(jdiff.q_sample(jx0, jt, jnoise)), atol=TOL, rtol=0)
    assert torch.equal(tdiff.q_sample(tx0, tt, tnoise), tgauss.q_sample(tdiff.sched, tx0, tt,
                                                                        tnoise))
    for got, want in zip(tdiff.q_posterior_mean_variance(tx0, txt, tt),
                         jdiff.q_posterior_mean_variance(jx0, jxt, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    with torch.no_grad():
        got = tdiff.p_mean_variance(tden, txt, tt)
        direct = tgauss.p_mean_variance(tden, tdiff.sched, tdiff.cfg, txt, tt)
    want = jdiff.p_mean_variance(jden, jxt, jt)
    for key in ("mean", "pred_xstart", "variance", "log_variance"):
        assert torch.equal(got[key], direct[key])
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4 if key == "log_variance" else TOL, rtol=0)
    with torch.no_grad():
        got = tdiff.training_losses(tden, tx0, tt, tnoise, torch.from_numpy(mask))
    want = jdiff.training_losses(jden, jx0, jt, jnoise, jnp.asarray(mask))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=TOL, rtol=1e-5)


def test_guidance_params_is_jaxs_frozen_dataclass():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(tdiffusion.GuidanceParams) == fields(JaxGuidance) == [("use_cond_fn", False)]
    params = tdiffusion.GuidanceParams(use_cond_fn=True)
    with pytest.raises(dataclasses.FrozenInstanceError):
        params.use_cond_fn = False
    assert params == tdiffusion.GuidanceParams(True) != tdiffusion.GuidanceParams()


def test_create_model_and_diffusion_returns_jaxs_triple():
    """(model, sched, cfg), as the JAX factory returns them: the model `create_model`
    builds on the device asked for, the schedule and config of
    `create_gaussian_diffusion`, equal to JAX's."""
    argv = ["--arch", "unet", "--latent_dim", "16", "--dim_mults", "1", "2",
            "--unet_pad_to", "24", "--diffusion_steps", "20"]
    targs = tconfig.parse_args(tconfig.CondSyntArgs, argv)
    jargs = jconfig.parse_args(jconfig.CondSyntArgs, argv)
    model, sched, cfg = tmodels.create_model_and_diffusion(targs, device="cpu")
    jmodel, jsched, jcfg = jfactory.create_model_and_diffusion(jargs)
    assert type(model).__name__ == type(jmodel).__name__ == "MDM_UNET"
    assert next(model.parameters()).device.type == "cpu"
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in tfactory.create_model(targs, "cpu").state_dict().items()}
    assert sched.num_timesteps == jsched.num_timesteps == 20
    np.testing.assert_allclose(sched.alphas_cumprod.numpy(), np.asarray(jsched.alphas_cumprod),
                               rtol=1e-6, atol=0)
    assert cfg.model_mean_type.name == jcfg.model_mean_type.name
    assert cfg == tfactory.create_gaussian_diffusion(targs)[1]


# ---------------------------------------------------------------------- conv1d_f32


@pytest.mark.parametrize("stride,padding,bias", [(1, 2, True), (2, 1, False), (1, 0, True)])
def test_conv1d_f32_matches_jax(stride, padding, bias):
    r = rng(7)
    x = r.standard_normal((2, 13, 10)).astype(np.float32)  # NWC
    w = (0.3 * r.standard_normal((5, 10, 6))).astype(np.float32)  # WIO
    b = r.standard_normal(6).astype(np.float32) if bias else None
    got = conv1d_f32(torch.from_numpy(x), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), stride, padding).numpy()
    want = np.asarray(jax_conv1d_f32(jnp.asarray(x), jnp.asarray(w),
                                     None if b is None else jnp.asarray(b), stride, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
