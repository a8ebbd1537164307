"""The SMPL body model on the port against the JAX package, on the CPU:

  * `SMPLModel.random_init` replays the JAX draws: every array equal;
  * `lbs` vertices and joints within 1e-5 on random poses and betas;
  * `SMPLWrapper`'s joint maps equal;
  * `Rotation2xyz` in every pose representation and option (glob / glob_rot,
    translation, vertstrans, betas / beta, the four joint types and the
    vertices) within 1e-5;
  * `from_files` on an SMPL_NEUTRAL.npz (+ J_regressor_extra.npy) the test
    writes: the same model in both; `weights.smpl_model_from_arrays` takes the
    JAX model's arrays;
  * `training_losses` with `get_xyz` a Rotation2xyz closure (the a2m layout,
    25 x 6 rot6d features): the rcxyz and fc terms and the loss within 1e-5, and
    the gradient of the loss through SMPL against jax.grad.
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.diffusion import gaussian as jg
from condmdi_tpu.diffusion import schedule as js
from condmdi_tpu.geometry import rotations as jrot
from condmdi_tpu.models import smpl as jsmpl
from condmdi_tpu_torch.diffusion import gaussian as tg
from condmdi_tpu_torch.diffusion import schedule as ts
from condmdi_tpu_torch.geometry import rotations as trot
from condmdi_tpu_torch.models import smpl as tsmpl
from condmdi_tpu_torch.weights import smpl_model_from_arrays

TOL = 1e-5
V = 120


def arrays_of(model):
    return {f.name: (None if getattr(model, f.name) is None else np.asarray(getattr(model, f.name)))
            for f in fields(model)}


@pytest.fixture(scope="module")
def models():
    return jsmpl.SMPLModel.random_init(n_vertices=V, seed=3), \
        tsmpl.SMPLModel.random_init(n_vertices=V, seed=3, device="cpu")


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * (1 + np.abs(want).max()))


def test_random_init_replays_the_jax_draws(models):
    jm, tm = models
    for name, want in arrays_of(jm).items():
        got = getattr(tm, name)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    same = smpl_model_from_arrays(arrays_of(jm), device="cpu")
    for f in fields(tm):
        a, b = getattr(same, f.name), getattr(tm, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def random_pose(n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    aa = (scale * rng.standard_normal((n, 24, 3))).astype(np.float32)
    betas = rng.standard_normal((n, 10)).astype(np.float32)
    return aa, betas


def test_lbs_matches_jax(models):
    jm, tm = models
    aa, betas = random_pose(4, 1)
    jR = jrot.axis_angle_to_matrix(jnp.asarray(aa))
    tR = trot.axis_angle_to_matrix(torch.from_numpy(aa))
    jv, jj = jsmpl.lbs(jm, jnp.asarray(betas), jR[:, 0], jR[:, 1:])
    tv, tj = tsmpl.lbs(tm, torch.from_numpy(betas), tR[:, 0], tR[:, 1:])
    close(tv, jv)
    close(tj, jj)
    none, joints_only = tsmpl.lbs(tm, torch.from_numpy(betas), tR[:, 0], tR[:, 1:],
                                  return_vertices=False)
    assert none is None and torch.equal(joints_only, tj)


def test_wrapper_maps_match_jax(models):
    jm, tm = models
    jw, tw = jsmpl.SMPLWrapper(jm), tsmpl.SMPLWrapper(tm)
    assert set(jw.maps) == set(tw.maps)
    for k in jw.maps:
        np.testing.assert_array_equal(tw.maps[k], jw.maps[k])


def _rotations(pose_rep, B, T, J, seed):
    rng = np.random.default_rng(seed)
    aa = (0.5 * rng.standard_normal((B, T, J, 3))).astype(np.float32)
    m = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    if pose_rep == "rotvec":
        x = aa
    elif pose_rep == "rotmat":
        x = m.reshape(B, T, J, 9)
    elif pose_rep == "rotquat":
        x = np.asarray(jrot.matrix_to_quaternion(jnp.asarray(m)))
    else:  # rot6d, perturbed off the manifold (Gram-Schmidt takes it back)
        x = np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(m)))
        x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    return x.astype(np.float32)


CASES = [
    # (pose_rep, options)
    ("rot6d", dict(translation=True, glob=True, jointstype="smpl", vertstrans=False)),
    ("rot6d", dict(translation=True, glob=True, jointstype="smpl", vertstrans=True)),
    ("rotvec", dict(translation=True, glob=True, jointstype="a2m", vertstrans=True, beta=0.7)),
    ("rotmat", dict(translation=False, glob=True, jointstype="a2mpl")),
    ("rotquat", dict(translation=True, glob=False, glob_rot=[3.14159, 0.0, 0.0],
                     jointstype="smpl")),
    ("rot6d", dict(translation=True, glob=True, jointstype="vertices", vertstrans=True)),
    ("rot6d", dict(translation=True, glob=True, jointstype="smpl", betas="given")),
]


@pytest.mark.parametrize("pose_rep,opts", CASES,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(CASES)])
def test_rotation2xyz_matches_jax(models, pose_rep, opts):
    jm, tm = models
    B, T = 2, 3
    J = 24 if opts.get("glob", True) else 23
    x = _rotations(pose_rep, B, T, J, seed=5)
    if opts.get("translation", True):
        trans = np.zeros((B, T, 1, x.shape[-1]), np.float32)
        trans[..., :3] = np.random.default_rng(6).standard_normal((B, T, 1, 3)) * 0.3
        x = np.concatenate([x, trans], axis=2)
    opts = dict(opts)
    jopts, topts = dict(opts), dict(opts)
    if opts.get("betas") == "given":
        betas = np.random.default_rng(7).standard_normal((B * T, 10)).astype(np.float32)
        jopts["betas"], topts["betas"] = jnp.asarray(betas), torch.from_numpy(betas)
    want = jsmpl.Rotation2xyz(jsmpl.SMPLWrapper(jm))(jnp.asarray(x), pose_rep=pose_rep, **jopts)
    got = tsmpl.Rotation2xyz(tsmpl.SMPLWrapper(tm))(torch.from_numpy(x), pose_rep=pose_rep,
                                                    **topts)
    close(got, want)


def test_xyz_passes_through(models):
    _, tm = models
    x = torch.randn(2, 5, 22, 3)
    assert tsmpl.Rotation2xyz(tsmpl.SMPLWrapper(tm))(x, pose_rep="xyz") is x


def test_from_files_reads_what_jax_reads(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    J, n = 24, 50
    kintree = np.stack([np.array([2**32 - 1] + list(tsmpl.SMPL_PARENTS[1:]), np.int64),
                        np.arange(J)])
    np.savez(tmp_path / "SMPL_NEUTRAL.npz",
             v_template=rng.standard_normal((n, 3)), shapedirs=rng.standard_normal((n, 3, 300)),
             posedirs=rng.standard_normal((n, 3, (J - 1) * 9)),
             J_regressor=rng.random((J, n)), kintree_table=kintree,
             weights=rng.random((n, J)))
    np.save(tmp_path / "J_regressor_extra.npy", rng.random((9, n)))
    monkeypatch.setenv("CONDMDI_BODY_MODELS", str(tmp_path))
    jm = jsmpl.SMPLModel.from_files()
    tm = tsmpl.SMPLModel.from_files(device="cpu")
    for name, want in arrays_of(jm).items():
        np.testing.assert_array_equal(getattr(tm, name).numpy(), want, err_msg=name)
    assert tm.parents_host[0] == -1 and tm.num_betas == 10


def test_from_files_raises_where_there_are_none(tmp_path, monkeypatch):
    monkeypatch.delenv("CONDMDI_BODY_MODELS", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tsmpl.SMPLModel.from_files(device="cpu")


# --------------------------------------------------------------------------- #
# the SMPL losses of training_losses
# --------------------------------------------------------------------------- #
B_L, T_L, NJ = 2, 12, 25


def loss_setup(models, seed=21):
    jm, tm = models
    rng = np.random.default_rng(seed)
    F = NJ * 6
    # a smooth motion (small steps) and a faster one, so that some foot velocities
    # fall under the fc term's 0.01 threshold and some do not
    base = rng.standard_normal((B_L, 1, F)).astype(np.float32)
    step = np.array([0.002, 0.05], np.float32)[:, None, None]  # a slow and a fast one
    x0 = (base + np.cumsum(step * rng.standard_normal((B_L, T_L, F)), axis=1)).astype(np.float32)
    noise = rng.standard_normal((B_L, T_L, F)).astype(np.float32)
    t = np.array([1, 5], np.int64)
    lengths = np.array([T_L, T_L - 3])
    time_mask = np.arange(T_L)[None] < lengths[:, None]
    W = (0.3 * rng.standard_normal((F, F)) / np.sqrt(F)).astype(np.float32)

    jr = jsmpl.Rotation2xyz(jsmpl.SMPLWrapper(jm))
    tr = tsmpl.Rotation2xyz(tsmpl.SMPLWrapper(tm))

    def jxyz(x):
        return jr(x.reshape(x.shape[0], x.shape[1], NJ, 6), pose_rep="rot6d")

    def txyz(x):
        return tr(x.reshape(x.shape[0], x.shape[1], NJ, 6), pose_rep="rot6d")

    betas = js.get_named_beta_schedule("cosine", 10)
    jsched, tsched = js.DiffusionSchedule.create(betas), ts.DiffusionSchedule.create(betas)
    kw = dict(lambda_rcxyz=1.0, lambda_fc=1.0, lambda_vel=0.5)
    jcfg = jg.DiffusionConfig(model_mean_type=jg.ModelMeanType("start_x"), **kw)
    tcfg = tg.DiffusionConfig(model_mean_type=tg.ModelMeanType("start_x"), **kw)
    return dict(x0=x0, noise=noise, t=t, time_mask=time_mask, W=W, jxyz=jxyz, txyz=txyz,
                jsched=jsched, tsched=tsched, jcfg=jcfg, tcfg=tcfg)


def test_smpl_loss_terms_match_jax(models):
    s = loss_setup(models)
    x0 = s["x0"]

    def jfn(x, t):
        return jnp.asarray(x0) + jnp.tanh(x @ s["W"]) * 0.3

    def tfn(x, t):
        return torch.from_numpy(x0) + torch.tanh(x @ torch.from_numpy(s["W"])) * 0.3

    want = jg.training_losses(jfn, s["jsched"], s["jcfg"], jnp.asarray(x0), jnp.asarray(s["t"]),
                              jnp.asarray(s["noise"]), jnp.asarray(s["time_mask"]),
                              get_xyz=s["jxyz"])
    got = tg.training_losses(tfn, s["tsched"], s["tcfg"], torch.from_numpy(x0),
                             torch.from_numpy(s["t"]), torch.from_numpy(s["noise"]),
                             torch.from_numpy(s["time_mask"]), get_xyz=s["txyz"])
    assert {"rcxyz_mse", "fc", "loss"} <= set(got) and set(got) == set(want)
    # the fc mask is neither empty nor full on this motion
    gt = np.asarray(s["jxyz"](jnp.asarray(x0)))[:, :, [7, 10, 8, 11]]
    moving = np.linalg.norm(gt[:, 1:] - gt[:, :-1], axis=-1) <= 0.01
    assert 0 < moving.mean() < 1
    for key in want:
        close(got[key], want[key])


def test_smpl_loss_gradient_matches_jax(models):
    s = loss_setup(models, seed=22)
    x0 = s["x0"]

    def jloss(W):
        def jfn(x, t):
            return jnp.asarray(x0) + jnp.tanh(x @ W) * 0.3

        return jnp.mean(jg.training_losses(
            jfn, s["jsched"], s["jcfg"], jnp.asarray(x0), jnp.asarray(s["t"]),
            jnp.asarray(s["noise"]), jnp.asarray(s["time_mask"]), get_xyz=s["jxyz"])["loss"])

    want = jax.grad(jloss)(jnp.asarray(s["W"]))
    W = torch.from_numpy(s["W"]).requires_grad_(True)

    def tfn(x, t):
        return torch.from_numpy(x0) + torch.tanh(x @ W) * 0.3

    tg.training_losses(tfn, s["tsched"], s["tcfg"], torch.from_numpy(x0),
                       torch.from_numpy(s["t"]), torch.from_numpy(s["noise"]),
                       torch.from_numpy(s["time_mask"]), get_xyz=s["txyz"])["loss"].mean().backward()
    close(W.grad, want, 1e-4)
