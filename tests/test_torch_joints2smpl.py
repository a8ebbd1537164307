"""joints2smpl on the port against the JAX package, on the CPU:

  * one torch.optim.Adam update equals optax.adam's (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias correction) over three steps, within 1e-6;
  * `fit_smpl_to_joints`, 20 steps from the same targets on the same synthetic
    body: the fitted pose, translation and betas and the last loss within 1e-4
    of the JAX scan's; the fitted mesh within 1e-4;
  * `save_obj` writes JAX's file byte for byte;
  * `render_mesh_cli` on a results.npy the test writes (the default 300 steps):
    the same frames, the last loss and every vertex within 1e-3 of JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from condmdi_tpu.geometry import rotations as jrot
from condmdi_tpu.models import smpl as jsmpl
from condmdi_tpu.viz import joints2smpl as jj2s
from condmdi_tpu_torch.models import smpl as tsmpl
from condmdi_tpu_torch.viz import joints2smpl as tj2s

FIT_TOL = 1e-4
CLI_TOL = 1e-3


@pytest.fixture(scope="module")
def models():
    return (jsmpl.SMPLModel.random_init(n_vertices=80, seed=0),
            tsmpl.SMPLModel.random_init(n_vertices=80, seed=0, device="cpu"))


def targets(jm, T=4, seed=1):
    rng = np.random.default_rng(seed)
    pose = jnp.asarray(rng.normal(0, 0.2, (T, 24, 3)).astype(np.float32))
    trans = jnp.asarray(rng.normal(0, 0.5, (T, 3)).astype(np.float32))
    R = jrot.axis_angle_to_matrix(pose)
    _, j = jsmpl.lbs(jm, jnp.zeros((T, 10)), R[:, 0], R[:, 1:])
    return np.array(j[:, :22] - j[:, :1] + trans[:, None, :])


def test_adam_update_equals_optax():
    import optax

    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 30.0)]
    opt = optax.adam(0.05)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([tp], lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_fit_20_steps_matches_jax(models):
    jm, tm = models
    target = targets(jm)
    cfg = dict(num_steps=20, lr=0.03)
    jparams, jloss = jj2s.fit_smpl_to_joints(jm, jnp.asarray(target), jj2s.FitConfig(**cfg))
    tparams, tloss = tj2s.fit_smpl_to_joints(tm, torch.from_numpy(target), tj2s.FitConfig(**cfg))
    for k in ("pose", "trans", "betas"):
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=0,
                                   atol=FIT_TOL, err_msg=k)
    assert abs(float(tloss) - float(jloss)) <= FIT_TOL * (1 + abs(float(jloss)))
    # the fit moves: the loss after 20 steps is below the start's
    start = tj2s.fit_loss(tm, torch.from_numpy(target), {
        "pose": torch.zeros((4, 24, 3)), "trans": torch.from_numpy(target[:, 0]),
        "betas": torch.zeros(10)}, tj2s.FitConfig(**cfg))
    assert float(tloss) < float(start)
    with torch.no_grad():
        tv = tj2s.smpl_mesh_from_params(tm, tparams).numpy()
    jv = np.asarray(jj2s.smpl_mesh_from_params(jm, jparams))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=FIT_TOL)


def test_save_obj_writes_jax_file(tmp_path):
    v = np.random.default_rng(3).standard_normal((5, 3))
    f = np.array([[0, 1, 2], [2, 3, 4]])
    jpath = jj2s.save_obj(v, f, tmp_path / "jax" / "x.obj")
    tpath = tj2s.save_obj(v, f, tmp_path / "port" / "x.obj")
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tj2s.save_obj(v, None, tmp_path / "nf.obj").read_text().count("f ") == 0


def test_render_mesh_cli_matches_jax(models, tmp_path):
    jm, tm = models
    target = targets(jm, T=3, seed=4)
    results = tmp_path / "results.npy"
    np.save(results, {"joints": np.stack([target * 0.5, target])}, allow_pickle=True)
    jpaths, jloss = jj2s.render_mesh_cli(str(results), str(tmp_path / "jax"), sample_idx=1,
                                         model=jm)
    tpaths, tloss = tj2s.render_mesh_cli(str(results), str(tmp_path / "port"), sample_idx=1,
                                         model=tm)
    assert [p.name for p in tpaths] == [p.name for p in jpaths] == \
        ["frame000.obj", "frame001.obj", "frame002.obj"]
    assert abs(tloss - jloss) <= CLI_TOL * (1 + abs(jloss))
    for tp, jp in zip(tpaths, jpaths):
        tv = np.array([[float(c) for c in line.split()[1:]] for line in tp.read_text().splitlines()])
        jv = np.array([[float(c) for c in line.split()[1:]] for line in jp.read_text().splitlines()])
        np.testing.assert_allclose(tv, jv, rtol=0, atol=CLI_TOL)


def test_fit_on_cpu_ignores_cuda_graphs(models):
    """cuda_graphs only acts on the card: on the CPU both settings run the same
    eager steps."""
    jm, tm = models
    target = torch.from_numpy(targets(jm, T=2, seed=5))
    cfg = tj2s.FitConfig(num_steps=3)
    a, la = tj2s.fit_smpl_to_joints(tm, target, cfg, cuda_graphs=True)
    b, lb = tj2s.fit_smpl_to_joints(tm, target, cfg, cuda_graphs=False)
    assert torch.equal(la, lb) and all(torch.equal(a[k], b[k]) for k in a)
