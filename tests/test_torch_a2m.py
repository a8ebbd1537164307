"""The action-to-motion and unconstrained protocols on the port against the JAX
package, on the CPU:

  * `data.dataset.collate` builds `batch["action"]` as JAX's does (every key
    compared, with and without action labels);
  * `geometry/rotations.py`, every function within 1e-6 (the 12 Euler
    conventions included); `random_quaternions`/`random_rotations` from a
    torch.Generator: unit, orthonormal, repeatable;
  * the a2m datasets: SyntheticA2MDataset bit-exact, HumanAct12/UESTC raising
    FileNotFoundError without their files, and HumanAct12's items from a pickle
    the test writes within 1e-6 (the axis-angle → rot6d conversion);
  * ST-GCN: `build_graph` and `random_params` equal, `convert_stgcn_state_dict`
    equal, the forward within 1e-5; the GRU classifier (random init and a
    checkpoint the test writes) within 1e-5; `evaluate_a2m` within 1e-5;
  * `evals/unconstrained.py` bit-exact;
  * `run_a2m` (humanact12 and uestc) and `run_unconstrained` through `main` at
    tests/test_eval_cli.py's flags, from one x_T with no step noise in both
    frameworks: the JAX report's keys and meta, finite, and JAX's numbers
    (accuracy equal, the rest within 1e-4); a flat npz as --model_path (the
    port's own noise), an Orbax directory refused.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.data import a2m as ja2m
from condmdi_tpu.data.dataset import collate as jax_collate
from condmdi_tpu.evals import a2m as jeval
from condmdi_tpu.evals import stgcn as jstgcn
from condmdi_tpu.evals import unconstrained as junc
from condmdi_tpu.geometry import rotations as jrot
from condmdi_tpu_torch.data import a2m as ta2m
from condmdi_tpu_torch.data.dataset import collate as port_collate
from condmdi_tpu_torch.evals import a2m as teval
from condmdi_tpu_torch.evals import stgcn as tstgcn
from condmdi_tpu_torch.evals import unconstrained as tunc
from condmdi_tpu_torch.geometry import rotations as trot
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

ROT_TOL = 1e-6
NET_TOL = 1e-5


# --------------------------------------------------------------------------- #
# collate
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("labelled", ["all", "some", "none"])
def test_collate_builds_the_action_labels_as_jax(labelled):
    items = [dict(s) for s in ja2m.SyntheticA2MDataset(size=5, num_frames=12, seed=3).items]
    items[1]["motion"] = items[1]["motion"][:7]  # a short one, padded
    if labelled != "all":
        for i, s in enumerate(items):
            if labelled == "none" or i % 2:
                del s["action"]
    want, got = jax_collate(items, 12), port_collate(items, 12)
    assert set(got) == set(want)
    assert ("action" in got) == (labelled != "none")
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


# --------------------------------------------------------------------------- #
# rotations
# --------------------------------------------------------------------------- #
def _rot_inputs():
    rng = np.random.default_rng(0)
    aa = rng.standard_normal((64, 3)).astype(np.float32) * 1.5
    aa[:3] = [[0, 0, 0], [1e-8, 0, 0], [0, 3.1, 0]]  # zero, tiny, near pi
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    d6 = rng.standard_normal((64, 6)).astype(np.float32)
    euler = rng.uniform(-1.4, 1.4, (64, 3)).astype(np.float32)
    return aa, q, pts, d6, euler


def _close(got, want, tol=ROT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_rotations_match_jax():
    aa, q, pts, d6, _ = _rot_inputs()
    T, J = torch.from_numpy, jnp.asarray
    mats = np.asarray(jrot.quaternion_to_matrix(J(q)))
    q2 = np.roll(q, 1, axis=0)
    pairs = [
        ("standardize_quaternion", (q,)), ("quaternion_raw_multiply", (q, q2)),
        ("quaternion_multiply", (q, q2)), ("quaternion_invert", (q,)),
        ("quaternion_apply", (q, pts)), ("quaternion_to_matrix", (q,)),
        ("matrix_to_quaternion", (mats,)), ("axis_angle_to_quaternion", (aa,)),
        ("quaternion_to_axis_angle", (q,)), ("axis_angle_to_matrix", (aa,)),
        ("matrix_to_axis_angle", (mats,)), ("rotation_6d_to_matrix", (d6,)),
        ("matrix_to_rotation_6d", (mats,)),
    ]
    for name, args in pairs:
        want = getattr(jrot, name)(*map(J, args))
        got = getattr(trot, name)(*map(T, args))
        _close(got.numpy(), want)


CONVENTIONS = [a + b + c for a in "XYZ" for b in "XYZ" for c in "XYZ" if a != b and b != c]


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_conventions_match_jax(convention):
    *_, euler = _rot_inputs()
    want_m = jrot.euler_angles_to_matrix(jnp.asarray(euler), convention)
    got_m = trot.euler_angles_to_matrix(torch.from_numpy(euler), convention)
    _close(got_m.numpy(), want_m)
    want = jrot.matrix_to_euler_angles(want_m, convention)
    got = trot.matrix_to_euler_angles(torch.from_numpy(np.asarray(want_m)), convention)
    _close(got.numpy(), want, 1e-5)  # arcsin/arccos near their ends: a few ulps of the angle
    with pytest.raises(ValueError):
        trot.euler_angles_to_matrix(torch.from_numpy(euler), "XXY"[:2])


def test_random_rotations_from_a_generator():
    g = torch.Generator().manual_seed(4)
    q = trot.random_quaternions(50, g)
    r = trot.random_rotations(50, torch.Generator().manual_seed(4))
    assert torch.allclose(q.norm(dim=-1), torch.ones(50), atol=1e-6)
    assert torch.allclose(r @ r.transpose(-1, -2), torch.eye(3).expand(50, 3, 3), atol=1e-5)
    assert torch.allclose(r, trot.quaternion_to_matrix(q))
    assert torch.equal(trot.random_quaternions(50, torch.Generator().manual_seed(4)), q)


# --------------------------------------------------------------------------- #
# the a2m datasets
# --------------------------------------------------------------------------- #
def test_synthetic_a2m_dataset_is_bit_exact():
    want = ja2m.SyntheticA2MDataset(size=30, num_actions=40, seed=7, num_frames=24)
    got = ta2m.SyntheticA2MDataset(size=30, num_actions=40, seed=7, num_frames=24)
    assert len(got) == len(want)
    for i in range(len(want)):
        assert set(got[i]) == set(want[i])
        np.testing.assert_array_equal(got[i]["motion"], want[i]["motion"])
        for k in ("length", "action", "caption", "tokens"):
            assert got[i][k] == want[i][k]


def test_file_datasets_raise_without_their_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        ta2m.HumanAct12Dataset(datapath=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ta2m.UESTCDataset(datapath=str(tmp_path))


def test_humanact12_items_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    poses = [rng.standard_normal((n, 72)).astype(np.float32) for n in (80, 40, 60)]
    with open(tmp_path / "humanact12poses.pkl", "wb") as f:
        pickle.dump({"poses": poses, "y": [3, 0, 11]}, f)
    want = ja2m.HumanAct12Dataset(datapath=str(tmp_path), num_frames=60)
    got = ta2m.HumanAct12Dataset(datapath=str(tmp_path), num_frames=60)
    for i in range(3):
        np.random.seed(i)
        w = want[i]
        np.random.seed(i)
        g = got[i]
        assert g["motion"].shape == w["motion"].shape == (60, 150) and g["motion"].dtype == np.float32
        _close(g["motion"], w["motion"])
        for k in ("length", "action", "caption", "tokens"):
            assert g[k] == w[k]
    # the axis-angle conversion alone, zero rotation included
    pose = rng.standard_normal((5, 24, 3)).astype(np.float32)
    pose[0] = 0.0
    trans = rng.standard_normal((5, 3)).astype(np.float32)
    _close(ta2m.axis_angle_poses_to_rot6d(pose, trans), ja2m.axis_angle_poses_to_rot6d(pose, trans))


# --------------------------------------------------------------------------- #
# the recognition models
# --------------------------------------------------------------------------- #
def _tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("layout", ["smpl", "smpl_noglobal", "openpose"])
@pytest.mark.parametrize("strategy", ["uniform", "distance", "spatial"])
def test_stgcn_graph_is_jax_s(layout, strategy):
    np.testing.assert_array_equal(tstgcn.build_graph(layout, strategy),
                                  jstgcn.build_graph(layout, strategy))


def _fake_stgcn_state_dict(in_channels=6, num_class=12, K=3, V=24, seed=1):
    """A reference-layout ST-GCN state_dict (torch tensors) of random values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    sd = {}

    def bn(pre, c):
        sd.update({f"{pre}.weight": 1 + 0.1 * r(c), f"{pre}.bias": 0.1 * r(c),
                   f"{pre}.running_mean": 0.1 * r(c), f"{pre}.running_var": 1 + r(c).abs()})

    bn("data_bn", V * in_channels)
    c_in = in_channels
    for i, (_, c_out, stride, residual) in enumerate(tstgcn.STGCN_CHANNELS):
        pre = f"st_gcn_networks.{i}"
        sd[f"edge_importance.{i}"] = 1 + 0.1 * r(K, V, V)
        sd[f"{pre}.gcn.conv.weight"] = 0.2 * r(K * c_out, c_in, 1, 1)
        sd[f"{pre}.gcn.conv.bias"] = 0.1 * r(K * c_out)
        bn(f"{pre}.tcn.0", c_out)
        sd[f"{pre}.tcn.2.weight"] = 0.1 * r(c_out, c_out, 9, 1)
        sd[f"{pre}.tcn.2.bias"] = 0.1 * r(c_out)
        bn(f"{pre}.tcn.3", c_out)
        if residual and (c_in != c_out or stride != 1):
            sd[f"{pre}.residual.0.weight"] = 0.2 * r(c_out, c_in, 1, 1)
            sd[f"{pre}.residual.0.bias"] = 0.1 * r(c_out)
            bn(f"{pre}.residual.1", c_out)
        c_in = c_out
    sd["fcn.weight"] = 0.1 * r(num_class, 256, 1, 1)
    sd["fcn.bias"] = 0.1 * r(num_class)
    return sd


def test_stgcn_params_and_forward_match_jax():
    A = jstgcn.build_graph("smpl", "spatial")
    _tree_equal(tstgcn.random_params(6, 12, 24, A.shape[0], seed=3),
                jstgcn.random_params(6, 12, 24, A.shape[0], seed=3))
    sd = _fake_stgcn_state_dict()
    params = jstgcn.convert_stgcn_state_dict(sd)
    _tree_equal(tstgcn.convert_stgcn_state_dict(sd), params)
    x = np.random.default_rng(5).standard_normal((3, 6, 20, 24)).astype(np.float32)
    want = jstgcn.stgcn_forward(params, jnp.asarray(x), jnp.asarray(A))
    got = tstgcn.stgcn_forward(tstgcn.params_to_tensors(params, "cpu"), torch.from_numpy(x),
                               torch.as_tensor(A, dtype=torch.float32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=NET_TOL * (1 + np.abs(w).max()), rtol=0)


def test_classifiers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    motion = rng.standard_normal((5, 16, 150)).astype(np.float32)
    lengths = np.array([16, 9, 16, 1, 12], np.int32)
    # the GRU classifier: random init, then a checkpoint in the reference's layout
    ckpt = tmp_path / "gru.tar"
    g = torch.Generator().manual_seed(2)
    torch.save({"model": {
        "embedding.weight": 0.1 * torch.randn(128, 150, generator=g),
        "embedding.bias": 0.1 * torch.randn(128, generator=g),
        "gru.weight_ih_l0": 0.1 * torch.randn(384, 128, generator=g),
        "gru.weight_hh_l0": 0.1 * torch.randn(384, 128, generator=g),
        "gru.bias_ih_l0": 0.1 * torch.randn(384, generator=g),
        "gru.bias_hh_l0": 0.1 * torch.randn(384, generator=g),
        "out.weight": 0.1 * torch.randn(12, 128, generator=g),
        "out.bias": 0.1 * torch.randn(12, generator=g)}}, ckpt)
    pairs = [
        (jeval.A2MClassifier.random_init(seed=4), teval.A2MClassifier.random_init(seed=4,
                                                                                 device="cpu")),
        (jeval.A2MClassifier.from_torch_checkpoint(str(ckpt)),
         teval.A2MClassifier.from_torch_checkpoint(str(ckpt), "cpu")),
    ]
    stgcn_ckpt = tmp_path / "stgcn.tar"
    torch.save({"model": _fake_stgcn_state_dict(num_class=40)}, stgcn_ckpt)
    joints = motion[..., :144].reshape(5, 16, 24, 6)
    for jclf, tclf in pairs:
        _tree_equal({k: v for k, v in tclf.params.items()},
                    {k: v for k, v in jclf.params.items()})
        for g_, w in zip(tclf(motion, lengths), jclf(motion, lengths)):
            np.testing.assert_allclose(g_, w, atol=NET_TOL * (1 + np.abs(w).max()), rtol=0)
    for jclf, tclf in [
        (jeval.STGCNClassifier.random_init(seed=1),
         teval.STGCNClassifier.random_init(seed=1, device="cpu")),
        (jeval.STGCNClassifier.from_torch_checkpoint(str(stgcn_ckpt), layout="smpl"),
         teval.STGCNClassifier.from_torch_checkpoint(str(stgcn_ckpt), "cpu", layout="smpl")),
    ]:
        for g_, w in zip(tclf(joints), jclf(joints)):
            np.testing.assert_allclose(g_, w, atol=NET_TOL * (1 + np.abs(w).max()), rtol=0)


def test_evaluate_a2m_matches_jax():
    ds = ta2m.SyntheticA2MDataset(size=24, num_frames=20, seed=1)
    motions = np.stack([ds[i]["motion"] for i in range(24)])
    gen = motions + 0.3 * np.random.default_rng(3).standard_normal(motions.shape).astype(
        np.float32)
    lengths = np.full(24, 20)
    actions = np.array([ds[i]["action"] for i in range(24)])
    want = jeval.evaluate_a2m(jeval.A2MClassifier.random_init(), motions, lengths, actions, gen,
                              lengths, actions, diversity_times=8,
                              rng=np.random.default_rng(5))
    got = teval.evaluate_a2m(teval.A2MClassifier.random_init(device="cpu"), motions, lengths,
                             actions, gen, lengths, actions, diversity_times=8,
                             rng=np.random.default_rng(5))
    assert set(got) == set(want)
    assert got["accuracy"] == want["accuracy"]
    for k in ("fid", "diversity"):
        assert abs(got[k] - want[k]) <= NET_TOL * (1 + abs(want[k])) * 10, k


def test_unconstrained_metrics_are_bit_exact():
    rng = np.random.default_rng(8)
    g = rng.standard_normal((70, 16))
    r = rng.standard_normal((60, 16)) + 0.2
    want = junc.evaluate_unconstrained(g, r, n_subsets=4, subset_size=32,
                                       rng=np.random.default_rng(1))
    got = tunc.evaluate_unconstrained(g, r, n_subsets=4, subset_size=32,
                                      rng=np.random.default_rng(1))
    assert got == want
    assert tunc.calculate_kid(g, r, 3, 20, np.random.default_rng(2)) == \
        junc.calculate_kid(g, r, 3, 20, np.random.default_rng(2))
    assert tunc.precision_and_recall(g, r, k=5) == junc.precision_and_recall(g, r, k=5)
    assert tunc.polynomial_mmd(g, r) == junc.polynomial_mmd(g, r)


# --------------------------------------------------------------------------- #
# the protocols through main
# --------------------------------------------------------------------------- #
A2M_ARGV = {
    "humanact12": ["--eval_mode", "debug", "--diffusion_steps", "4", "--num_samples", "16",
                   "--batch_size", "16", "--num_frames", "24", "--latent_dim", "32",
                   "--layers", "1"],
    "uestc": ["--dataset", "uestc", "--eval_mode", "debug", "--diffusion_steps", "2",
              "--num_samples", "8", "--batch_size", "8", "--num_frames", "16",
              "--latent_dim", "16", "--layers", "1"],
}
UNCONSTRAINED_ARGV = ["--eval_mode", "debug", "--diffusion_steps", "4", "--num_samples", "16",
                      "--batch_size", "16", "--num_frames", "24", "--latent_dim", "32",
                      "--layers", "1", "--kid_subsets", "3"]


def _same_noise(monkeypatch):
    """Both frameworks' pipelines start from one x_T (numpy) and take no step noise."""
    import dataclasses

    from condmdi_tpu.sampling import pipeline as jpipe
    from condmdi_tpu_torch.sampling import pipeline as tpipe

    def xt(shape):
        return np.random.default_rng(123).standard_normal(shape).astype(np.float32)

    jax_sample, port_sample = jpipe.SamplePipeline.sample, tpipe.SamplePipeline.sample

    def jax_wrapped(self, rng, shape, y, **kw):
        self.sampler = dataclasses.replace(self.sampler, zero_noise=True)
        return jax_sample(self, rng, shape, y, **kw, noise=jnp.asarray(xt(shape)))

    def port_wrapped(self, shape, y, **kw):
        self.sampler = dataclasses.replace(self.sampler, zero_noise=True)
        return port_sample(self, shape, y, **{**kw, "noise": torch.from_numpy(xt(shape))})

    monkeypatch.setattr(jpipe.SamplePipeline, "sample", jax_wrapped)
    monkeypatch.setattr(tpipe.SamplePipeline, "sample", port_wrapped)


def _both(module, argv, tmp_path, name, extra_port=()):
    import importlib

    jmain = importlib.import_module(f"condmdi_tpu.evals.{module}").main
    tmain = importlib.import_module(f"condmdi_tpu_torch.evals.{module}").main
    jsum = jmain(argv + ["--output_dir", str(tmp_path / "jax")])
    tsum = tmain(argv + list(extra_port) + ["--output_dir", str(tmp_path / "port")],
                 device="cpu")
    load = lambda d: json.loads((tmp_path / d / name).read_text())  # noqa: E731
    return jsum, tsum, load("jax"), load("port")


def _assert_report(jsum, tsum, jrep, prep, committed):
    """The JAX report's keys and meta, finite; from the one x_T without step noise
    (_same_noise), JAX's numbers: accuracy equal, the rest within 1e-4 of (1 + |jax|)."""
    assert list(tsum) == list(jsum)
    assert set(prep) == set(jrep) and set(prep) - {"meta"} == set(committed) - {"meta"}
    assert set(committed["meta"]) <= set(jrep["meta"]) <= set(prep["meta"])
    for key in set(jrep["meta"]) - {"platform", "devices"}:
        assert prep["meta"][key] == jrep["meta"][key], key
    assert prep["meta"]["platform"] == "cpu"
    for key, v in tsum.items():
        assert set(v) == {"mean", "conf"}
        assert np.isfinite(v["mean"]) and np.isfinite(v["conf"]), key
        want, got = np.asarray(jsum[key]["mean"], np.float64), np.asarray(v["mean"], np.float64)
        if key == "accuracy":
            assert got == want
        assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want))), (key, got, want)


@pytest.mark.parametrize("dataset", ["humanact12", "uestc"])
def test_run_a2m_main_writes_jax_s_report(dataset, tmp_path, monkeypatch):
    _same_noise(monkeypatch)
    name = f"eval_a2m_{dataset}_debug.json"
    jsum, tsum, jrep, prep = _both("run_a2m", A2M_ARGV[dataset], tmp_path, name)
    committed = json.loads(Path("save/eval_out/eval_a2m_humanact12_debug.json").read_text())
    _assert_report(jsum, tsum, jrep, prep, committed)
    assert prep["meta"]["synthetic_data"] is True and prep["meta"]["classifier"] == "random_init"
    assert 0.0 <= tsum["accuracy"]["mean"] <= 1.0


def test_run_unconstrained_main_writes_jax_s_report(tmp_path, monkeypatch):
    _same_noise(monkeypatch)
    jsum, tsum, jrep, prep = _both("run_unconstrained", UNCONSTRAINED_ARGV, tmp_path,
                                   "eval_unconstrained_debug.json")
    committed = json.loads(Path("save/eval_out/eval_unconstrained_debug.json").read_text())
    _assert_report(jsum, tsum, jrep, prep, committed)
    assert prep["meta"]["features"] == "stgcn_smpl_rot6d"


def test_run_a2m_takes_a_flat_npz_and_refuses_orbax(tmp_path):
    from condmdi_tpu.models import MDM as JaxMDM
    from condmdi_tpu_torch.evals import run_a2m
    from condmdi_tpu_torch.weights import flatten_flax_params

    params = JaxMDM(njoints=25, nfeats=6, latent_dim=16, ff_size=32, num_layers=1,
                    cond_mode="action", num_actions=12).init(
        jax.random.key(1), jnp.zeros((2, 8, 150)), jnp.zeros((2,), jnp.int32),
        {"action": jnp.zeros((2,), jnp.int32)})
    npz = tmp_path / "model.npz"
    np.savez(npz, **flatten_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    argv = ["--diffusion_steps", "2", "--num_samples", "8", "--batch_size", "8",
            "--num_frames", "8", "--latent_dim", "16", "--layers", "1"]
    run_a2m.main(argv + ["--model_path", str(npz), "--output_dir", str(tmp_path / "out")],
                 device="cpu")
    report = json.loads((tmp_path / "out" / "eval_a2m_humanact12_debug.json").read_text())
    assert report["meta"]["model_path"] == str(npz)
    with pytest.raises(ValueError, match="Orbax"):
        run_a2m.main(argv + ["--model_path", str(tmp_path)], device="cpu")


