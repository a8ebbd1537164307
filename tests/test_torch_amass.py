"""The AMASS data layer on the port against the JAX package, on the CPU:

  * the MAT_* masks, FIELD_SLICES, AMASS_FIELD_ORDER, LAYOUT_764 and
    amass_joint_to_full_mask in both modes: equal;
  * SyntheticAMASSDataset's items: equal;
  * AMASSDataset on a NeMF .pt tree the test writes: equal items;
  * forward kinematics in every rotation representation (rotmat, Euler XYZ,
    quaternion, 6d) with and without explicit positions, global_to_local,
    canonical_to_local, get_tpose_joints, the default (synthetic) offsets, the
    velocity estimators, fields_from_poses, load_amass_files (both pose
    layouts), prep_to_save, dict_to_batch / batch_to_dict, dict_to_xyz and
    dict_to_posrot: within 1e-5 (float32; 1e-4 of the values' scale where an
    inverse or a finite difference over 1/30 s scales the rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from condmdi_tpu.data import amass as jam
from condmdi_tpu.data import amass_fk as jfk
from condmdi_tpu.geometry import rotations as jrot
from condmdi_tpu_torch.data import amass as tam
from condmdi_tpu_torch.data import amass_fk as tfk

TOL = 1e-5
J = 24


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * (1 + np.abs(want).max()))


def t_(a):
    return torch.from_numpy(np.array(a))


def test_masks_and_layouts_are_equal():
    for name in ("MAT_POS", "MAT_ROTMAT", "MAT_HEIGHT", "MAT_ROT6D", "MAT_ROT"):
        np.testing.assert_array_equal(getattr(tam, name), getattr(jam, name), err_msg=name)
    assert tam.FIELD_SLICES == jam.FIELD_SLICES
    assert tam.AMASS_FIELD_ORDER == jam.AMASS_FIELD_ORDER
    assert tfk.LAYOUT_764 == jfk.LAYOUT_764
    assert (tam.AMASS_DIM, tam.AMASS_JOINTS, tam.AMASS_CLIP_LENGTH) == \
        (jam.AMASS_DIM, jam.AMASS_JOINTS, jam.AMASS_CLIP_LENGTH)
    np.testing.assert_array_equal(tfk.SMPL_PARENTS, jfk.SMPL_PARENTS)


@pytest.mark.parametrize("mode", ["all", "pos_rot"])
def test_joint_to_full_mask_is_equal(mode):
    jm = np.random.default_rng(0).uniform(size=(2, 16, 24)) < 0.3
    np.testing.assert_array_equal(tam.amass_joint_to_full_mask(jm, mode=mode),
                                  jam.amass_joint_to_full_mask(jm, mode=mode))


def test_synthetic_items_are_equal():
    a, b = tam.SyntheticAMASSDataset(size=3, seed=4, clip_length=32), \
        jam.SyntheticAMASSDataset(size=3, seed=4, clip_length=32)
    assert len(a) == len(b) == 3
    for i in range(3):
        x, y = a[i], b[i]
        assert set(x) == set(y) and x["length"] == y["length"] == 32
        np.testing.assert_array_equal(x["motion"], y["motion"])


FIELD_SHAPES = {
    "trans": (3,), "rotmat": (24, 3, 3), "pos": (24, 3), "angular": (24, 3), "contacts": (8,),
    "height": (24,), "root_vel": (3,), "velocity": (24, 3), "global_xform": (24, 6),
    "root_orient": (6,), "rot6d": (24, 6),
}


def test_amass_dataset_on_a_pt_tree(tmp_path):
    root = tmp_path / "amass" / "generative"
    (root / "train").mkdir(parents=True)
    g = torch.Generator().manual_seed(0)
    N, L = 3, 128
    mean, std = {}, {}
    for key, shp in FIELD_SHAPES.items():
        torch.save(torch.randn((N, L) + shp, generator=g), root / "train" / f"{key}-male-128-30fps.pt")
        mean[key] = torch.randn((1, L) + shp, generator=g)
        std[key] = torch.rand((1, L) + shp, generator=g) + 0.5
    torch.save(mean, root / "mean-male-128-30fps.pt")
    torch.save(std, root / "std-male-128-30fps.pt")
    a, b = tam.AMASSDataset(str(root), "train"), jam.AMASSDataset(str(root), "train")
    assert a.field_order == b.field_order and len(a) == len(b) == N
    for i in range(N):
        np.testing.assert_array_equal(a[i]["motion"], b[i]["motion"])
    assert a[0]["motion"].shape == (L, 764)
    with pytest.raises(FileNotFoundError):
        tam.AMASSDataset(str(root), "test")


# --------------------------------------------------------------------------- #
# forward kinematics
# --------------------------------------------------------------------------- #
def offsets(seed=0):
    off = np.random.default_rng(seed).standard_normal((J, 3)).astype(np.float32) * 0.2
    off[0] = 0
    return off


def rotmats(shape, seed=1):
    rng = np.random.default_rng(seed)
    aa = (rng.standard_normal(shape + (3,)) * 0.8).astype(np.float32)
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))


@pytest.fixture(scope="module")
def fks():
    return jfk.ForwardKinematics(offsets=offsets()), tfk.ForwardKinematics(offsets=offsets())


@pytest.mark.parametrize("rep", ["rotmat", "euler", "quat", "6d"])
@pytest.mark.parametrize("positions", [False, True])
def test_forward_kinematics_matches_jax(fks, rep, positions):
    jf, tf = fks
    R = rotmats((5, J))
    x = {"rotmat": R,
         "euler": np.asarray(jrot.matrix_to_euler_angles(jnp.asarray(R), "XYZ")),
         "quat": np.asarray(jrot.matrix_to_quaternion(jnp.asarray(R))),
         "6d": np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(R)))}[rep]
    pos = np.random.default_rng(2).standard_normal((5, J, 3)).astype(np.float32) if positions \
        else None
    jj, jt = jf(jnp.asarray(x), None if pos is None else jnp.asarray(pos))
    tj, tt = tf(t_(x), None if pos is None else t_(pos))
    close(tj, jj)
    close(tt, jt)


def test_rotations_to_matrix_refuses_other_shapes():
    with pytest.raises(NotImplementedError):
        tfk.rotations_to_matrix(torch.zeros(2, 5))


def test_local_global_conversions_match_jax(fks):
    jf, tf = fks
    G = rotmats((4, J), seed=3)
    close(tf.global_to_local(t_(G)), jf.global_to_local(jnp.asarray(G)))
    g = rotmats((4,), seed=4)
    close(tf.canonical_to_local(t_(G), t_(g)), jf.canonical_to_local(jnp.asarray(G), jnp.asarray(g)))
    close(tf.canonical_to_local(t_(G)), jf.canonical_to_local(jnp.asarray(G)))
    off = np.random.default_rng(5).standard_normal((3, J, 3)).astype(np.float32)
    close(tf.get_tpose_joints(t_(off), tfk.SMPL_PARENTS),
          jf.get_tpose_joints(jnp.asarray(off), jfk.SMPL_PARENTS))


def test_default_offsets_are_jax_synthetic_skeleton(tmp_path, monkeypatch):
    monkeypatch.delenv("CONDMDI_BODY_MODELS", raising=False)
    monkeypatch.chdir(tmp_path)  # no body model files here
    np.testing.assert_array_equal(tfk.ForwardKinematics().offsets.numpy(),
                                  np.asarray(jfk.ForwardKinematics().offsets))


def test_velocity_estimators_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 4, 3)).astype(np.float32)
    close(tfk.estimate_linear_velocity(t_(x), 1 / 30), jfk.estimate_linear_velocity(x, 1 / 30),
          1e-4)
    R = rotmats((2, 7, 4), seed=7)
    close(tfk.estimate_angular_velocity(t_(R), 1 / 30),
          jfk.estimate_angular_velocity(jnp.asarray(R), 1 / 30), 1e-4)


def poses_and_trans(N=2, T=9, seed=8):
    rng = np.random.default_rng(seed)
    poses = np.cumsum(0.05 * rng.standard_normal((N, T, J, 3)), axis=1).astype(np.float32)
    trans = np.cumsum(0.02 * rng.standard_normal((N, T, 3)), axis=1).astype(np.float32)
    return poses, trans


def test_fields_from_poses_matches_jax(fks):
    jf, tf = fks
    poses, trans = poses_and_trans()
    want = jfk.fields_from_poses(jnp.asarray(poses), jnp.asarray(trans), jf)
    got = tfk.fields_from_poses(t_(poses), t_(trans), tf)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 1e-4 if k in ("velocity", "angular", "root_vel") else TOL)


def test_load_amass_files_matches_jax(tmp_path, fks):
    jf, tf = fks
    poses, trans = poses_and_trans(N=2, T=6, seed=9)
    flat = poses.reshape(2, 6, 72)
    np.savez(tmp_path / "a.npz", poses=np.concatenate([flat[0], np.zeros((6, 84))], -1),
             trans=trans[0])
    np.savez(tmp_path / "b.npz", root_orient=flat[1][:, :3], pose_body=flat[1][:, 3:],
             trans=trans[1])
    files = [str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]
    want = jfk.load_amass_files(files, fk=jf)
    got = tfk.load_amass_files(files, fk=tf, device="cpu")
    for k in want:
        close(got[k], want[k], 1e-4 if k in ("velocity", "angular", "root_vel") else TOL)
    np.savez(tmp_path / "bad.npz", trans=trans[0])
    with pytest.raises(RuntimeError, match="missing pose"):
        tfk.load_amass_files([str(tmp_path / "bad.npz")], fk=tf, device="cpu")


def test_save_and_batch_round_trips_match_jax(fks):
    jf, tf = fks
    poses, trans = poses_and_trans(seed=10)
    fields = jfk.fields_from_poses(jnp.asarray(poses), jnp.asarray(trans), jf)
    rng = np.random.default_rng(11)
    fields = {k: np.asarray(v) for k, v in fields.items()}
    fields["height"] = rng.standard_normal((2, 9, 24)).astype(np.float32)
    fields["contacts"] = (rng.random((2, 9, 8)) < 0.5).astype(np.float32)
    tfields = {k: t_(v) for k, v in fields.items()}

    want, got = jfk.prep_to_save(fields, jf), tfk.prep_to_save(tfields, tf)
    assert set(got) == set(want)
    close(got["poses"], want["poses"], 1e-4)
    for k in ("trans", "betas"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["gender"], got["mocap_framerate"]) == (want["gender"], want["mocap_framerate"])

    jb, tb = jfk.dict_to_batch(fields), tfk.dict_to_batch(tfields)
    close(tb, jb)
    jd, td = jfk.batch_to_dict(jb), tfk.batch_to_dict(tb)
    assert set(jd) == set(td)
    for k in jd:
        close(td[k], jd[k])
    partial = {k: fields[k] for k in ("pos", "trans")}
    close(tfk.dict_to_batch({k: t_(v) for k, v in partial.items()}), jfk.dict_to_batch(partial))
    close(tfk.dict_to_xyz(td), jfk.dict_to_xyz(jd))
    jp, jq = jfk.dict_to_posrot(jd, jf)
    tp, tq = tfk.dict_to_posrot(td, tf)
    close(tp, jp)
    close(tq, jq, 1e-4)
