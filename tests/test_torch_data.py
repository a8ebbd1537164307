"""The port's geometry and HumanML3D codec against the JAX package's, on the CPU
(the dataset built on them: tests/test_torch_dataset.py).

Tolerances, float32 on both sides:
  * forward kinematics and recover_from_ric / recover_root_rot_pos: 1e-5
    absolute (measured <= 3e-7: the same products in another order);
  * extract_features: 1e-4 absolute on features of order 1 (measured <=
    7e-7 on smooth motions; the IK's arcsin, atan2 and normalisations and a
    161-tap smoothing filter stand between the joints and the features).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.data import humanml_repr as jrepr
from condmdi_tpu.data import layout as jlayout
from condmdi_tpu.geometry import skeleton as jskel
from condmdi_tpu_torch.data import dataset as tds
from condmdi_tpu_torch.data import humanml_repr as trepr
from condmdi_tpu_torch.data import layout as tlayout
from condmdi_tpu_torch.geometry import skeleton as tskel

GEOM_ATOL = 1e-5
FEAT_ATOL = 1e-4


def _walks(n, T, seed):
    """Smooth random quaternion walks, roots and scaled offsets, as the
    synthetic dataset draws them."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.25, 0.45, size=(n, 22, 1))
    offs = (jskel.T2M_RAW_OFFSETS * scale).astype(np.float32)
    q = rng.normal(size=(n, 1, 22, 4)) + np.cumsum(rng.normal(size=(n, T, 22, 4)) * 0.03, axis=1)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    root = np.cumsum(rng.normal(size=(n, T, 3)) * 0.01, axis=1).astype(np.float32)
    root[..., [0, 2]] += rng.uniform(-0.02, 0.02, size=(n, 1, 2)) * np.arange(T)[:, None]
    root[..., 1] += 0.9
    return q, root.astype(np.float32), offs


def _jax_fk(q, root, offs):
    fk = lambda q, r, o: jskel.t2m_skeleton.forward_kinematics(  # noqa: E731
        q, r, jnp.broadcast_to(o, q.shape[:-1] + (3,)))
    return np.asarray(jax.vmap(fk)(q, root, offs[:, None]))


def test_layout_equals_jax():
    for name in ("MAT_POS", "MAT_ROT", "MAT_VEL", "MAT_CNT", "HML_ROOT_MASK",
                 "HML_LOWER_BODY_MASK", "HML_UPPER_BODY_MASK", "HML_LOWER_BODY_RIGHT_MASK"):
        np.testing.assert_array_equal(getattr(tlayout, name), getattr(jlayout, name))
    for name in ("HML_JOINT_NAMES", "HML_LOWER_BODY_JOINTS", "HML_PELVIS_FEET", "HML_PELVIS_VR"):
        assert getattr(tlayout, name) == getattr(jlayout, name)


def test_skeleton_constants_equal_jax():
    np.testing.assert_array_equal(tskel.T2M_RAW_OFFSETS, jskel.T2M_RAW_OFFSETS)
    assert tskel.T2M_KINEMATIC_CHAIN == jskel.T2M_KINEMATIC_CHAIN
    assert tskel.T2M_FACE_JOINT_INDX == jskel.T2M_FACE_JOINT_INDX


def test_forward_kinematics_equals_jax():
    q, root, offs = _walks(3, 40, 0)
    got = tskel.t2m_skeleton.forward_kinematics(torch.from_numpy(q), torch.from_numpy(root),
                                                torch.from_numpy(offs)[:, None]).numpy()
    np.testing.assert_allclose(got, _jax_fk(q, root, offs), rtol=0, atol=GEOM_ATOL)


def test_inverse_kinematics_and_filter_equal_jax():
    q, root, offs = _walks(1, 50, 1)
    joints = _jax_fk(q, root, offs)[0]
    for smooth in (False, True):
        got = tskel.t2m_skeleton.inverse_kinematics(torch.tensor(joints),
                                                    smooth_forward=smooth).numpy()
        want = np.asarray(jskel.t2m_skeleton.inverse_kinematics(jnp.asarray(joints),
                                                                 smooth_forward=smooth))
        np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    x = np.random.default_rng(2).standard_normal((30, 3)).astype(np.float32)
    np.testing.assert_allclose(tskel._gaussian_filter1d(torch.from_numpy(x), 4.0, axis=0).numpy(),
                               np.asarray(jskel._gaussian_filter1d(jnp.asarray(x), 4.0, axis=0)),
                               rtol=0, atol=GEOM_ATOL)


@pytest.mark.parametrize("abs_3d", [False, True])
def test_codec_equals_jax(abs_3d):
    q, root, offs = _walks(3, 60, 3)
    joints = _jax_fk(q, root, offs)
    want = np.asarray(jax.vmap(lambda j: jrepr.extract_features(j, 0.002, abs_3d=abs_3d))(
        jnp.asarray(joints)))
    got = trepr.extract_features(torch.tensor(joints), 0.002, abs_3d=abs_3d).numpy()
    assert got.shape == want.shape == (3, 59, 263)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    # one item without a batch dimension, as the JAX function takes it
    np.testing.assert_allclose(
        trepr.extract_features(torch.tensor(joints[1]), 0.002, abs_3d=abs_3d).numpy(),
        want[1], rtol=0, atol=FEAT_ATOL)
    # back to joints from the same features
    np.testing.assert_allclose(
        trepr.recover_from_ric(torch.from_numpy(want), 22, abs_3d=abs_3d).numpy(),
        np.asarray(jrepr.recover_from_ric(jnp.asarray(want), 22, abs_3d=abs_3d)),
        rtol=0, atol=GEOM_ATOL)
    for got_part, want_part in zip(
            trepr.recover_root_rot_pos(torch.from_numpy(want), abs_3d=abs_3d),
            jrepr.recover_root_rot_pos(jnp.asarray(want), abs_3d=abs_3d)):
        np.testing.assert_allclose(got_part.numpy(), np.asarray(want_part), rtol=0, atol=GEOM_ATOL)


def test_recover_from_ric_inverts_extract_features():
    """abs_3d features give back the joints they came from (root and ric)."""
    q, root, offs = _walks(2, 40, 4)
    joints = torch.from_numpy(_jax_fk(q, root, offs))
    feats = trepr.extract_features(joints, 0.002, abs_3d=True)
    back = trepr.recover_from_ric(feats, 22, abs_3d=True)
    np.testing.assert_allclose(back.numpy(), joints[:, :-1].numpy(), rtol=0, atol=FEAT_ATOL)


def test_sample_to_joints_equals_jax():
    from condmdi_tpu.sampling.pipeline import SamplePipeline as JaxPipeline
    from condmdi_tpu_torch.diffusion import DiffusionConfig, DiffusionSchedule, get_named_beta_schedule
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    ds = tds.SyntheticMotionDataset(tds.DatasetConfig(max_motion_length=40, abs_3d=True), size=2,
                                    device="cpu")
    feats = np.random.default_rng(5).standard_normal((2, 40, 263)).astype(np.float32)
    pipe = SamplePipeline(None, DiffusionSchedule.create(get_named_beta_schedule("cosine", 4)),
                          DiffusionConfig(), device="cpu")
    got = pipe.sample_to_joints(torch.from_numpy(feats), ds.denormalize, True).numpy()
    want = np.asarray(JaxPipeline.sample_to_joints(None, jnp.asarray(feats), ds.denormalize, True))
    assert got.shape == (2, 40, 22, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
