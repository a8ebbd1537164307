"""SMPL body model: linear blend skinning and Rotation2xyz on tensors.

Counterpart of condmdi_tpu/models/smpl.py (reference model/smpl.py:64, the
SMPL wrapper with its joint maps, and model/rotation2xyz.py:17). The LBS is the
standard SMPL formulation: shape blendshapes, pose blendshapes, joint
regression, the rigid transforms down the 24-joint tree, then skinning. The
JAX version writes each 4x4 transform with `.at[].set`; here each is built by
concatenation and the chain by stacking, differentiable end to end, which is
what the geometric losses (lambda_rcxyz, lambda_fc) need.

`SMPLModel` holds its tensors on one device. `from_files` reads the same
SMPL_NEUTRAL npz/pkl as the JAX package, from $CONDMDI_BODY_MODELS or
./body_models; `random_init` replays the JAX package's numpy draws, so a seed
gives the same synthetic body model in both (`weights.smpl_model_from_arrays`
takes the JAX model's arrays as numpy). Vertices are computed only where a
caller asks for them: joints do not depend on them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from functools import cached_property
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.geometry.rotations import (
    axis_angle_to_matrix,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)

JOINTSTYPE_ROOT = {"a2m": 0, "smpl": 0, "a2mpl": 0, "vibe": 8}
ACTION2MOTION_JOINTS = [8, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 14, 21, 24, 38]
SMPL_NUM_JOINTS = 24
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


@dataclass(frozen=True)
class SMPLModel:
    """SMPL parameters as float32 tensors (parents int64), all on one device."""

    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, n_betas]
    posedirs: torch.Tensor  # [(J-1)*9, V*3], the pose blendshape basis transposed
    J_regressor: torch.Tensor  # [J, V]
    parents: torch.Tensor  # [J]
    lbs_weights: torch.Tensor  # [V, J]
    J_regressor_extra: Optional[torch.Tensor] = None  # [J_extra, V]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @cached_property
    def parents_host(self) -> tuple[int, ...]:
        """The kinematic tree on the host (read once: no sync per forward)."""
        return tuple(int(p) for p in self.parents.tolist())

    @cached_property
    def parent_index(self) -> torch.Tensor:
        """parents[1:] as an index on the model's device, made once (an index from the
        host would be a copy, and a wait, on every call, and no CUDA graph takes it)."""
        return self.parents[1:].clone()

    def to(self, device) -> "SMPLModel":
        return SMPLModel(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device) for f in fields(self)})

    @classmethod
    def from_arrays(cls, arrays: dict, device: str | torch.device = "cuda") -> "SMPLModel":
        """From numpy arrays in this class's layout (the JAX SMPLModel's)."""
        dev = resolve_device(device)
        out = {}
        for f in fields(cls):
            a = arrays.get(f.name)
            if a is None:
                out[f.name] = None
                continue
            a = np.asarray(a)
            dtype = torch.int64 if f.name == "parents" else torch.float32
            out[f.name] = torch.as_tensor(a.astype(np.int64 if f.name == "parents" else np.float32),
                                          dtype=dtype, device=dev)
        return cls(**out)

    @classmethod
    def from_files(cls, model_dir: Optional[str] = None,
                   device: str | torch.device = "cuda") -> "SMPLModel":
        """SMPL_NEUTRAL from npz/pkl in $CONDMDI_BODY_MODELS, model_dir, body_models/smpl
        or ./body_models."""
        candidates = [os.environ.get("CONDMDI_BODY_MODELS", ""), model_dir or "",
                      "body_models/smpl", "./body_models"]
        for c in candidates:
            if not c:
                continue
            for name in ("SMPL_NEUTRAL.npz", "SMPL_NEUTRAL.pkl"):
                f = Path(c) / name
                if f.exists():
                    return cls._load(f, device)
        raise FileNotFoundError(
            "SMPL body model not found; set CONDMDI_BODY_MODELS or download "
            "via the reference prepare/download_smpl_files.sh"
        )

    @classmethod
    def _load(cls, path: Path, device) -> "SMPLModel":
        if path.suffix == ".npz":
            data = dict(np.load(path, allow_pickle=True))
        else:
            import pickle

            with open(path, "rb") as fh:
                data = pickle.load(fh, encoding="latin1")
        to_np = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
        posedirs = to_np(data["posedirs"])  # [V, 3, (J-1)*9]
        V = posedirs.shape[0]
        extra_path = path.parent / "J_regressor_extra.npy"
        return cls.from_arrays(dict(
            v_template=to_np(data["v_template"]),
            shapedirs=to_np(data["shapedirs"])[..., :10],
            posedirs=posedirs.reshape(V * 3, -1).T,
            J_regressor=to_np(data["J_regressor"]),
            parents=np.asarray(data["kintree_table"])[0].astype(np.int32),
            lbs_weights=to_np(data["weights"]),
            J_regressor_extra=(np.load(extra_path).astype(np.float32)
                               if extra_path.exists() else None),
        ), device)

    @classmethod
    def random_init(cls, n_vertices: int = 200, seed: int = 0,
                    device: str | torch.device = "cuda") -> "SMPLModel":
        """A structurally valid synthetic body model: the JAX package's numpy draws,
        in its order."""
        rng = np.random.default_rng(seed)
        J = SMPL_NUM_JOINTS
        v_template = rng.normal(0, 0.3, (n_vertices, 3)).astype(np.float32)
        w = rng.uniform(0, 1, (n_vertices, J)).astype(np.float32)
        w = w / w.sum(axis=1, keepdims=True)
        jr = rng.uniform(0, 1, (J, n_vertices)).astype(np.float32)
        jr = jr / jr.sum(axis=1, keepdims=True)
        shapedirs = rng.normal(0, 0.01, (n_vertices, 3, 10)).astype(np.float32)
        posedirs = rng.normal(0, 0.001, ((J - 1) * 9, n_vertices * 3)).astype(np.float32)
        return cls.from_arrays(dict(v_template=v_template, shapedirs=shapedirs,
                                    posedirs=posedirs, J_regressor=jr,
                                    parents=np.asarray(SMPL_PARENTS, np.int32),
                                    lbs_weights=w), device)


def _transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] → [..., 4, 4] with the bottom row (0, 0, 0, 1)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def lbs(model: SMPLModel, betas: torch.Tensor, global_orient: torch.Tensor,
        body_pose: torch.Tensor, return_vertices: bool = True):
    """Standard SMPL linear blend skinning: betas [B, n_betas], global_orient
    [B, 3, 3], body_pose [B, J-1, 3, 3] → (vertices [B, V, 3] or None, joints
    [B, J, 3])."""
    B = betas.shape[0]
    J = model.num_joints
    dt, dev = betas.dtype, betas.device

    v_shaped = model.v_template[None] + torch.einsum("bl,vkl->bvk", betas, model.shapedirs)
    j_rest = torch.einsum("jv,bvk->bjk", model.J_regressor, v_shaped)
    rot_mats = torch.cat([global_orient[:, None], body_pose], dim=1)  # [B, J, 3, 3]

    parents = model.parents_host
    rel_joints = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, model.parent_index]], dim=1)
    transforms = [_transform(rot_mats[:, 0], rel_joints[:, 0])]
    for j in range(1, J):
        transforms.append(transforms[parents[j]] @ _transform(rot_mats[:, j], rel_joints[:, j]))
    A = torch.stack(transforms, dim=1)  # [B, J, 4, 4]
    joints = A[..., :3, 3]
    if not return_vertices:
        return None, joints

    # pose blendshapes (relative to the identity)
    pose_feature = (rot_mats[:, 1:] - torch.eye(3, dtype=dt, device=dev)).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, -1, 3)

    # the rest-pose joint locations taken out of the transforms
    j_h = torch.cat([j_rest, torch.zeros((B, J, 1), dtype=dt, device=dev)], dim=-1)
    correction = torch.einsum("bjJK,bjK->bjJ", A, j_h)
    A_skin = torch.cat([A[..., :3, :3], (A[..., :3, 3] - correction[..., :3])[..., None]], dim=-1)
    A_skin = torch.cat([A_skin, A[..., 3:, :]], dim=-2)

    T = torch.einsum("vj,bjJK->bvJK", model.lbs_weights, A_skin)
    v_h = torch.cat([v_posed, torch.ones((B, v_posed.shape[1], 1), dtype=dt, device=dev)], dim=-1)
    vertices = torch.einsum("bvJK,bvK->bvJ", T, v_h)[..., :3]
    return vertices, joints


class SMPLWrapper:
    """SMPL with the joint maps (reference smpl.py:64): 'smpl', 'a2m' (the
    action-to-motion joints that the bare 24-joint model has) and 'a2mpl'."""

    def __init__(self, model: Optional[SMPLModel] = None):
        self.model = model or SMPLModel.from_files()
        smpl_indexes = np.arange(SMPL_NUM_JOINTS)
        self.maps = {"smpl": smpl_indexes,
                     "a2m": np.array([j for j in ACTION2MOTION_JOINTS if j < 24])}
        self.maps["a2mpl"] = np.unique(np.r_[smpl_indexes, self.maps["a2m"]])
        self._index = {k: torch.as_tensor(v, device=self.model.device)
                       for k, v in self.maps.items()}

    def __call__(self, body_pose: torch.Tensor, global_orient: torch.Tensor,
                 betas: torch.Tensor, vertices: bool = True) -> dict:
        verts, joints = lbs(self.model, betas, global_orient, body_pose,
                            return_vertices=vertices)
        out = {} if verts is None else {"vertices": verts}
        for k, idx in self._index.items():
            out[k] = joints[:, idx]
        return out


class Rotation2xyz:
    """Rotations → joints (or vertices) through SMPL (reference rotation2xyz.py:17)."""

    def __init__(self, smpl: Optional[SMPLWrapper] = None):
        self._smpl = smpl

    @property
    def smpl(self) -> SMPLWrapper:
        if self._smpl is None:
            self._smpl = SMPLWrapper()
        return self._smpl

    def __call__(
        self,
        x: torch.Tensor,  # [B, T, njoints, feats], time-major as in the JAX package
        pose_rep: str = "rot6d",
        translation: bool = True,
        glob: bool = True,
        jointstype: str = "smpl",
        vertstrans: bool = False,
        betas: Optional[torch.Tensor] = None,
        beta: float = 0.0,
        glob_rot=None,
    ) -> torch.Tensor:
        if pose_rep == "xyz":
            return x

        if translation:
            x_translations = x[:, :, -1, :3]  # [B, T, 3]
            x_rotations = x[:, :, :-1]
        else:
            x_rotations = x
        B, T, njoints, feats = x_rotations.shape
        flat = x_rotations.reshape(B * T, njoints, feats)

        if pose_rep == "rotvec":
            rotations = axis_angle_to_matrix(flat)
        elif pose_rep == "rotmat":
            rotations = flat.reshape(-1, njoints, 3, 3)
        elif pose_rep == "rotquat":
            rotations = quaternion_to_matrix(flat)
        elif pose_rep == "rot6d":
            rotations = rotation_6d_to_matrix(flat)
        else:
            raise NotImplementedError(f"no geometry for {pose_rep}")

        if glob:
            global_orient = rotations[:, 0]
            rotations = rotations[:, 1:]
        else:
            assert glob_rot is not None
            g = torch.as_tensor(np.asarray(glob_rot, np.float32), dtype=x.dtype, device=x.device)
            global_orient = axis_angle_to_matrix(g).expand(len(rotations), 3, 3)

        if betas is None:
            betas = torch.zeros((rotations.shape[0], self.smpl.model.num_betas),
                                dtype=x.dtype, device=x.device)
            betas[:, 1] = beta

        out = self.smpl(rotations, global_orient, betas, vertices=jointstype == "vertices")
        joints = out[jointstype]  # [B*T, J', 3]
        joints = joints.reshape(B, T, joints.shape[1], 3)

        if jointstype != "vertices":
            root = JOINTSTYPE_ROOT[jointstype]
            joints = joints - joints[:, :, root: root + 1, :]

        if translation and vertstrans:
            x_translations = x_translations - x_translations[:, :1, :]
            joints = joints + x_translations[:, :, None, :]
        return joints
