"""Joints → SMPL parameter fitting and mesh export.

Counterpart of condmdi_tpu/viz/joints2smpl.py (reference
visualize/simplify_loc2rot.py, visualize/joints2smpl/src/{smplify,customloss}.py,
visualize/render_mesh.py and vis_utils.npy2obj). All frames of a clip are fit
together: axis-angle poses [T, 24, 3], translations [T, 3] and one betas [10]
minimise the joint error plus pose, temporal-smoothness and shape priors under
Adam.

The JAX package runs the whole fit as one jitted `lax.scan` of optax Adam
steps. Here one step (forward through the LBS joints, backward,
`torch.optim.Adam`) is the unit: on the card it is captured once as a CUDA
graph (utils/cuda_graph.py) and replayed for the remaining steps, the rule
the port follows for jitted scans; `cuda_graphs=False` and the CPU run the same
step eagerly. Adam is `capturable` on the card in both modes, so a replayed fit
equals the eager one bit for bit. torch's Adam is optax's: b1 0.9, b2 0.999,
eps 1e-8 added outside the square root, both moments bias-corrected.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.geometry.rotations import axis_angle_to_matrix
from condmdi_tpu_torch.models.smpl import SMPLModel, lbs

# the SMPL joints of the 22 HumanML3D joints: the first 22 of 24 (a slice, so that
# indexing copies nothing from the host)
HML_TO_SMPL = slice(0, 22)


@dataclass
class FitConfig:
    num_steps: int = 300
    lr: float = 0.05
    pose_reg: float = 1e-3
    smooth_reg: float = 1e-2
    betas_reg: float = 1e-2


def _joints_from_params(model: SMPLModel, p: dict) -> torch.Tensor:
    T = p["pose"].shape[0]
    R = axis_angle_to_matrix(p["pose"])  # [T, 24, 3, 3]
    _, j = lbs(model, p["betas"].expand(T, 10), R[:, 0], R[:, 1:], return_vertices=False)
    return j[:, HML_TO_SMPL] - j[:, :1] + p["trans"][:, None, :]


def fit_loss(model: SMPLModel, joints: torch.Tensor, p: dict, cfg: FitConfig) -> torch.Tensor:
    """The fit's objective at parameters `p` (pose, trans, betas)."""
    data = torch.mean((_joints_from_params(model, p) - joints) ** 2)
    reg = cfg.pose_reg * torch.mean(p["pose"] ** 2)
    smooth = cfg.smooth_reg * torch.mean((p["pose"][1:] - p["pose"][:-1]) ** 2)
    breg = cfg.betas_reg * torch.mean(p["betas"] ** 2)
    return data + reg + smooth + breg


def fit_smpl_to_joints(model: SMPLModel, joints: torch.Tensor, cfg: FitConfig = FitConfig(),
                       cuda_graphs: bool = True):
    """Optimise (pose [T, 24, 3], trans [T, 3], betas [10]) to match joints [T, 22, 3].

    Returns (params dict, the loss of the last step), as the JAX function does:
    the loss is the one computed before the last update. On the card the step is
    replayed from a CUDA graph unless `cuda_graphs` is False.
    """
    joints = joints.to(device=model.device, dtype=torch.float32)
    T, dev = joints.shape[0], joints.device
    params = {
        "pose": torch.zeros((T, 24, 3), device=dev),
        "trans": joints[:, 0, :].clone(),  # the pelvis as the translation's start
        "betas": torch.zeros((10,), device=dev),
    }
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=dev.type == "cuda")

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = fit_loss(model, joints, params, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    if dev.type == "cuda" and cuda_graphs and cfg.num_steps > 1:
        from condmdi_tpu_torch.utils.cuda_graph import CudaGraph

        graph = CudaGraph(step)
        loss = graph()  # the first step runs eagerly, then the graph is captured
        for _ in range(cfg.num_steps - 1):
            loss = graph(check=False)
        loss = loss.clone()
    else:
        for _ in range(cfg.num_steps):
            loss = step()
    return {k: v.detach() for k, v in params.items()}, loss


def smpl_mesh_from_params(model: SMPLModel, params: dict) -> torch.Tensor:
    """Fitted params → per-frame vertices [T, V, 3]."""
    T = params["pose"].shape[0]
    R = axis_angle_to_matrix(params["pose"])
    verts, joints = lbs(model, params["betas"].expand(T, 10), R[:, 0], R[:, 1:])
    return verts - joints[:, :1] + params["trans"][:, None, :]


def save_obj(vertices: np.ndarray, faces: Optional[np.ndarray], path: str | Path) -> Path:
    """Minimal .obj writer (reference vis_utils.npy2obj.save_obj)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for f in faces + 1:
                fh.write(f"f {f[0]} {f[1]} {f[2]}\n")
    return path


def render_mesh_cli(results_npy: str, out_dir: str, sample_idx: int = 0,
                    model: Optional[SMPLModel] = None, faces=None,
                    device: str | torch.device = "cuda"):
    """reference render_mesh.py: results.npy → fitted SMPL .obj sequence. Returns
    (the .obj paths, the fit's last loss). The body model is SMPL_NEUTRAL from the
    files unless `model` is given; the fit runs on `device` (the model's where given)."""
    data = np.load(results_npy, allow_pickle=True).item()
    joints = np.asarray(data["joints"][sample_idx], np.float32)  # [T, 22, 3]
    model = model or SMPLModel.from_files(device=resolve_device(device))
    with torch.no_grad():
        target = torch.from_numpy(joints).to(model.device)
    params, loss = fit_smpl_to_joints(model, target)
    with torch.no_grad():
        verts = smpl_mesh_from_params(model, params).cpu().numpy()
    out = Path(out_dir)
    paths = [save_obj(verts[t], faces, out / f"frame{t:03d}.obj") for t in range(verts.shape[0])]
    return paths, float(loss)
