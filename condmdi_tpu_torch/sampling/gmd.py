"""GMD guidance pack: trajectory-target gradient guidance and two-stage
generation (reference sample/gmd/: condition.py, keyframe_pattern.py,
generate.py).

Counterpart of condmdi_tpu/sampling/gmd.py. `CondKeyLocations.loss_fn` is a
`cond_loss_fn` for the DDPM sampler (diffusion/sampling.py): each step takes
the gradient of -loss with respect to x_t through the denoiser
(`torch.autograd.grad`, the JAX package's `jax.grad` inside its scan), so a
guided run is eager on the card, every resblock half going through the
kernel forward and its plain-recompute backward (ops/resblock.py
`ConvGnMish`). `two_stage_generate`'s second stage, imputation without
guidance, goes through `SamplePipeline` and its CUDA graphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from condmdi_tpu_torch.data.humanml_repr import recover_from_ric
from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.utils.assets import NormStats

# ---- hand-authored keyframe patterns (keyframe_pattern.py:3) --------------- #
KFRAME_PATTERNS = {
    "square": [
        (1, (0.0, 0.0)), (30, (0.0, 3.0)), (45, (1.5, 3.0)), (60, (3.0, 3.0)),
        (75, (3.0, 1.5)), (90, (3.0, 0.0)), (105, (1.5, 0.0)), (119, (0.0, 0.0)),
    ],
    "inverse_N": [
        (1, (0.0, 0.0)), (30, (0.0, 3.0)), (45, (1.5, 1.5)), (60, (3.0, 0.0)),
        (90, (3.0, 3.0)), (119, (0.0, 0.0)),
    ],
    "3dots": [(1, (0.0, 0.0)), (59, (0.0, 3.0)), (119, (3.0, 3.0))],
    "zigzag": [
        (1, (0.0, 0.0)), (30, (1.0, 1.5)), (60, (-1.0, 3.0)), (90, (1.0, 4.5)),
        (119, (0.0, 6.0)),
    ],
    "sdf_obstacle": [(1, (0.0, 0.0)), (119, (0.0, 6.0))],
}


def get_kframes(
    pattern: str = "square",
    ground_positions: Optional[np.ndarray] = None,
    interpolate: bool = False,
):
    """Keyframe (frame, (x, z)) list; from GT positions when provided.

    interpolate=True densifies the pattern to every frame via linear
    interpolation (reference keyframe_pattern.py:144 interpolate_kps)."""
    if ground_positions is not None:
        k_positions = list(range(1, 120)) + [119]
        return [
            (k, (float(ground_positions[k - 1, 0, 0]), float(ground_positions[k - 1, 0, 2])))
            for k in sorted(set(k_positions))
        ]
    kframes = list(KFRAME_PATTERNS[pattern])
    if interpolate:
        last_frame = kframes[-1][0]
        traj = interpolate_kframes_trajectory(kframes, last_frame + 1)
        kframes = [(t, (float(traj[t, 0]), float(traj[t, 1]))) for t in range(last_frame + 1)]
    return kframes


def get_obstacles() -> list[tuple[float, float, float]]:
    """Circular xz-plane obstacles (x, z, radius) for the SDF avoidance task
    (reference keyframe_pattern.py:133-141)."""
    return [(4.0, 1.5, 0.7), (0.7, 1.5, 0.6)]


# ---- target builders (condition.py:10-31) ---------------------------------- #
def kframes_to_target(kframes, batch_size: int, n_frames: int,
                      device: str | torch.device = "cuda"):
    """(frame,(x,z)) list → target [B,T,22,3] (pelvis xz set) + mask, on `device`."""
    target = np.zeros((batch_size, n_frames, 22, 3), np.float32)
    mask = np.zeros((batch_size, n_frames, 22, 3), bool)
    for frame, (x, z) in kframes:
        if frame >= n_frames:
            continue
        target[:, frame, 0, 0] = x
        target[:, frame, 0, 2] = z
        mask[:, frame, 0, 0] = True
        mask[:, frame, 0, 2] = True
    dev = resolve_device(device)
    return torch.from_numpy(target).to(dev), torch.from_numpy(mask).to(dev)


def interpolate_kframes_trajectory(kframes, n_frames: int) -> np.ndarray:
    """Point-to-point linear xz trajectory through the keyframes
    (reference get_inpainting_motion's p2p imputation path)."""
    frames = np.array([k for k, _ in kframes])
    xs = np.array([p[0] for _, p in kframes])
    zs = np.array([p[1] for _, p in kframes])
    t = np.arange(n_frames)
    x = np.interp(t, frames, xs)
    z = np.interp(t, frames, zs)
    return np.stack([x, z], axis=-1).astype(np.float32)  # [T, 2]


# ---- gradient guidance (condition.py:458 CondKeyLocations) ------------------ #
@dataclass
class CondKeyLocations:
    """cond_loss_fn factory: masked pelvis-xz loss against a target.

    Use: loss_fn = CondKeyLocations(target, target_mask, stats, ...).loss_fn
         ddpm_sample_loop(..., cond_loss_fn=loss_fn, cond_scale=classifier_scale)
    """

    target: torch.Tensor  # [B, T, 22, 3]
    target_mask: torch.Tensor  # [B, T, 22, 3] bool
    stats: NormStats  # denormalization for the model's feature space
    abs_3d: bool = True
    traj_only: bool = False
    use_mse_loss: bool = False
    stop_cond_from: int = 0
    motion_length_cut: float = 6.0

    def _pelvis_xz(self, pred_xstart: torch.Tensor) -> torch.Tensor:
        """The pelvis xz [B, T, 2] of the denormalized prediction."""
        C = pred_xstart.shape[-1]
        std = torch.as_tensor(self.stats.std[:C], dtype=pred_xstart.dtype,
                              device=pred_xstart.device)
        mean = torch.as_tensor(self.stats.mean[:C], dtype=pred_xstart.dtype,
                               device=pred_xstart.device)
        feats = pred_xstart * std + mean
        if self.traj_only:
            # features are (rot, x, z, y): pelvis xz directly at channels 1:3
            return torch.stack([feats[..., 1], feats[..., 2]], dim=-1)
        joints = recover_from_ric(feats, 22, abs_3d=self.abs_3d)
        return joints[:, :, 0, :][..., (0, 2)]

    def _gate(self, t: torch.Tensor, dtype) -> torch.Tensor:
        # stop gate (condition.py:503): no guidance below stop_cond_from
        return (t[0] >= self.stop_cond_from).to(dtype)

    def loss_fn(self, pred_xstart: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """pred_xstart: normalized features [B, T, F]; t: the model timestep; a scalar loss."""
        cut = int(self.motion_length_cut * 20)
        traj = self._pelvis_xz(pred_xstart)
        B = traj.shape[0]
        tgt = self.target[:, :, 0, :][..., (0, 2)]
        msk = self.target_mask[:, :, 0, :][..., (0, 2)].to(traj.dtype)
        traj, tgt, msk = traj[:, :cut], tgt[:, :cut], msk[:, :cut]
        err = (traj - tgt) ** 2 if self.use_mse_loss else (traj - tgt).abs()
        # the mask sum is over the whole [B, T, 22, 3] mask, not over the cut
        loss = (err * msk).sum() / self.target_mask.sum().clamp(min=1) * B
        return loss * self._gate(t, loss.dtype)


@dataclass
class CondKeyLocationsWithSdf(CondKeyLocations):
    """+ SDF obstacle-avoidance term (condition.py:581): circular obstacles
    (x, z, radius); penalizes trajectory points inside an obstacle."""

    obstacles: Sequence[tuple[float, float, float]] = ()
    sdf_weight: float = 5.0  # reference w_colli (condition.py:598)

    def loss_fn(self, pred_xstart: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        base = CondKeyLocations.loss_fn(self, pred_xstart, t)
        cut = int(self.motion_length_cut * 20)
        traj = self._pelvis_xz(pred_xstart)[:, :cut]
        sdf_loss = 0.0
        for (ox, oz, r) in self.obstacles:
            centre = torch.tensor([ox, oz], dtype=traj.dtype, device=traj.device)
            d = torch.linalg.vector_norm(traj - centre, dim=-1)
            # reference condition.py:682: clamp(rad-dist,0).sum()/T * w_colli, the
            # division by the cut's frame count
            sdf_loss = sdf_loss + torch.relu(r - d).sum() / traj.shape[1]
        return base + self.sdf_weight * sdf_loss * self._gate(t, base.dtype)


# ---- two-stage generation (generate.py:94, :396+) --------------------------- #
def two_stage_generate(
    traj_pipe,
    motion_pipe,
    kframes,
    batch_size: int,
    n_frames: int,
    traj_stats: NormStats,
    motion_stats: NormStats,
    y_traj: dict,
    y_motion: dict,
    classifier_scale: float = 100.0,
    impute_until: int = 1,
    target: Optional[torch.Tensor] = None,
    target_mask: Optional[torch.Tensor] = None,
    obstacles: Optional[Sequence[tuple[float, float, float]]] = None,
    use_mse_loss: bool = False,
    generator: Optional[torch.Generator] = None,
    traj_noise: Optional[torch.Tensor] = None,
    motion_noise: Optional[torch.Tensor] = None,
):
    """Stage 1: trajectory model guided toward keyframe targets (eager DDPM).
    Stage 2: motion model imputing the generated root channels
    (reference get_inpainting_motion_from_traj, condition.py:294), through
    `motion_pipe.sample`.

    Targets come from `kframes` (shared across the batch, the sample-CLI
    path) or directly from per-sample (target, target_mask) [B,T,22,3]
    tensors (the eval_humanml_condition protocol path). Each stage's x_T is
    `traj_noise` / `motion_noise` where given, else drawn from `generator`,
    as is every step's noise. Returns (trajectory [B, T, 4], motion [B, T, 263]).
    """
    from condmdi_tpu_torch.diffusion.sampling import ddpm_sample_loop
    from condmdi_tpu_torch.sampling.pipeline import build_inpainting_state

    dev = traj_pipe.device
    if target is None:
        target, target_mask = kframes_to_target(kframes, batch_size, n_frames, dev)
    if obstacles:
        # sdf mode (reference generate.py:442): keyframe loss + obstacle SDF
        guide = CondKeyLocationsWithSdf(
            target, target_mask, traj_stats, abs_3d=True, traj_only=True,
            use_mse_loss=use_mse_loss, obstacles=tuple(obstacles),
        )
    else:
        guide = CondKeyLocations(
            target, target_mask, traj_stats, abs_3d=True, traj_only=True,
            use_mse_loss=use_mse_loss,
        )

    traj_out = ddpm_sample_loop(
        traj_pipe.denoiser(y_traj, 1.0), traj_pipe.sched, traj_pipe.dcfg,
        (batch_size, n_frames, 4), generator, noise=traj_noise,
        cond_loss_fn=guide.loss_fn, cond_scale=classifier_scale,
        sampler=traj_pipe.sampler,
    )

    # stage 2: build inpainting tensors — first 4 channels from the traj
    F = 263
    mdev = motion_pipe.device

    def first4(a):
        return torch.as_tensor(np.asarray(a)[:4], dtype=torch.float32, device=mdev)

    traj_denorm = traj_out.to(mdev) * first4(traj_stats.std) + first4(traj_stats.mean)
    motion_scaled = (traj_denorm - first4(motion_stats.mean)) / first4(motion_stats.std)
    inpaint_motion = torch.zeros((batch_size, n_frames, F), device=mdev)
    inpaint_motion[..., :4] = motion_scaled
    inpaint_mask = torch.zeros((batch_size, n_frames, F), dtype=torch.bool, device=mdev)
    inpaint_mask[..., :4] = True

    inpaint = build_inpainting_state(
        inpaint_motion, inpaint_mask,
        imputate=True, stop_imputation_at=impute_until,
    )
    sample = motion_pipe.sample(
        (batch_size, n_frames, F), y_motion, guidance_param=1.0,
        inpaint=inpaint, noise=motion_noise, generator=generator,
    )
    return traj_out, sample
