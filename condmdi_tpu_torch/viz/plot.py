"""Stick-figure motion visualization (host-side matplotlib).

Counterpart of condmdi_tpu/viz/plot.py, on numpy arrays (a caller hands over
joints it has brought to the host), with the kinematic chain of the port's
geometry/skeleton.py. Feature parity with reference
data_loaders/humanml/utils/plot_script.py (plot_3d_motion: kinematic-chain
stick figure, ground plane, trajectory trace, keyframe highlighting via
`gt_frames`) and plotting.py (plot_conditional_samples grid). matplotlib is
imported inside the functions: the CLIs call them best-effort and go on
where it is absent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from condmdi_tpu_torch.geometry.skeleton import T2M_KINEMATIC_CHAIN

_COLORS = ["red", "blue", "black", "darkred", "darkblue"]


def plot_3d_motion(
    save_path: str | Path,
    joints: np.ndarray,
    title: str = "",
    fps: int = 20,
    radius: float = 3.0,
    kinematic_tree=T2M_KINEMATIC_CHAIN,
    gt_frames: Sequence[int] = (),
):
    """Render [T, 22, 3] joints to an mp4 (or gif fallback)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    joints = np.asarray(joints)
    T = joints.shape[0]
    data = joints.copy()
    # ground the feet and center the trajectory like the reference
    data[..., 1] -= data[..., 1].min()
    traj = data[:, 0, [0, 2]]

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")

    def update(t):
        ax.clear()
        ax.set_xlim3d(-radius / 2, radius / 2)
        ax.set_ylim3d(0, radius)
        ax.set_zlim3d(0, radius)
        ax.view_init(elev=120, azim=-90)
        ax.dist = 7.5
        ax.set_title(title, fontsize=8)
        ax.grid(False)
        ax.axis("off")
        offset = data[t, 0, [0, 2]]
        # trajectory trace
        ax.plot(
            traj[:t, 0] - offset[0],
            np.zeros_like(traj[:t, 0]),
            traj[:t, 1] - offset[1],
            linewidth=1.0,
            color="blue",
        )
        for i, chain in enumerate(kinematic_tree):
            color = "green" if t in gt_frames else _COLORS[i % len(_COLORS)]
            lw = 4.0 if i < 5 else 2.0
            ax.plot(
                data[t, chain, 0] - offset[0],
                data[t, chain, 1],
                data[t, chain, 2] - offset[1],
                linewidth=lw,
                color=color,
            )

    anim = FuncAnimation(fig, update, frames=T, interval=1000 / fps)
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    from matplotlib import animation as _mpl_anim

    # Pillow (the only writer guaranteed present) can't encode mp4; pick the
    # container per available writer and return the path actually written.
    if save_path.suffix == ".mp4" and not _mpl_anim.writers.is_available("ffmpeg"):
        save_path = save_path.with_suffix(".gif")
    try:
        anim.save(str(save_path), fps=fps)
    except Exception:
        save_path = save_path.with_suffix(".gif")
        anim.save(str(save_path), fps=fps, writer="pillow")
    plt.close(fig)
    return save_path


def save_stick_figure_video(joints: np.ndarray, path: str | Path, title: str = ""):
    return plot_3d_motion(path, joints, title=title)


def plot_conditional_samples(
    joints: np.ndarray,  # [n_samples, T, 22, 3]
    observed_mask_frames: Optional[np.ndarray],  # [n_samples, T] bool or None
    out_dir: str | Path,
    texts: Optional[Sequence[str]] = None,
    prefix: str = "sample",
):
    """Per-sample videos with observed keyframes highlighted
    (reference plotting.py plot_conditional_samples)."""
    out_dir = Path(out_dir)
    paths = []
    for i in range(len(joints)):
        gt_frames = (
            list(np.where(observed_mask_frames[i])[0])
            if observed_mask_frames is not None
            else []
        )
        title = texts[i] if texts else ""
        paths.append(
            plot_3d_motion(
                out_dir / f"{prefix}{i:02d}.mp4", joints[i], title=title,
                gt_frames=gt_frames,
            )
        )
    return paths


def plot_trajectory_with_kframes(
    joints: Optional[np.ndarray],  # [T, 22, 3] or None
    kframes: Sequence[tuple[int, tuple[float, float]]],
    obstacles: Optional[Sequence[tuple[float, float, float]]],
    path: str | Path,
):
    """Top-down xz plot: generated pelvis trajectory, keyframe targets, and
    SDF obstacles (reference sample/gmd/generate.py trajectory logging via
    log_trajectory_from_xstart, condition.py:90)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    fig, ax = plt.subplots(figsize=(5, 5))
    if joints is not None:
        ax.plot(joints[:, 0, 0], joints[:, 0, 2], "-", color="tab:blue",
                label="pelvis trajectory")
    if kframes:
        ks = np.array([p for _, p in kframes], np.float32)
        ax.scatter(ks[:, 0], ks[:, 1], marker="x", color="tab:red",
                   label="keyframe targets", zorder=3)
    for (ox, oz, r) in obstacles or ():
        ax.add_patch(Circle((ox, oz), r, color="gray", alpha=0.4))
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=96, bbox_inches="tight")
    plt.close(fig)
    return path
