"""Tiny cells for the CPU tests: the real cells' drivers and references at widths
and lengths a test run holds, in a copy of the benchmark's folder."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

UNET = dict(card="motion_abs_unet_adagn_xl",
            card_overrides=dict(keyframe_conditioned=True, latent_dim=16, dim_mults=[1, 2],
                                unet_pad_to=16, num_frames=16, batch_size=4, diffusion_steps=20),
            reference="unet", njoints=263, latent_dim=16, dim_mults=[1, 2], clip_dim=512, pad=16,
            frames=12, diffusion_steps=20)
# training in float32 throughout, so the step and the reference agree to rounding
UNET_F32 = dict(UNET, card_overrides=dict(UNET["card_overrides"], use_fp16=False))
MDM = dict(card="motion_mdm", card_overrides=dict(latent_dim=16, ff_size=32, layers=2,
                                                   diffusion_steps=20),
           reference="mdm", njoints=263, latent_dim=16, ff_size=32, layers=2, heads=4,
           clip_dim=512, frames=12, diffusion_steps=20)
SERVE = dict(driver="serve_open_loop", precision="f32", rate_per_s=6, max_batch=4,
             max_wait_ms=20, guidance=2.5, frames=12, keyframes=[2, 5], drain_s=60,
             trace_slice_s=1, check=dict(requests=3, limit=1e-3))
OFFLINE = dict(driver="offline_batch", precision="f32", batch=3, guidance=2.5,
               frames=12, check=dict(requests=3, limit=1e-3))
TRAIN = dict(driver="train_steps", batch=4, frames=16, lengths=[8, 16], pool=16, use_fp16=False,
             trace_slice_steps=2, probe_replays=3,
             check=dict(steps=3, limits=dict(loss=1e-4, grad=1e-3, change=1e-3)))

E2E = [dict(name="latency_p90_s", unit="s", better="lower", bound=0.25, source="host_clock",
            workloads=["tiny.serve_kf", "tiny.serve_text"]),
       dict(name="samples_per_s", unit="samples/s", better="higher", bound=0.25,
            source="host_clock", workloads=["tiny.offline"]),
       dict(name="train_steps_per_s", unit="steps/s", better="higher", bound=0.25,
            source="host_clock", workloads=["tiny.train"]),
       dict(name="setup_s", unit="s", better="lower", bound=0.25, source="host_clock")]


def tree(tmp: Path) -> Path:
    """A copy of benchmark/ with the tiny configurations and mixes added as files."""
    dst = tmp / "benchmark"
    shutil.copytree(ROOT / "benchmark", dst, ignore=shutil.ignore_patterns("__pycache__"))
    for name, body in (("configs/tiny_unet", UNET), ("configs/tiny_unet_f32", UNET_F32),
                       ("configs/tiny_mdm", MDM),
                       ("traffic/tiny_serve_kf", SERVE),
                       ("traffic/tiny_serve_text", dict(SERVE, keyframes=None)),
                       ("traffic/tiny_offline", OFFLINE), ("traffic/tiny_train", TRAIN)):
        (dst / f"{name}.json").write_text(json.dumps(body))
    return dst


def bench() -> dict:
    cells = [("tiny.serve_kf", "tiny_unet", "tiny_serve_kf"),
             ("tiny.serve_text", "tiny_mdm", "tiny_serve_text"),
             ("tiny.offline", "tiny_mdm", "tiny_offline"),
             ("tiny.train", "tiny_unet_f32", "tiny_train")]
    return dict(workloads=[dict(name=n, config=c, traffic=t, chips=1, why="a test")
                           for n, c, t in cells], end_to_end=E2E, per_layer=[])


def execute(root: Path, name: str, seed: int = 2**31 + 5, seconds: float = 1.0) -> dict:
    from benchmark import run as bench_run

    return bench_run.execute(bench(), name, seed, seconds, False, "cpu", root=root,
                             t_start=time.perf_counter())
