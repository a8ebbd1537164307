"""The port's GMD entry points against the JAX package's, on the CPU: the
`generate_gmd` CLI in all six guidance modes (results.npy with the JAX CLI's
keys and the same keyframes, obstacles, pattern, texts and lengths at the
same small argv), the `evals.run_condition` protocol in debug mode (as
tests/test_eval_cli.py runs the JAX one; the report's keys those of the
committed JAX report save/eval_out/eval_condition_debug.json, the keyframe
targets JAX's for the same seed), utils/assets and utils/layout against
JAX's, and viz/plot writing its files.
"""

import json
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest

from torch_eval_helpers import few_torch_threads  # noqa: F401  (module fixture)

REPO = Path(__file__).resolve().parent.parent
# the JAX recipe's shrink flags (ROADMAP); 28 frames, a UNet of two levels padded to 28;
# --unet_zero false, or a Flax-initialised UNet outputs exactly 0
SMALL = ["--diffusion_steps", "4", "--num_frames", "28", "--motion_length", "1.4",
         "--latent_dim", "16", "--arch", "unet", "--dim_mults", "1", "2", "--unet_pad_to", "28",
         "--num_samples", "2", "--num_repetitions", "1", "--unet_zero", "false",
         "--text_encoder", "hash", "--text_prompt", "a person walks in a square"]
MODES = ["no", "testing", "trajectory", "mdm_legacy", "kps", "sdf"]
EXACT = ("text", "lengths", "kframes", "obstacles", "guidance_mode", "pattern", "text_encoder",
         "random_init_model")


@pytest.mark.parametrize("mode", MODES)
def test_generate_gmd_writes_the_jax_clis_results(mode, tmp_path):
    from condmdi_tpu.sampling import generate_gmd as jax_cli
    from condmdi_tpu_torch.sampling import generate_gmd as port_cli

    argv = SMALL + ["--guidance_mode", mode, "--abs_3d", "true", "--classifier_scale", "5"]
    load = lambda d: np.load(Path(d) / "results.npy", allow_pickle=True).item()  # noqa: E731
    j = load(jax_cli.main(argv + ["--output_dir", str(tmp_path / "jax")]))
    t = load(port_cli.main(argv + ["--output_dir", str(tmp_path / "port")], device="cpu"))
    assert set(t) == set(j)
    for key in EXACT:
        assert t[key] == j[key] if not isinstance(j[key], np.ndarray) else \
            np.array_equal(t[key], j[key]), key
    for key in ("motion", "joints"):
        assert t[key].shape == j[key].shape and np.isfinite(t[key]).all(), key
        assert float(t[key].std()) > 0, key
    assert (tmp_path / "port" / "trajectory.png").stat().st_size > 0


def test_generate_gmd_imputes_the_trajectory(tmp_path):
    """trajectory mode (abs root): through t = 0 the p2p trajectory is imputed into
    channels 1:3 of the identity-normalised features exactly."""
    from condmdi_tpu_torch.sampling import generate_gmd
    from condmdi_tpu_torch.sampling.gmd import get_kframes, interpolate_kframes_trajectory

    out = generate_gmd.main(SMALL + ["--guidance_mode", "trajectory", "--abs_3d", "true",
                                     "--classifier_scale", "5", "--output_dir", str(tmp_path)],
                            device="cpu")
    r = np.load(out / "results.npy", allow_pickle=True).item()
    want = interpolate_kframes_trajectory(get_kframes("square"), 28)
    np.testing.assert_array_equal(r["motion"][..., 1:3], np.broadcast_to(want, (2, 28, 2)))


def test_run_condition_debug_protocol(tmp_path):
    from condmdi_tpu_torch.evals.run_condition import main

    summary = main([
        "--eval_mode", "debug", "--diffusion_steps", "4", "--num_frames", "32",
        "--latent_dim", "16", "--arch", "unet", "--dim_mults", "1", "2", "--num_samples", "32",
        "--model_path", "", "--text_encoder", "hash", "--unet_zero", "false",
        "--output_dir", str(tmp_path),
    ], device="cpu")
    assert np.isfinite(summary["fid"]["mean"])
    # trajectory-error vector: [traj_fail_20cm, traj_fail_50cm, kps_fail_20cm,
    # kps_fail_50cm, kps_mean_err]
    assert len(summary["traj_error"]["mean"]) == 5
    assert np.isfinite(summary["traj_error"]["mean"]).all()
    assert np.isfinite(summary["keyframe_error"]["mean"])
    report = json.loads((tmp_path / "eval_condition_debug.json").read_text())
    committed = json.loads((REPO / "save/eval_out/eval_condition_debug.json").read_text())
    assert set(report) == set(committed)
    assert set(report["per_replication"]) == set(committed["per_replication"])
    # JAX's meta keys, and the card's name, which every report of the port records
    assert set(report["meta"]) == set(committed["meta"]) | {"device_name"}
    assert report["meta"]["random_init_models"] is True
    assert "two-stage" in report["meta"]["protocol"]
    assert report["meta"]["replications"] == 5 and report["meta"]["platform"] == "cpu"


def test_keyframe_targets_are_jaxs_for_the_same_seed():
    from condmdi_tpu.evals.run_condition import _gt_keyframe_targets as jax_targets
    from condmdi_tpu_torch.evals.run_condition import _gt_keyframe_targets as port_targets

    joints = np.random.default_rng(0).standard_normal((32, 40, 22, 3)).astype(np.float32)
    lengths = np.random.default_rng(1).integers(2, 41, 32)
    for seed in (10, 11):
        jt, jm = jax_targets(joints, lengths, np.random.default_rng(seed))
        pt, pm = port_targets(joints, lengths, np.random.default_rng(seed))
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pm, jm)
    assert jm.any(axis=(2, 3)).sum(axis=1).tolist() == [5] * 32


def test_assets_match_jax(tmp_path, monkeypatch):
    from condmdi_tpu.utils import assets as jax_assets
    from condmdi_tpu_torch.data import dataset
    from condmdi_tpu_torch.utils import assets

    assert dataset.NormStats is assets.NormStats
    assert [astuple(a) for a in assets.ASSETS] == [astuple(a) for a in jax_assets.ASSETS]
    root = tmp_path / "root"
    (root / "save/clip").mkdir(parents=True)
    (root / "save/clip/ViT-B-32.pt").write_bytes(b"x")
    assert assets.check_assets(root) == jax_assets.check_assets(root)

    rng = np.random.default_rng(4)
    (tmp_path / "HumanML3D_abs").mkdir()
    for name, dim in (("HumanML3D_abs/Mean_abs_3d", 263), ("HumanML3D_abs/Std_abs_3d", 263),
                      ("t2m_mean", 263), ("t2m_std", 263), ("kit_mean", 251), ("kit_std", 251)):
        np.save(tmp_path / f"{name}.npy", rng.random(dim))
    np.save(tmp_path / "000021.npy", rng.random((5, 66)))
    for kind in ("abs3d", "t2m", "kit"):
        got, want = assets.load_norm_stats(kind, tmp_path), jax_assets.load_norm_stats(kind, tmp_path)
        assert got.mean.dtype == np.float32
        np.testing.assert_array_equal(got.mean, want.mean)
        np.testing.assert_array_equal(got.std, want.std)
        x = rng.random(want.mean.shape).astype(np.float32)
        np.testing.assert_array_equal(got.denormalize(got.normalize(x)),
                                      want.denormalize(want.normalize(x)))
    np.testing.assert_array_equal(assets.load_skeleton_example(tmp_path),
                                  jax_assets.load_skeleton_example(tmp_path))
    assert assets.load_skeleton_example(tmp_path / "root") is None

    # no asset directory: JAX's warned identity fallback
    monkeypatch.setattr(assets, "_CANDIDATES", (str(tmp_path / "nope"),))
    assert assets.find_assets_dir() is None
    with pytest.warns(UserWarning, match="IDENTITY"):
        st = assets.load_norm_stats("kit")
    np.testing.assert_array_equal(st.mean, np.zeros(251, np.float32))
    np.testing.assert_array_equal(st.std, np.ones(251, np.float32))
    monkeypatch.setattr(assets, "_CANDIDATES", ("", str(tmp_path)))
    assert assets.find_assets_dir() == tmp_path


def test_layout_matches_jax():
    from condmdi_tpu.utils import layout as jax_layout
    from condmdi_tpu_torch.utils import layout

    ref = np.random.default_rng(5).standard_normal((2, 25, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(layout.from_reference_layout(ref),
                                  jax_layout.from_reference_layout(ref))
    flat = layout.from_reference_layout(ref)
    assert flat.shape == (2, 7, 150)
    np.testing.assert_array_equal(layout.to_reference_layout(flat, nfeats=6),
                                  jax_layout.to_reference_layout(flat, nfeats=6))
    np.testing.assert_array_equal(layout.to_reference_layout(flat, nfeats=6), ref)


def test_plots_are_written(tmp_path):
    from condmdi_tpu_torch.sampling.gmd import get_kframes, get_obstacles
    from condmdi_tpu_torch.viz import plot

    joints = np.random.default_rng(6).standard_normal((2, 4, 22, 3)).astype(np.float32)
    png = plot.plot_trajectory_with_kframes(joints[0], get_kframes("zigzag"), get_obstacles(),
                                            tmp_path / "traj" / "trajectory.png")
    assert png.stat().st_size > 0
    assert plot.plot_trajectory_with_kframes(None, [], None, tmp_path / "empty.png").exists()
    video = plot.save_stick_figure_video(joints[0], tmp_path / "sample00.mp4", title="a walk")
    assert video.exists() and video.stat().st_size > 0  # a GIF where ffmpeg is absent
    mask = np.zeros((2, 4), bool)
    mask[:, 1] = True
    paths = plot.plot_conditional_samples(joints, mask, tmp_path / "grid", texts=["a", "b"])
    assert len(paths) == 2 and all(p.exists() and p.stat().st_size > 0 for p in paths)
