"""The port's training entry point (`training.train.main`) on the CPU.

Mirrors tests/test_train_cli.py and tests/test_logger.py for the port, at the
JAX test's sizes (latent 16, dim_mults 1 2, 28 frames, 8 diffusion steps):

  * 4 steps saved at step 2 (DIFFUSION_TRAINING_TEST) and resumed equal the
    straight 4-step run bit for bit: parameters, EMA, optimizer state, the
    logged metrics; streamed from the host loader, and from the device data
    cache with a re-collation across the resume and 2 steps a dispatch;
  * --overwrite restarts from step 0; progress.csv has the JAX run's columns
    (the committed save/synthetic_unet_m/progress.csv for the chained loop);
  * --steps_per_dispatch saves on the JAX loop's boundaries and runs the
    tail single-step;
  * in-training evaluation (the port's evals.run on the EMA npz) logs its
    metrics and leaves the training stream as it was: final parameters bit
    for bit those of the run without it;
  * the EMA npz carries its fingerprint and step, samples through the
    port's conditional CLI, and through the JAX model gives the port's
    forward within 1e-5 * (1 + |jax|);
  * the KV logger writes log.txt and progress.csv as the JAX logger does;
  * main runs on CUDA unless asked for the CPU, and raises without a card.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from condmdi_tpu_torch.training import train
from condmdi_tpu_torch.utils import checkpoint as ckpt
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

BASE = ["--num_steps", "4", "--save_interval", "2", "--log_interval", "1", "--batch_size", "4",
        "--num_frames", "28", "--latent_dim", "16", "--dim_mults", "1", "2",
        "--diffusion_steps", "8", "--keyframe_conditioned", "true", "--use_fp16", "false",
        "--data_dir", "/nonexistent", "--text_encoder", "hash"]
CACHED = ["--device_data_cache", "true", "--device_cache_refresh", "3",
          "--steps_per_dispatch", "2", "--num_steps", "6"]
FWD_TOL = 1e-5


def run(save_dir, extra=(), stop_after_save=False, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1" if stop_after_save else "")
    return train.main(BASE + list(extra) + ["--save_dir", str(save_dir)], device="cpu")


def assert_same_state(a: Path, b: Path):
    sa, sb = ckpt.load_checkpoint(a), ckpt.load_checkpoint(b)
    for key in ("model",):
        assert sa[key].keys() == sb[key].keys()
        for k in sa[key]:
            assert torch.equal(sa[key][k], sb[key][k]), k
    for k in sa["train_state"]["ema"]:
        assert torch.equal(sa["train_state"]["ema"][k], sb["train_state"]["ema"][k]), k
    oa, ob = sa["train_state"]["optimizer"]["state"], sb["train_state"]["optimizer"]["state"]
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


def progress(save_dir):
    with open(Path(save_dir) / "progress.csv") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("extra", [[], CACHED], ids=["streamed", "device_cache"])
def test_resume_equals_the_straight_run(tmp_path, monkeypatch, extra):
    run(tmp_path / "straight", extra, monkeypatch=monkeypatch)
    first = run(tmp_path / "resumed", extra, stop_after_save=True, monkeypatch=monkeypatch)
    assert first.state.step == 2
    assert [p.name for p in sorted((tmp_path / "resumed").glob("ckpt_*"))] == \
        ["ckpt_000000002.pth"]
    second = run(tmp_path / "resumed", extra, monkeypatch=monkeypatch)
    assert second.resume_step == 2
    last = sorted((tmp_path / "straight").glob("ckpt_*"))[-1].name
    assert_same_state(tmp_path / "straight" / last, tmp_path / "resumed" / last)
    straight = {r["step"]: r for r in progress(tmp_path / "straight")}
    resumed = progress(tmp_path / "resumed")
    assert [r["step"] for r in resumed] == list(straight)
    for row in resumed:  # the logger pads the rows before a reopened file's header
        for k, v in row.items():
            if k not in (None, "steps_per_sec"):
                assert v == straight[row["step"]][k], (row["step"], k)


def test_overwrite_restarts_and_progress_columns(tmp_path, monkeypatch):
    run(tmp_path / "run", monkeypatch=monkeypatch)
    loop = run(tmp_path / "run", ["--overwrite", "true", "--num_steps", "2"],
               monkeypatch=monkeypatch)
    assert loop.resume_step == 0
    assert sorted(p.name for p in (tmp_path / "run").glob("ckpt_*")) == ["ckpt_000000002.pth"]
    assert (tmp_path / "run" / "args.json").exists()
    header = (tmp_path / "run" / "progress.csv").read_text().splitlines()[0].split(",")
    assert header == ["grad_norm", "keyframes_mse", "loss", "loss_q0", "loss_q1", "loss_q2",
                      "loss_q3", "param_norm", "rot_mse", "step", "steps_per_sec"]
    assert "loss" in (tmp_path / "run" / "log.txt").read_text()
    # the chained loop adds loss_last, as the committed JAX run's csv shows
    run(tmp_path / "chained", CACHED, monkeypatch=monkeypatch)
    committed = Path("save/synthetic_unet_m/progress.csv").read_text().splitlines()[0]
    got = (tmp_path / "chained" / "progress.csv").read_text().splitlines()[0]
    assert got.split(",") == committed.split(",")


def test_chained_steps_save_on_boundaries_and_run_the_tail(tmp_path, monkeypatch):
    run(tmp_path / "run", ["--num_steps", "9", "--save_interval", "4", "--log_interval", "4",
                           "--device_data_cache", "true", "--device_cache_refresh", "0",
                           "--steps_per_dispatch", "4"], monkeypatch=monkeypatch)
    names = sorted(p.name for p in (tmp_path / "run").glob("ckpt_*"))
    assert names == ["ckpt_000000004.pth", "ckpt_000000008.pth", "ckpt_000000009.pth"]
    state = ckpt.load_checkpoint(tmp_path / "run" / "ckpt_000000009.pth")
    assert state["step"] == 9 and state["train_state"]["step"] == 9
    assert all(torch.isfinite(v).all() for v in state["model"].values())
    assert [r["step"] for r in progress(tmp_path / "run")] == ["4", "8"]


def test_eval_during_training_does_not_perturb_training(tmp_path, monkeypatch):
    """One evaluation, at the save of step 2; the step after it must be the same."""
    three = ["--num_steps", "3"]
    run(tmp_path / "plain", three, monkeypatch=monkeypatch)
    run(tmp_path / "with_eval", three + ["--eval_during_training", "true",
                                         "--eval_num_samples", "8"], monkeypatch=monkeypatch)
    assert "eval/" in (tmp_path / "with_eval" / "progress.csv").read_text()
    assert (tmp_path / "with_eval" / "eval_000000002").is_dir()
    assert_same_state(tmp_path / "plain" / "ckpt_000000003.pth",
                      tmp_path / "with_eval" / "ckpt_000000003.pth")


def test_ema_npz_samples_through_conditional_and_the_jax_model(tmp_path, monkeypatch):
    from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
    from condmdi_tpu_torch.models.unet import MDM_UNET as TorchUNet
    from condmdi_tpu_torch.sampling import conditional
    from condmdi_tpu_torch.weights import load_flax_params, read_params, to_flax_params

    loop = run(tmp_path / "run", monkeypatch=monkeypatch)
    npz = tmp_path / "run" / "ema_000000004.npz"
    with np.load(npz) as z:
        fp, step = str(z["__params_fingerprint__"]), int(z["__step__"])
    assert step == 4 and fp == ckpt.params_fingerprint(to_flax_params(loop.state.ema))
    assert ckpt.parse_step_from_checkpoint(npz) == 4
    assert ckpt.latest_checkpoint(tmp_path / "run").name == "ckpt_000000004.pth"

    res = conditional.main(["--model_path", str(npz), "--edit_mode", "benchmark_sparse",
                            "--transition_length", "10", "--guidance_param", "1.0",
                            "--diffusion_steps", "8", "--num_samples", "2",
                            "--num_repetitions", "1", "--abs_3d", "true",
                            "--output_dir", str(tmp_path / "out")], device="cpu")
    out = np.load(tmp_path / "out" / "results.npy", allow_pickle=True).item()
    assert out["motion"].shape[0] == 2 and np.isfinite(out["motion"]).all()
    del res

    cfg = dict(njoints=263, latent_dim=16, dim_mults=(1, 2), keyframe_conditioned=True,
               pad_frames_to=224)
    tree = {}
    for path, arr in read_params(npz).items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = jnp.asarray(arr)
    tm = TorchUNet(**cfg, device="cpu", seed=None)
    tm.load_state_dict(load_flax_params(str(npz)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 28, 263)).astype(np.float32)
    obs = rng.random((2, 28, 263)) < 0.2
    text = rng.standard_normal((2, 512)).astype(np.float32)
    t = np.array([3, 700])
    want = JaxUNet(**cfg).apply(tree, jnp.asarray(x), jnp.asarray(t),
                                {"text_embed": jnp.asarray(text)}, obs_x0=jnp.asarray(x),
                                obs_mask=jnp.asarray(obs))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), {"text_embed": torch.from_numpy(text)},
                 obs_x0=torch.from_numpy(x), obs_mask=torch.from_numpy(obs))
    err = np.abs(got.numpy() - np.asarray(want))
    assert np.all(err <= FWD_TOL * (1 + np.abs(np.asarray(want)))), float(err.max())


def test_logger_writes_log_and_csv_as_jax(tmp_path):
    from condmdi_tpu.utils import logger as jlog
    from condmdi_tpu_torch.utils import logger as tlog

    for mod, d in ((jlog, tmp_path / "jax"), (tlog, tmp_path / "torch")):
        mod.configure(str(d), format_strs=["log", "csv"])
        mod.logkv("a", 1.5)
        mod.logkv_mean("m", 1.0)
        mod.logkv_mean("m", 2.0)
        mod.dumpkvs()
        mod.logkvs({"a": 2.0, "b": 3})  # a new column rewrites the header
        mod.dumpkvs()
        mod.log("done")
        with mod.profile_kv("scope"):
            pass
        mod.get_current().close()
    for name in ("log.txt", "progress.csv"):
        assert (tmp_path / "torch" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_main_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    """This host has no card: the default device raises before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(BASE + ["--save_dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
