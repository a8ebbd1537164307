"""Shared by tests/test_torch_eval_*.py: run an evaluation CLI's `main` in both
frameworks from the same inputs, and capture what each generated.

Same inputs: x_T injected into both SamplePipelines (torch_cli_helpers.inject_xt),
the synthetic split's features from one codec (`share_the_dataset`), np.random
seeded the same before each run (each main seeds it again with
--seed: the dataset's crops and captions and the diversity draws come from it),
and for the int8 legs the calibration trajectory's x_T and step noise are
JAX's (`inject_jax_calibration_noise`). The reports go to tmp_path, never to
the default output directories, which hold the JAX package's committed reports.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_cli_helpers import SHORT_DDIM, inject_xt

# evals.run at tests/test_eval_cli.py's sizes; --unet_zero false, or a Flax-initialised
# UNet outputs exactly 0 and every sample is the same
TINY_UNET = ["--diffusion_steps", "4", "--num_frames", "32", "--latent_dim", "16", "--arch",
             "unet", "--dim_mults", "1", "2", "--abs_3d", "true", "--unet_zero", "false"]
TINY_MDM = ["--diffusion_steps", "4", "--num_frames", "32", "--latent_dim", "16", "--ff_size",
            "32", "--layers", "1"]
COMMON = ["--eval_mode", "debug", "--num_samples", "32", "--text_encoder", "hash"] + SHORT_DDIM
KEYFRAMES = ["--edit_mode", "benchmark_sparse", "--transition_length", "10",
             "--guidance_param", "1.0"]


# the tier-1 run puts 6 pytest workers on 8 cores; at torch's default of a thread per
# core they oversubscribe them, and the port's small-op evaluation ran ~3x slower so
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Import into a test module: torch runs on TORCH_THREADS threads while its
    tests run, and on what it had before afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def capture_batches(monkeypatch):
    """Record every GeneratedBatch each framework's harness returns."""
    from condmdi_tpu.evals import harness as jh
    from condmdi_tpu_torch.evals import harness as th

    seen = {"jax": [], "port": []}

    def recorder(module, key):
        real = module.generate_eval_batch

        def wrapped(*a, **kw):
            gb = real(*a, **kw)
            seen[key].append(gb)
            return gb
        return wrapped

    for module, key in ((jh, "jax"), (th, "port")):
        monkeypatch.setattr(module, "generate_eval_batch", recorder(module, key))
    return seen


def inject_jax_calibration_noise(monkeypatch, seed):
    """The port's trajectory calibration draws JAX's x_T and step noise for `seed`
    (condmdi_tpu/ops/quant.py calibrate_act_scales_trajectory: x_T from
    key(seed), then one split per step)."""
    import condmdi_tpu_torch.ops.quant as tq

    real = tq.calibrate_act_scales_trajectory

    def calibrate(model, sched, dcfg, shape, y, *, generator=None, **kw):
        rng = jax.random.key(seed)
        x_T = torch.from_numpy(np.asarray(jax.random.normal(rng, shape)))
        zs = []
        for _ in range(sched.num_timesteps):
            rng, nrng = jax.random.split(rng)
            zs.append(torch.from_numpy(np.asarray(jax.random.normal(nrng, shape))))
        return real(model, sched, dcfg, shape, y, noise=x_T, step_noise=zs, **kw)

    monkeypatch.setattr(tq, "calibrate_act_scales_trajectory", calibrate)


def share_the_dataset(monkeypatch):
    """Both frameworks' synthetic splits take their items' features from the
    port's codec (the two codecs are 2e-5 apart and held against each other by
    tests/test_torch_dataset.py), so the GT batches are the same arrays; the JAX
    package then compiles no FK and codec for them."""
    from condmdi_tpu.data.dataset import SyntheticMotionDataset as JaxDataset
    from condmdi_tpu_torch.data.dataset import SyntheticMotionDataset as PortDataset

    def make_items(cfg, seed, size, T, return_props=False):
        feats, props = PortDataset._make_items(cfg, seed, size, T, torch.device("cpu"))
        return (feats, props) if return_props else feats

    monkeypatch.setattr(JaxDataset, "_make_items", staticmethod(make_items))


def run_both(jax_main, port_main, argv_jax, argv_port, tmp_path, monkeypatch):
    """(JAX summary, port summary, JAX report, port report, captured batches)."""
    inject_xt(monkeypatch)
    share_the_dataset(monkeypatch)
    seen = capture_batches(monkeypatch)
    np.random.seed(0)
    jax_sum = jax_main(argv_jax + ["--output_dir", str(tmp_path / "jax")])
    np.random.seed(0)
    port_sum = port_main(argv_port + ["--output_dir", str(tmp_path / "port")], device="cpu")

    def report(d):
        (path,) = Path(d).glob("eval_*.json")
        return path.name, json.loads(path.read_text())

    return jax_sum, port_sum, report(tmp_path / "jax"), report(tmp_path / "port"), seen


def metric_gaps(jax_sum, port_sum):
    """{metric: max |port - jax| over its mean vector}."""
    return {k: float(np.max(np.abs(np.asarray(port_sum[k]["mean"]) -
                                   np.asarray(jax_sum[k]["mean"]))))
            for k in jax_sum if isinstance(jax_sum[k], dict)}


# the float and t2m legs' tolerances (measured values in tests/test_torch_eval_cli.py)
METRIC_TOL = 1e-4


def close(got, want, tol=METRIC_TOL):
    """|got - want| <= tol·(1 + |want|) everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), (got, want)


def assert_batches_match(seen):
    """Each GeneratedBatch of the port against JAX's: motions_rel held as
    tests/test_torch_quant.py holds a module, the rest within METRIC_TOL or equal."""
    assert len(seen["port"]) == len(seen["jax"]) > 0
    for got, want in zip(seen["port"], seen["jax"]):
        assert got.motions_rel.shape == want.motions_rel.shape == (32, 32, 263)
        assert np.isfinite(got.motions_rel).all() and np.abs(want.motions_rel).max() > 0.1
        d = np.abs(got.motions_rel.astype(np.float64) - want.motions_rel)
        a = np.abs(want.motions_rel.astype(np.float64))
        assert d.mean() / a.mean() <= 1e-4
        assert np.mean(d > 1e-3 * (1 + a)) <= 1e-3
        assert np.all(d <= 1e-2 * (1 + a))
        np.testing.assert_array_equal(got.lengths, want.lengths)
        np.testing.assert_array_equal(got.num_keyframes, want.num_keyframes)
        assert got.captions == want.captions and got.tokens == want.tokens
        for key in ("dist_error", "keyframe_error", "skate_ratio"):
            close(getattr(got, key), getattr(want, key))


def assert_reports_match(run):
    """The port's summary and report against JAX's: the same name and keys, every
    metric (summary and per_replication) within METRIC_TOL, JAX's meta keys kept."""
    jax_sum, port_sum, (jname, jrep), (pname, prep), _ = run
    assert pname == jname
    assert set(port_sum) == set(jax_sum)
    for key in metric_gaps(jax_sum, port_sum):
        close(port_sum[key]["mean"], jax_sum[key]["mean"])
        close(port_sum[key]["conf"], jax_sum[key]["conf"])
        close(prep["per_replication"][key], jrep["per_replication"][key])
    assert set(prep) == set(jrep)
    assert set(jrep["meta"]) <= set(prep["meta"])
    assert prep["meta"]["platform"] == "cpu" and prep["meta"]["synthetic_data"] is True
    for key in ("protocol", "evaluator", "text_encoder", "eval_mode", "replications"):
        assert prep["meta"][key] == jrep["meta"][key], key
    assert prep["meta"]["evaluator"] == "trained_synthetic"
    fid = np.asarray(port_sum["fid"]["mean"])
    assert np.isfinite(fid) and fid > 0 and port_sum["diversity"]["mean"] > 0
