"""Shared by tests/test_torch_cli*.py: run one CLI's `main` in both frameworks
from the same x_T and the same np.random state, and compare the two
results.npy files (see tests/test_torch_cli.py for the tolerances)."""

from pathlib import Path

import jax
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4  # measured <= 1.6e-5 on motion and joints
DATA_ATOL = 1e-4
SEED_XT = 123


def inject_xt(monkeypatch):
    """Both pipelines start from the same x_T (numpy, from SEED_XT)."""
    from condmdi_tpu.sampling import pipeline as jpipe
    from condmdi_tpu_torch.sampling import pipeline as tpipe

    def xt(shape):
        return np.random.default_rng(SEED_XT).standard_normal(shape).astype(np.float32)

    jax_sample, port_sample = jpipe.SamplePipeline.sample, tpipe.SamplePipeline.sample

    def jax_wrapped(self, rng, shape, y, *args, **kw):  # args: guidance, as dp_sample passes it
        return jax_sample(self, rng, shape, y, *args,
                          **{**kw, "noise": jax.numpy.asarray(xt(shape))})

    def port_wrapped(self, shape, y, **kw):
        return port_sample(self, shape, y, **{**kw, "noise": torch.from_numpy(xt(shape))})

    monkeypatch.setattr(jpipe.SamplePipeline, "sample", jax_wrapped)
    monkeypatch.setattr(tpipe.SamplePipeline, "sample", port_wrapped)


def run_both(jax_main, port_main, argv_jax, argv_port, tmp_path):
    np.random.seed(0)
    jout = jax_main(argv_jax + ["--output_dir", str(tmp_path / "jax")])
    np.random.seed(0)
    tout = port_main(argv_port + ["--output_dir", str(tmp_path / "port")], device="cpu")
    load = lambda d: np.load(Path(d) / "results.npy", allow_pickle=True).item()  # noqa: E731
    return load(jout), load(tout)


def compare(j, t, exact_keys, data_keys=()):
    assert set(t) == set(j)
    for key in exact_keys:
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    for key in data_keys:
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=DATA_ATOL, err_msg=key)
    for key in ("motion", "joints"):
        assert t[key].shape == j[key].shape, key
        assert np.isfinite(t[key]).all(), key
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=ATOL, err_msg=key)
    assert np.abs(j["motion"]).max() > 0.1  # a trajectory, not a constant


def _flat_npz_of_orbax(ckpt_dir: Path, out: Path):
    from condmdi_tpu.utils import checkpoint as jckpt

    params = jckpt.select_eval_params(jckpt.load_checkpoint(ckpt_dir), use_ema=True)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["//".join(prefix + (k,))] = np.asarray(v)

    walk(params, ())
    np.savez(out, **flat)


SHORT_DDIM = ["--use_ddim", "true", "--timestep_respacing", "ddim4"]
