"""The port's sampling and editing CLIs against the JAX package's, end to end on the CPU.

Each parity test runs one CLI's `main` in both frameworks on the same argv
and compares the two results.npy files (tests/torch_cli_helpers.py):

  * here, `conditional` on the committed save/synthetic_unet_s/ckpt_000030000:
    JAX restores it from Orbax, the port reads the same EMA parameters from a
    flat npz the test writes beside a copy of its args.json; benchmark_sparse,
    with imputation and reconstruction guidance at a small weight;
  * in tests/test_torch_cli_mdm.py, `edit` (benchmark_clip, imputation) and
    `synthesize` on small MDMs with no checkpoint, so both draw Flax's
    initialisation from --seed.

All run deterministic DDIM (eta 0) at a short respacing with the same x_T,
injected by wrapping each side's `SamplePipeline.sample`; np.random is
seeded the same before each run (the dataset draws its crops and captions
from it). The JAX stick-figure video is switched off (the port skips it).
Same keys; masks, lengths and captions equal; the observed motion within
DATA_ATOL (the synthetic dataset's features go through each framework's own
float32 codec, 2e-5 apart); motion and joints within ATOL, float32 through a
whole short trajectory that starts from observations DATA_ATOL apart
(measured up to 1.6e-5). Also here: the CLIs' refusals (no CUDA, an Orbax
directory, keyframe_guidance_param, an unknown edit mode), and that each CLI
samples with TF32 off and leaves the flags as it found them.
"""

import shutil

import numpy as np
import pytest
import torch

from torch_cli_helpers import (REPO, SHORT_DDIM, _flat_npz_of_orbax, compare, inject_xt,
                              run_both)


def test_conditional_matches_jax_on_the_trained_checkpoint(tmp_path, monkeypatch):
    from condmdi_tpu.sampling.conditional import main as jax_main
    from condmdi_tpu_torch.sampling.conditional import main as port_main

    ckpt = REPO / "save" / "synthetic_unet_s" / "ckpt_000030000"
    port_dir = tmp_path / "port_ckpt"
    port_dir.mkdir()
    _flat_npz_of_orbax(ckpt, port_dir / "ckpt_000030000.npz")
    shutil.copy(ckpt.parent / "args.json", port_dir / "args.json")
    inject_xt(monkeypatch)
    common = ["--edit_mode", "benchmark_sparse", "--num_samples", "2", "--num_repetitions", "1",
              "--imputate", "true", "--reconstruction_guidance", "true",
              "--reconstruction_weight", "0.05", "--text_encoder", "hash"] + SHORT_DDIM
    j, t = run_both(jax_main, port_main, common + ["--model_path", str(ckpt)],
                     common + ["--model_path", str(port_dir / "ckpt_000030000.npz")], tmp_path)
    compare(j, t, ("observed_mask", "lengths", "text", "edit_mode", "text_encoder"),
             ("observed_motion",))
    assert t["observed_mask"].any()
    m = t["observed_mask"]
    np.testing.assert_array_equal(t["motion"][m], t["observed_motion"][m])  # imputation


@pytest.mark.parametrize("cli", ["conditional", "edit", "synthesize"])
def test_cli_defaults_to_cuda_and_raises_without_it(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    import importlib

    main = importlib.import_module(f"condmdi_tpu_torch.sampling.{cli}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--output_dir", str(tmp_path)])


def test_orbax_directory_is_refused_with_a_clear_error(tmp_path):
    from condmdi_tpu_torch.sampling.conditional import main

    with pytest.raises(ValueError, match="Orbax"):
        main(["--model_path", str(REPO / "save" / "synthetic_unet_s" / "ckpt_000030000"),
              "--num_samples", "1", "--output_dir", str(tmp_path)], device="cpu")


def test_keyframe_guidance_param_other_than_one_raises(tmp_path):
    from condmdi_tpu_torch.sampling.conditional import main

    with pytest.raises(NotImplementedError, match="keyframe_guidance_param"):
        main(["--keyframe_guidance_param", "2.0", "--output_dir", str(tmp_path)], device="cpu")


def test_bad_edit_mode_exits_as_jax_does(tmp_path):
    from condmdi_tpu_torch.sampling.edit import main

    with pytest.raises(SystemExit, match="edit_mode"):
        main(["--edit_mode", "sideways", "--output_dir", str(tmp_path)], device="cpu")


# the JAX recipe's shrink flags, per CLI
TINY = {
    "conditional": ["--arch", "unet", "--dim_mults", "1", "2", "--latent_dim", "16",
                    "--edit_mode", "benchmark_sparse", "--transition_length", "10"],
    "edit": ["--latent_dim", "16", "--ff_size", "32", "--layers", "1",
             "--edit_mode", "benchmark_clip", "--transition_length", "10"],
    "synthesize": ["--latent_dim", "16", "--ff_size", "32", "--layers", "1",
                   "--motion_length", "1.4"],
}


@pytest.mark.parametrize("cli", ["conditional", "edit", "synthesize"])
def test_cli_samples_in_float32_without_tf32(cli, tmp_path, monkeypatch):
    """PyTorch lets cuDNN's float32 convolutions use TF32 by default; each CLI
    turns that off while it runs, so it computes what its float32 checks on the
    card hold, and restores both flags after."""
    import importlib

    from condmdi_tpu_torch.sampling import pipeline as tpipe

    seen = []
    sample = tpipe.SamplePipeline.sample

    def recording(self, shape, y, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return sample(self, shape, y, **kw)

    monkeypatch.setattr(tpipe.SamplePipeline, "sample", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    main = importlib.import_module(f"condmdi_tpu_torch.sampling.{cli}").main
    np.random.seed(0)
    main(TINY[cli] + ["--diffusion_steps", "4", "--num_frames", "28", "--num_samples", "1",
                      "--num_repetitions", "1", "--abs_3d", "true", "--text_encoder", "hash",
                      "--output_dir", str(tmp_path)], device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
