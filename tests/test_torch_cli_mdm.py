"""The port's `edit` and `synthesize` CLIs against the JAX package's, end to end
on the CPU, on small MDMs with no checkpoint: both draw Flax's initialisation
from --seed. Deterministic DDIM (eta 0) at a short respacing from the same
x_T; tolerances as in tests/test_torch_cli.py."""

import numpy as np

from torch_cli_helpers import SHORT_DDIM, compare, inject_xt, run_both

SMALL_MDM = ["--latent_dim", "32", "--ff_size", "64", "--layers", "2", "--num_frames", "28",
             "--num_samples", "2", "--num_repetitions", "1", "--abs_3d", "true",
             "--text_encoder", "hash"] + SHORT_DDIM


def test_edit_matches_jax(tmp_path, monkeypatch):
    from condmdi_tpu.sampling.edit import main as jax_main
    from condmdi_tpu_torch.sampling.edit import main as port_main

    inject_xt(monkeypatch)
    argv = SMALL_MDM + ["--edit_mode", "benchmark_clip", "--transition_length", "10",
                        "--imputate", "true"]
    j, t = run_both(jax_main, port_main, argv, argv, tmp_path)
    compare(j, t, ("inpainting_mask", "lengths", "text", "edit_mode", "text_encoder"),
             ("inpainted_motion",))
    m = t["inpainting_mask"]
    assert m.any()
    np.testing.assert_array_equal(t["motion"][m], t["inpainted_motion"][m])


def test_synthesize_matches_jax(tmp_path, monkeypatch):
    import condmdi_tpu.viz.plot as jplot
    import condmdi_tpu_torch.viz.plot as tplot
    from condmdi_tpu.sampling.synthesize import main as jax_main
    from condmdi_tpu_torch.sampling.synthesize import main as port_main

    def no_video(*_a, **_k):
        raise RuntimeError("video off in this test")

    monkeypatch.setattr(jplot, "save_stick_figure_video", no_video)
    monkeypatch.setattr(tplot, "save_stick_figure_video", no_video)
    inject_xt(monkeypatch)
    argv = SMALL_MDM + ["--text_prompt", "a person waves", "--motion_length", "1.4"]
    j, t = run_both(jax_main, port_main, argv, argv, tmp_path)
    compare(j, t, ("lengths", "text", "num_samples", "num_repetitions", "text_encoder"))
