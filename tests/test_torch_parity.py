"""evals.parity and the asset table on the port against the JAX package, on the CPU:

  * `compare` gives JAX's rows (within 15%, outside it, an unfilled template);
  * the committed `parity_expected.json` is the JAX package's;
  * `check_required_assets` and `python -m ...utils.assets --check` report as
    JAX's do (no download: --fetch is never run);
  * `main` on mock assets (chip_smoke.py's writers: GloVe over a few words, a
    T2M evaluator at its real widths, a HumanML3D tree of 36 clips and a
    released-layout model000750000.pt from a small random UNet with its
    args.json) against JAX's `main` on the same mocks: the same verdict
    (blocked_expected, the template being all nulls), the same rows and
    summary keys, finite measured values; without the assets both are blocked
    on the same groups. The .pt round-trips through the converter to the
    model's own weights, equal.
"""

import json

import numpy as np
import torch

from chip_smoke import (
    reference_unet_state_dict,
    write_mock_evaluator_assets,
    write_mock_humanml,
    write_reference_checkpoint,
)
from condmdi_tpu.evals import parity as jparity
from condmdi_tpu.utils import assets as jassets
from condmdi_tpu_torch.evals import parity as tparity
from condmdi_tpu_torch.utils import assets as tassets
from condmdi_tpu_torch.utils.checkpoint import convert_unet_state_dict
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

MODEL_ARGS = dict(arch="unet", latent_dim=16, dim_mults=[1, 2], diffusion_steps=4,
                  keyframe_conditioned=True, abs_3d=True, num_frames=32, unet_adagn=True,
                  unet_zero=False, unconstrained=True)


def test_compare_rows_equal_jax():
    summary = {"fid": {"mean": [0.25]}, "keyframe_error": {"mean": [0.10]},
               "r_precision": {"mean": [0.4, 0.6, 0.7]}}
    expected = {"fid": 0.26, "keyframe_error": None, "r_precision": [0.5, 0.7, 0.8],
                "diversity": 9.0, "_instructions": "x"}
    got, want = tparity.compare(summary, expected), jparity.compare(summary, expected)
    assert [r[0] for r in got] == [r[0] for r in want] == \
        ["fid", "keyframe_error", "r_precision", "diversity"]
    for g, w in zip(got, want):
        assert g[4] == w[4] and g[2] == w[2]
        np.testing.assert_allclose([x for x in g[1:4] if x is not None],
                                   [x for x in w[1:4] if x is not None], equal_nan=True)
    assert [r[4] for r in got][:3] == [True, None, False]


def test_template_and_asset_table_equal_jax(tmp_path, capsys):
    assert json.loads(tparity.EXPECTED_TEMPLATE.read_text()) == \
        json.loads(jparity.EXPECTED_TEMPLATE.read_text())
    assert tparity.DEFAULT_TOLERANCES == jparity.DEFAULT_TOLERANCES
    assert tparity.REQUIRED_ASSETS == jparity.REQUIRED_ASSETS
    assert tassets.check_assets(tmp_path) == jassets.check_assets(tmp_path)
    assert tassets._main(["--check", "--root", str(tmp_path)]) == 0
    port = capsys.readouterr().out
    assert jassets._main(["--check", "--root", str(tmp_path)]) == 0
    assert port == capsys.readouterr().out


def test_blocked_without_assets_as_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = tparity.main(["--output_dir", str(tmp_path / "o")], device="cpu")
    want = jparity.main(["--output_dir", str(tmp_path / "o")])
    assert got == want and got["status"] == "blocked"


def small_unet():
    from condmdi_tpu_torch.models.factory import create_model
    from condmdi_tpu_torch.models.flax_init import load_flax_init
    from condmdi_tpu_torch.utils.config import EvalArgs

    args = EvalArgs()
    for k, v in MODEL_ARGS.items():
        setattr(args, k, tuple(v) if isinstance(v, list) else v)
    model = create_model(args, "cpu")
    load_flax_init(model, 0)
    with torch.no_grad():  # signal in the zero-initialised output convs too
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return model


def test_reference_layout_round_trips():
    from condmdi_tpu_torch.weights import load_flax_params, to_flax_params

    model = small_unet()
    tree = convert_unet_state_dict(reference_unet_state_dict(to_flax_params(model.state_dict())),
                                   n_levels=2)
    back = load_flax_params(tree)
    own = model.state_dict()
    assert set(back) == set(own)
    for k in own:
        assert torch.equal(back[k], own[k]), k


def test_main_on_mocks_equals_jax(tmp_path, monkeypatch):
    write_mock_evaluator_assets(tmp_path)
    write_mock_humanml(tmp_path)
    write_reference_checkpoint(tmp_path / "save" / "condmdi_randomframes" / "model000750000.pt",
                               small_unet(), MODEL_ARGS)
    monkeypatch.chdir(tmp_path)
    argv = ["--eval_mode", "debug", "--num_samples", "32", "--max_replications", "1"]
    got = tparity.main(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    want = jparity.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert got["status"] == want["status"] == "blocked_expected"
    assert got["summary_keys"] == want["summary_keys"]
    assert [(r[0], r[2], r[3], r[4]) for r in got["rows"]] == \
        [(r[0], r[2], r[3], r[4]) for r in want["rows"]]
    assert all(np.isfinite(r[1]) for r in got["rows"])
    report = json.loads((tmp_path / "port" / "parity_report.json").read_text())
    assert report["status"] == "blocked_expected" and "fid" in report["summary_keys"]
    meta = json.loads((tmp_path / "port" / "eval_benchmark_sparse_debug.json").read_text())["meta"]
    assert meta["model_path"].endswith("model000750000.pt") and meta["params_fingerprint"]
    assert meta["synthetic_data"] is False and meta["evaluator"] == "checkpoint"
