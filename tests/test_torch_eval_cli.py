"""The port's evaluation CLIs against the JAX package's, end to end on the CPU.

`evals.run` on a small Flax-initialised keyframe UNet, in float and in
`--precision_mode int8_static --int8_float_last_k 2` (the float twin for model
timesteps below 2: two of the four steps), each through `main` in both
frameworks at tests/test_eval_cli.py's sizes,
from the same x_T, DDIM eta 0 over 4 respaced steps, one batch of 32, the
synthetic test split (its features from the port's codec, handed to both),
the committed synthetic evaluator and the hash text/word encoders; the int8
leg's calibration draws JAX's noise (tests/torch_eval_helpers.py). The two
run in one process, so the JAX package compiles its evaluator once;
`evals.run_t2m` is held the same way in tests/test_torch_eval_t2m.py.

Tolerances, measured on these runs:
  * float, the generated batches (`generate_eval_batch`): the samples
    agree to float32 rounding, but the abs→rel conversion (inverse kinematics on
    the random model's far-flung joints; foot contacts that are thresholds)
    spreads that unevenly over motions_rel, so it is held as
    tests/test_torch_quant.py holds a module: mean |diff| / mean |jax| <= 1e-4
    (measured 6.6e-6), at most 1e-3 of the elements beyond 1e-3·(1 + |jax|)
    (measured 1.5e-4) and none beyond 1e-2·(1 + |jax|) (measured 7.5e-3 at
    most); lengths, captions and keyframe counts equal; the per-sample keyframe
    and trajectory errors and skate ratios within METRIC_TOL (measured 7.9e-6);
  * float, every metric of the report (summary and per_replication) within
    METRIC_TOL = 1e-4·(1 + |jax|), set in tests/torch_eval_helpers.py (measured:
    FID 1.0e-4 at 153.9, matching score 7.6e-6, diversity 7.6e-6; R-precision
    and skating ratio equal);
  * int8: a forward is defined only to within its quantization noise. The two
    frameworks' float32 arithmetic differs by ~1e-7 before each quantizer, that
    flips the odd activation code, and every flip is an error of a whole code
    step that the layers after it carry on: one int8 forward of
    save/synthetic_unet_s at B=32 from identical weights, scales and inputs
    differs by 5e-6 mean-relative at the first flipped layer and by 3% at the
    output (measured layer by layer). The trajectory calibration (dynamic int8)
    is chaotic the same way, more so on this random UNet: its inputs are held to
    JAX's (the same shape, text, guidance and mask, the observations within
    OBS_ATOL = 1e-4, measured 2.6e-5) and its amaxes within AMAX_RTOL = 25% of
    JAX's (measured 7.4%; tests/test_torch_quant.py holds the calibration alone,
    on its own UNet, at 5e-2). The port then samples on JAX's amaxes, and the
    report is held at the remaining noise, each bound about 3× what this run
    measured: matching score within 2% (measured 0.6%), FID within 5% (0.9%),
    diversity within 5% (1.7%), keyframe error and the trajectory's mean
    keyframe error within 1.5% (0.4%); R-precision, skating ratio and the
    trajectory failure rates within 3 of the 32 samples (measured at most 1);
  * the reports' names and keys are JAX's, their meta holds every key of JAX's
    meta.
Also here: the plain int8_static leg's report on the port, and the refusals
(no CUDA, --int8_float_last_k without an int8 mode to mix, an unconditioned
model without --allow_unconditioned).
"""

import json

import numpy as np
import pytest
import torch

import jax

from torch_eval_helpers import (COMMON, KEYFRAMES, TINY_UNET, assert_batches_match,
                                assert_reports_match, few_torch_threads,  # noqa: F401  (autouse)
                                inject_jax_calibration_noise, metric_gaps, run_both)

AMAX_RTOL = 0.25
OBS_ATOL = 1e-4
INT8 = ["--precision_mode", "int8_static", "--int8_float_last_k", "2"]
SEED = 10  # EvalArgs' default --seed


@pytest.fixture(scope="module")
def run_float(tmp_path_factory):
    from condmdi_tpu.evals.run import main as jax_main
    from condmdi_tpu_torch.evals.run import main as port_main

    argv = COMMON + KEYFRAMES + TINY_UNET + ["--max_replications", "1", "--model_path", ""]
    with pytest.MonkeyPatch.context() as mp:
        return run_both(jax_main, port_main, argv, argv, tmp_path_factory.mktemp("run"), mp)


@pytest.fixture(scope="module")
def run_int8(run_float, tmp_path_factory):
    """The int8 leg, after the float one (the JAX package's compiles are shared).
    Both calibrations' inputs and amaxes are recorded; the port then samples on
    JAX's amaxes, so the two int8 samplers differ only by the codes their float32
    rounding flips. Returns (JAX summary, port summary, JAX report, port report,
    calibration record)."""
    import condmdi_tpu.ops.quant as jq
    import condmdi_tpu_torch.ops.quant as tq
    from condmdi_tpu.evals.run import main as jax_main
    from condmdi_tpu_torch.evals.run import main as port_main
    from condmdi_tpu_torch.weights import load_flax_params

    argv = COMMON + KEYFRAMES + TINY_UNET + ["--max_replications", "1", "--model_path", ""] + INT8
    cal = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_cal = jq.calibrate_act_scales_trajectory

        def jax_recorded(model, params, sched, dcfg, shape, y, **kw):
            out = jax_cal(model, params, sched, dcfg, shape, y, **kw)
            cal["jax_amax"] = {k: v for k, v in load_flax_params(jax.tree_util.tree_map(
                np.asarray, {"act_scale": out["act_scale"]})).items()}
            cal["jax_inputs"] = dict(shape=tuple(shape), text=np.asarray(y["text_embed"]),
                                     guidance=kw["guidance_param"], obs=np.asarray(kw["obs_x0"]),
                                     mask=np.asarray(kw["obs_mask"]))
            return out

        mp.setattr(jq, "calibrate_act_scales_trajectory", jax_recorded)
        inject_jax_calibration_noise(mp, SEED)
        port_cal = tq.calibrate_act_scales_trajectory

        def port_recorded(model, sched, dcfg, shape, y, **kw):
            out = port_cal(model, sched, dcfg, shape, y, **kw)
            cal["port_amax"] = {k: v.clone() for k, v in model.state_dict().items()
                                if k.endswith(".amax")}
            cal["port_inputs"] = dict(shape=tuple(shape), text=y["text_embed"].numpy(),
                                      guidance=kw["guidance_param"], obs=kw["obs_x0"].numpy(),
                                      mask=kw["obs_mask"].numpy())
            model.load_state_dict(cal["jax_amax"], strict=False)  # sample on JAX's scales
            return out

        mp.setattr(tq, "calibrate_act_scales_trajectory", port_recorded)
        *out, _ = run_both(jax_main, port_main, argv, argv, tmp_path_factory.mktemp("int8"), mp)
    return (*out, cal)


def test_generated_batches_match_jax(run_float):
    assert_batches_match(run_float[-1])


def test_report_metrics_match_jax(run_float):
    assert_reports_match(run_float)


def test_keyframe_protocol_reports_keyframe_metrics(run_float):
    summary, (name, report) = run_float[1], run_float[3]
    assert {"traj_error", "keyframe_error"} <= set(summary)
    assert len(summary["traj_error"]["mean"]) == 5
    assert name == "eval_benchmark_sparse_debug.json"
    assert report["meta"]["params_fingerprint"] == ""  # no checkpoint
    # the keyframe mask's settings, which JAX's meta leaves out (KEYFRAMES' and defaults)
    assert {k: report["meta"][k] for k in ("transition_length", "n_keyframes",
                                           "editable_features")} == \
        dict(transition_length=10, n_keyframes=5, editable_features="pos_rot_vel")


@pytest.mark.parametrize("model_path, flag, want", [
    ("save/synthetic_unet_m/gate_ema_000100000.npz", "", "torch_eval_out/synthetic_unet_m"),
    ("", "", "torch_eval_out/eval_out"),
    ("save/synthetic_unet_m/gate_ema_000100000.npz", "elsewhere", "elsewhere"),
])
def test_default_report_directory_is_never_a_committed_one(model_path, flag, want):
    """Without --output_dir a report goes under torch_eval_out/ (git-ignored), never
    beside the checkpoint or into save/eval_out as JAX's does: those hold the JAX
    package's committed reports, under the same file names."""
    from types import SimpleNamespace

    from condmdi_tpu_torch.evals.common import output_dir

    from torch_cli_helpers import REPO

    got = output_dir(SimpleNamespace(model_path=model_path, output_dir=flag))
    assert got.as_posix() == want
    assert "/torch_eval_out/" in (REPO / ".gitignore").read_text().splitlines()


def test_protocol_script_runs_the_committed_reports_mask():
    """eval_protocol.py compares with the committed wo_mm reports, whose command passed
    no mask flag: its argv must give EvalArgs' defaults, and it refuses another mask."""
    import eval_protocol as ep

    from condmdi_tpu_torch.utils.config import EvalArgs, parse_args

    for extra, name in ep.LEGS.values():
        args = parse_args(EvalArgs, ep.COMMON + extra)
        meta = json.loads((ep.GATE / name).read_text())["meta"]
        ep.check_mask(name, {k: getattr(args, k) for k in ep.MASK_KEYS}, meta)
        assert args.transition_length == 30
        with pytest.raises(SystemExit, match="mask settings"):
            ep.check_mask(name, {**ep.COMMITTED_MASK, "transition_length": 10}, meta)


def test_int8_calibration_takes_jax_inputs_and_lands_near_its_amaxes(run_int8):
    cal = run_int8[-1]
    got, want = cal["port_inputs"], cal["jax_inputs"]
    assert got["shape"] == want["shape"] and got["guidance"] == want["guidance"]
    np.testing.assert_array_equal(got["text"], want["text"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"].any()
    np.testing.assert_allclose(got["obs"], want["obs"], rtol=0, atol=OBS_ATOL)
    assert set(cal["port_amax"]) == set(cal["jax_amax"]) and len(cal["jax_amax"]) > 10
    for key, want_amax in cal["jax_amax"].items():
        want_amax = float(want_amax)
        assert want_amax > 0
        assert abs(float(cal["port_amax"][key]) - want_amax) <= AMAX_RTOL * want_amax, key


def _within(got, want, rtol=0.0, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= atol + rtol * np.abs(want)), (got, want)


def test_int8_report_metrics_match_jax_within_quantization_noise(run_int8):
    jax_sum, port_sum, (jname, jrep), (pname, prep), _ = run_int8
    assert pname == jname == "eval_benchmark_sparse_debug_int8_static_f2.json"
    assert set(port_sum) == set(jax_sum) and set(prep) == set(jrep)
    assert set(jrep["meta"]) <= set(prep["meta"])
    for key in ("precision_mode", "int8_float_last_k", "num_samples", "replications"):
        assert prep["meta"][key] == jrep["meta"][key], key
    mean = {k: (port_sum[k]["mean"], jax_sum[k]["mean"]) for k in metric_gaps(jax_sum, port_sum)}
    _within(*mean["matching_score"], rtol=0.02)
    _within(*mean["fid"], rtol=0.05)
    _within(*mean["diversity"], rtol=0.05)
    _within(*mean["keyframe_error"], rtol=0.015)
    _within(*mean["r_precision"], atol=3 / 32)
    _within(*mean["skating_ratio"], atol=3 / 32)
    traj_t, traj_j = mean["traj_error"]
    _within(traj_t[:4], traj_j[:4], atol=3 / 32)
    _within(traj_t[4], traj_j[4], rtol=0.015)


def test_int8_static_alone_reports_on_the_port(run_int8, tmp_path):
    """The leg without the float tail: calibrated, int8_static for every step,
    its own report name; no float twin is built."""
    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.evals.run import main

    argv = COMMON + KEYFRAMES + TINY_UNET + ["--max_replications", "1", "--model_path", "",
                                             "--precision_mode", "int8_static",
                                             "--output_dir", str(tmp_path)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet_mod, "float_twin", lambda *a: pytest.fail("a float twin was built"))
        summary = main(argv, device="cpu")
    rep = json.loads((tmp_path / "eval_benchmark_sparse_debug_int8_static.json").read_text())
    assert rep["meta"]["precision_mode"] == "int8_static" and rep["meta"]["int8_float_last_k"] == 0
    assert np.isfinite(summary["fid"]["mean"]) and summary["diversity"]["mean"] > 0
    # within quantization noise of the float-tail leg's port report (same x_T, half the steps int8)
    _within(summary["keyframe_error"]["mean"], run_int8[1]["keyframe_error"]["mean"], rtol=0.05)


@pytest.mark.parametrize("module", ["run", "run_t2m"])
def test_eval_cli_defaults_to_cuda_and_raises_without_it(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    import importlib

    main = importlib.import_module(f"condmdi_tpu_torch.evals.{module}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(COMMON + TINY_UNET + ["--output_dir", str(tmp_path)])


@pytest.mark.parametrize("pmode", ["float", "int8_prequant"])
def test_float_tail_without_an_int8_leg_is_refused_as_in_jax(pmode, tmp_path):
    from condmdi_tpu.evals.run import main as jax_main
    from condmdi_tpu_torch.evals.run import main as port_main

    argv = COMMON + TINY_UNET + ["--precision_mode", pmode, "--int8_float_last_k", "2",
                                 "--output_dir", str(tmp_path)]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        port_main(argv, device="cpu")
    assert str(got.value) == str(want.value) and "--int8_float_last_k" in str(got.value)
    assert not any(tmp_path.iterdir())


def test_unconditioned_model_is_refused_unless_allowed(tmp_path):
    from condmdi_tpu_torch.evals.run import main

    argv = COMMON + KEYFRAMES + TINY_UNET + ["--max_replications", "1", "--model_path", "",
                                             "--diffusion_steps", "2", "--timestep_respacing",
                                             "ddim2"]
    # a --model_path whose args.json says the model is not keyframe-conditioned
    ckpt = tmp_path / "uncond" / "model.npz"
    ckpt.parent.mkdir()
    (ckpt.parent / "args.json").write_text('{"keyframe_conditioned": false}')
    bad = argv + ["--model_path", str(ckpt), "--output_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="WITHOUT keyframe conditioning"):
        main(bad, device="cpu")
    summary = main(bad + ["--allow_unconditioned", "true"], device="cpu")
    assert np.isfinite(summary["fid"]["mean"])
    meta = json.loads((tmp_path / "out" / "eval_benchmark_sparse_debug.json").read_text())["meta"]
    assert meta["model_keyframe_conditioned"] is False
