"""The port's `evals.run_t2m` (the legacy text-only protocol) against the JAX
package's, end to end on the CPU.

Both `main`s on a small Flax-initialised MDM at tests/test_eval_cli.py's sizes
(latent 16, one layer, 4 diffusion steps, CFG 2.5), from the same x_T, DDIM
eta 0, one batch of 32, 2 of debug mode's 5 replications (--max_replications
in the port; the JAX CLI ignores it, so its mode table is cut), the synthetic
test split's features from one codec, the committed synthetic evaluator and
the hash text/word encoders (tests/torch_eval_helpers.py). Tolerances as tests/test_torch_eval_cli.py
states them for the float leg (measured here: the reports' metrics within
2.3e-6, FID 2.3e-6 at 324.0; motions_rel 7.2e-7 mean-relative, none beyond
1e-3·(1 + |jax|)).
"""

import pytest

from torch_eval_helpers import (COMMON, TINY_MDM, assert_batches_match, assert_reports_match,
                                few_torch_threads,  # noqa: F401  (autouse)
                                run_both)

REPLICATIONS = 2


@pytest.fixture(scope="module")
def run_t2m(tmp_path_factory):
    import condmdi_tpu.evals.run_t2m as jax_t2m
    from condmdi_tpu_torch.evals.run_t2m import main as port_main

    argv = COMMON + TINY_MDM + ["--guidance_param", "2.5", "--model_path", "",
                                "--max_replications", str(REPLICATIONS)]
    with pytest.MonkeyPatch.context() as mp:
        # the JAX CLI ignores --max_replications: its debug mode is cut in its table
        mp.setitem(jax_t2m.EVAL_MODES, "debug",
                   {**jax_t2m.EVAL_MODES["debug"], "replication_times": REPLICATIONS})
        return run_both(jax_t2m.main, port_main, argv, argv, tmp_path_factory.mktemp("t2m"), mp)


def test_generated_batches_match_jax(run_t2m):
    seen = run_t2m[-1]
    assert len(seen["port"]) == REPLICATIONS  # one batch in each replication
    assert_batches_match(seen)


def test_report_metrics_match_jax(run_t2m):
    assert_reports_match(run_t2m)


def test_text_protocol_reports_no_keyframe_metrics(run_t2m):
    summary, (name, report) = run_t2m[1], run_t2m[3]
    assert not {"traj_error", "keyframe_error"} & set(summary)
    assert len(summary["r_precision"]["mean"]) == 3
    assert name == "eval_humanml_debug.json"
    assert report["meta"]["replications"] == REPLICATIONS
    assert report["meta"]["protocol"].startswith("eval_humanml")
