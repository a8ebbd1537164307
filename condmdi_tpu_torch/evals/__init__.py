"""The evaluation protocols on the port: metrics, the T2M co-embedding evaluator,
the harness, and the CLIs `evals.run` (CondMDI keyframe protocol),
`evals.run_t2m` (legacy text-to-motion protocol) and `evals.run_condition`
(GMD two-stage protocol).

Counterpart of condmdi_tpu/evals/ for metrics.py, evaluator.py, common.py,
harness.py, run.py, run_t2m.py, run_condition.py and train_evaluator.py. The
other protocols (run_a2m, unconstrained) and the parity checks are not ported
yet (ROADMAP Queue A 8). Importing the package touches no device.
"""
