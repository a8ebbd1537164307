"""The evaluation protocols on the port: metrics, the T2M co-embedding evaluator,
the harness, and the CLIs `evals.run` (CondMDI keyframe protocol) and
`evals.run_t2m` (legacy text-to-motion protocol).

Counterpart of condmdi_tpu/evals/ for metrics.py, evaluator.py, common.py,
harness.py, run.py, run_t2m.py and the parameter IO of train_evaluator.py.
The other protocols (run_condition, run_a2m, unconstrained), the parity
checks and the evaluator's trainer are not ported yet (ROADMAP Queue A 5 and
A 8). Importing the package touches no device.
"""
