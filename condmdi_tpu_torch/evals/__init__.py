"""The evaluation protocols on the port: metrics, the T2M co-embedding evaluator,
the harness, the recognition models (the a2m GRU, ST-GCN) and the CLIs
`evals.run` (CondMDI keyframe protocol), `evals.run_t2m` (legacy
text-to-motion protocol), `evals.run_condition` (GMD two-stage protocol),
`evals.run_a2m` (action-to-motion on HumanAct12 / UESTC) and
`evals.run_unconstrained` (unconditioned generation: FID, KID,
precision/recall), and `evals.parity`, the paper-parity run of `evals.run` on
a released checkpoint against the paper's numbers.

Counterpart of condmdi_tpu/evals/ for metrics.py, evaluator.py, common.py,
harness.py, a2m.py, stgcn.py, unconstrained.py, run.py, run_t2m.py,
run_condition.py, run_a2m.py, run_unconstrained.py, train_evaluator.py and
parity.py.
Importing the package touches no device.
"""

from condmdi_tpu_torch.evals import run_a2m, run_unconstrained
from condmdi_tpu_torch.evals.metrics import (
    euclidean_distance_matrix,
    calculate_top_k,
    calculate_R_precision,
    calculate_matching_score,
    calculate_activation_statistics,
    calculate_diversity,
    calculate_multimodality,
    calculate_frechet_distance,
    calculate_keyframe_error,
    calculate_trajectory_error,
    calculate_trajectory_diversity,
    calculate_skating_ratio,
    get_metric_statistics,
)
from condmdi_tpu_torch.evals.evaluator import EvaluatorWrapper
from condmdi_tpu_torch.evals.harness import (
    EvalConfig,
    compute_kps_error,
    evaluation,
    generate_eval_batch,
)
from condmdi_tpu_torch.evals.a2m import A2MClassifier, STGCNClassifier, evaluate_a2m
from condmdi_tpu_torch.evals.unconstrained import (
    calculate_kid,
    evaluate_unconstrained,
    precision_and_recall,
)

__all__ = ["run_a2m", "run_unconstrained", "euclidean_distance_matrix", "calculate_top_k",
           "calculate_R_precision", "calculate_matching_score", "calculate_activation_statistics",
           "calculate_diversity", "calculate_multimodality", "calculate_frechet_distance",
           "calculate_keyframe_error", "calculate_trajectory_error",
           "calculate_trajectory_diversity", "calculate_skating_ratio", "get_metric_statistics",
           "EvaluatorWrapper", "EvalConfig", "compute_kps_error", "evaluation",
           "generate_eval_batch", "A2MClassifier", "STGCNClassifier", "evaluate_a2m",
           "calculate_kid", "evaluate_unconstrained", "precision_and_recall"]
