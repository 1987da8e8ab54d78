"""Evaluation layer: full-motion metric suite + pose-eval protocol."""

from mobileposer_tpu_torch.evaluation.evaluator import (  # noqa: F401
    FullMotionEvaluator,
    binary_classification_errors,
    binary_confusion_matrix,
)
from mobileposer_tpu_torch.evaluation.pose_eval import (  # noqa: F401
    METRIC_NAMES,
    PoseEvaluator,
    evaluate_pose,
    forward_offline_batched,
    translation_drift,
)
