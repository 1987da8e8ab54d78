"""Evaluation datasets: processed-file loading and combo-masked views."""

from mobileposer_tpu_torch.data.dataset import (  # noqa: F401
    COMBO_MASKS,
    COMBO_NAMES,
    EvalSequence,
    PoseDataset,
    load_processed_file,
)
