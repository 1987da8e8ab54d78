"""Datasets: processed-file loading, the train fold's batches and the
combo-masked evaluation views."""

from mobileposer_tpu_torch.data.dataset import (  # noqa: F401
    COMBO_MASKS,
    COMBO_NAMES,
    EvalSequence,
    PoseDataset,
    load_processed_file,
    make_combo_imu,
)
