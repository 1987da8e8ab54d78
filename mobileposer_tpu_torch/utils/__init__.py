"""Cross-cutting utilities: precision control, IO, profiling, env flags,
evaluation helpers, experiment-metric sinks (`utils.metrics`)."""

from mobileposer_tpu_torch.precision import f32_matmuls  # noqa: F401
from mobileposer_tpu_torch.utils.helpers import getenv_flag  # noqa: F401
from mobileposer_tpu_torch.utils.io import (  # noqa: F401
    get_datestring,
    load_txt_mat,
    make_dir,
    save_txt_mat,
)
from mobileposer_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    device_memory_stats,
    trace,
)
from mobileposer_tpu_torch.utils.testing import (  # noqa: F401
    evaluate_next_batch,
    evaluate_over_dataset,
)
