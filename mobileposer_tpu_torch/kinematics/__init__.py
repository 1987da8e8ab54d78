"""Body model and rotation math for the streaming path."""

from mobileposer_tpu_torch.kinematics.smpl import (  # noqa: F401
    SMPL_PARENTS,
    ParametricModel,
    synthetic_smpl_arrays,
)
