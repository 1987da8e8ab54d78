"""Model layer: the four estimation modules + the MobilePoserNet composite."""

from mobileposer_tpu_torch.models.modules import (  # noqa: F401
    MODULE_CONFIGS,
    init_all_modules,
    module_apply,
)
from mobileposer_tpu_torch.models.modules import (  # noqa: F401
    footcontact_loss,
    joints_loss,
    poser_loss,
    velocity_loss,
)
from mobileposer_tpu_torch.models.net import (  # noqa: F401
    MobilePoserNet,
    OnlineState,
    forward,
    joint_positions_from_r6d_soa,
    prob_to_weight,
    reduced_global_to_full_soa,
)
