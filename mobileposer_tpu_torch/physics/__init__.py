"""Physics layer (counterpart of `mobileposer_tpu/physics/`): the
refinement hook (the reference's PHYSICS path, made functional), full
rigid-body dynamics (the reference's RBDL-wrapper surface) and
live-reloaded debug parameters."""

from mobileposer_tpu_torch.physics.debug_params import DebugParams  # noqa: F401
from mobileposer_tpu_torch.physics.dynamics import (  # noqa: F401
    BodyParams,
    DynamicsModel,
)
from mobileposer_tpu_torch.physics.optimizer import (  # noqa: F401
    PhysicsOptimizer,
    PhysicsState,
    physics_enabled,
)
