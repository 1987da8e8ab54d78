"""Model and dataset constants the streaming path reads.

An own copy of the values in `mobileposer_tpu/config.py` (reference
`mobileposer/config.py`), kept as frozen dataclasses with the same names so
`C.joint_set.reduced` and friends read the same in both packages. Only the
constants this port uses are carried; the rest arrive with the modules
that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model dimensions (reference: config.py:40-54)."""
    n_joints: int = 5                 # head, R-wrist, L-wrist, R-hip, L-hip
    n_output_joints: int = 24
    past_frames: int = 40
    future_frames: int = 5

    @property
    def n_imu(self) -> int:
        return 12 * self.n_joints     # 60 = (3 accel + 9 orientation) * 5

    @property
    def total_frames(self) -> int:
        return self.past_frames + self.future_frames


@dataclasses.dataclass(frozen=True)
class Amass:
    """AMASS dataset constants (reference: config.py:57-83)."""
    vel_scale: float = 2.0


@dataclasses.dataclass(frozen=True)
class Datasets:
    """Dataset constants (reference: config.py:86-126)."""
    fps: int = 30


@dataclasses.dataclass(frozen=True)
class JointSet:
    """Joint subsets (reference: config.py:129-142)."""
    gravity_velocity: float = -0.018
    reduced: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 9, 12, 13, 14, 15, 16,
                                17, 18, 19)
    ignored: Tuple[int, ...] = (0, 7, 8, 10, 11, 20, 21, 22, 23)

    @property
    def n_reduced(self) -> int:
        return len(self.reduced)


model_config = ModelConfig()
amass = Amass()
datasets = Datasets()
joint_set = JointSet()
