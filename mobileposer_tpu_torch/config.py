"""Model, dataset and path constants the port reads.

An own copy of the values in `mobileposer_tpu/config.py` (reference
`mobileposer/config.py`), kept as frozen dataclasses with the same names so
`C.joint_set.reduced` and friends read the same in both packages. Only the
constants this port uses are carried; the rest arrive with the modules
that read them.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Tuple


def _env_path(key: str, default: str) -> Path:
    return Path(os.environ.get(key, default))


@dataclasses.dataclass(frozen=True)
class Paths:
    """Filesystem layout (reference: config.py:26-38), with the JAX
    package's environment overrides: MP_ROOT (read once, when this module
    is imported), MP_SMPL_FILE and MP_PROCESSED (read at each access)."""
    root_dir: Path = dataclasses.field(
        default_factory=lambda: Path(os.environ.get("MP_ROOT", ".")).absolute())

    @property
    def smpl_file(self) -> Path:
        return _env_path("MP_SMPL_FILE",
                         str(self.root_dir / "smpl/basicmodel_m.pkl"))

    @property
    def processed_datasets(self) -> Path:
        return _env_path("MP_PROCESSED",
                         str(self.root_dir / "data/processed_datasets"))

    @property
    def eval_dir(self) -> Path:
        return self.processed_datasets / "eval"


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


# Device-location combinations (reference: config.py:60-73).
COMBOS: Dict[str, Tuple[int, ...]] = {
    "lw_rp_h": (0, 3, 4),
    "rw_rp_h": (1, 3, 4),
    "lw_lp_h": (0, 2, 4),
    "rw_lp_h": (1, 2, 4),
    "lw_lp": (0, 2),
    "lw_rp": (0, 3),
    "rw_lp": (1, 2),
    "rw_rp": (1, 3),
    "lp_h": (2, 4),
    "rp_h": (3, 4),
    "lp": (2,),
    "rp": (3,),
}


@dataclasses.dataclass(frozen=True)
class Amass:
    """AMASS dataset constants (reference: config.py:57-83)."""
    acc_scale: float = 30.0
    vel_scale: float = 2.0


@dataclasses.dataclass(frozen=True)
class Datasets:
    """Dataset constants (reference: config.py:86-126)."""
    fps: int = 30
    window_length: int = 125
    dip_test: str = "dip_test.pt"
    totalcapture: str = "totalcapture.pt"
    imuposer_test: str = "imuposer_test.pt"

    @property
    def test_datasets(self) -> Dict[str, str]:
        return {"dip": self.dip_test, "totalcapture": self.totalcapture,
                "imuposer": self.imuposer_test}


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


paths = Paths()
model_config = ModelConfig()
amass = Amass()
datasets = Datasets()
joint_set = JointSet()

# Evaluation joint mask for SIP-style errors (reference: evaluate.py:18).
EVAL_JOINT_MASK: Tuple[int, ...] = (2, 5, 16, 20)
