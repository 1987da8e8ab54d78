"""Rotation math on tensors (counterpart of `mobileposer_tpu/kinematics/rotation.py`).

Only what the streaming path needs. Shapes are batched over leading
dimensions, as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def lerp(a, b, t):
    """Unclamped linear interpolation (reference: general.py:15-24)."""
    return a * (1 - t) + b * t


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True):
    """Norm with the squared value clamped to _EPS**2 before the sqrt, so
    a zero vector normalizes to zero instead of NaN."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, _EPS * _EPS))


def r6d_to_rotation_matrix(r6d: torch.Tensor) -> torch.Tensor:
    """6D -> rotation matrix by Gram-Schmidt (reference: angular.py:167-182).

    The 6D vector holds the first two *columns* of the matrix.
    """
    r6d = r6d.reshape(-1, 6)
    col0 = r6d[:, 0:3] / _safe_norm(r6d[:, 0:3])
    col1 = r6d[:, 3:6] - torch.sum(col0 * r6d[:, 3:6], dim=1,
                                   keepdim=True) * col0
    col1 = col1 / _safe_norm(col1)
    col2 = torch.linalg.cross(col0, col1, dim=1)
    return torch.stack((col0, col1, col2), dim=-1)
