"""Rotation math on tensors (counterpart of `mobileposer_tpu/kinematics/rotation.py`).

What the streaming path and the evaluation need. Shapes are batched over
leading dimensions, as in the JAX package. The rotation-matrix log map is
the JAX package's branchless quaternion route, copied exactly (its
`safe_sqrt` clamp included): another log map, such as `acos` of the
trace, differs near 0 and pi and would move the angle metrics.
"""

from __future__ import annotations

import math

import torch

from mobileposer_tpu_torch.precision import f32_matmuls

_EPS = 1e-8


def lerp(a, b, t):
    """Unclamped linear interpolation (reference: general.py:15-24)."""
    return a * (1 - t) + b * t


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True):
    """Norm with the squared value clamped to _EPS**2 before the sqrt, so
    a zero vector normalizes to zero instead of NaN."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, _EPS * _EPS))


def normalize_tensor(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize to unit norm along `dim` (reference: general.py:27-39);
    zero vectors map to zero vectors."""
    return x / _safe_norm(x, dim=dim)


def radian_to_degree(q):
    return q * (180.0 / math.pi)


def vector_cross_matrix(x: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric [v]x for each vector3 (reference: general.py:63-74)."""
    x = x.reshape(-1, 3)
    zeros = torch.zeros_like(x[:, 0])
    return torch.stack(
        (zeros, -x[:, 2], x[:, 1],
         x[:, 2], zeros, -x[:, 0],
         -x[:, 1], x[:, 0], zeros), dim=1).reshape(-1, 3, 3)


def axis_angle_to_rotation_matrix(a: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula (reference: angular.py:139-151). [N,3] -> [N,3,3]."""
    a = a.reshape(-1, 3)
    angle = _safe_norm(a)
    axis = a / angle
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape[0], 3, 3)
    outer = axis[:, :, None] * axis[:, None, :]
    return c * eye + (1 - c) * outer + s * vector_cross_matrix(axis)


def rotation_matrix_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion wxyz with w >= 0. Branchless Shepperd:
    the candidate with the largest pivot is picked, so the conversion is
    stable for every rotation, angle ~ pi included."""
    r = r.reshape(-1, 3, 3)
    m00, m01, m02 = r[:, 0, 0], r[:, 0, 1], r[:, 0, 2]
    m10, m11, m12 = r[:, 1, 0], r[:, 1, 1], r[:, 1, 2]
    m20, m21, m22 = r[:, 2, 0], r[:, 2, 1], r[:, 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS))

    s_w = safe_sqrt(1.0 + tr)                  # 2w when tr dominant
    q_w = torch.stack((0.5 * s_w, (m21 - m12) / (2 * s_w),
                       (m02 - m20) / (2 * s_w), (m10 - m01) / (2 * s_w)), -1)
    s_x = safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack(((m21 - m12) / (2 * s_x), 0.5 * s_x,
                       (m01 + m10) / (2 * s_x), (m02 + m20) / (2 * s_x)), -1)
    s_y = safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack(((m02 - m20) / (2 * s_y), (m01 + m10) / (2 * s_y),
                       0.5 * s_y, (m12 + m21) / (2 * s_y)), -1)
    s_z = safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack(((m10 - m01) / (2 * s_z), (m02 + m20) / (2 * s_z),
                       (m12 + m21) / (2 * s_z), 0.5 * s_z), -1)

    cond_tr = tr > 0.0
    cond_x = (m00 >= m11) & (m00 >= m22)
    cond_y = m11 >= m22
    q = torch.where(cond_tr[:, None], q_w,
                    torch.where(cond_x[:, None], q_x,
                                torch.where(cond_y[:, None], q_y, q_z)))
    # canonicalize to w >= 0 so axis-angle lands in [0, pi]
    q = torch.where(q[:, :1] < 0, -q, q)
    return normalize_tensor(q)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion wxyz -> axis-angle (reference: angular.py:195-208)."""
    q = normalize_tensor(q.reshape(-1, 4))
    theta_half = torch.arccos(torch.clamp(q[:, :1], -1.0, 1.0))
    sin_half = torch.sin(theta_half)
    scale = torch.where(
        torch.abs(sin_half) < _EPS,
        torch.full_like(sin_half, 2.0),   # small-angle limit: a ~= 2*xyz
        2.0 * theta_half / torch.clamp_min(torch.abs(sin_half), _EPS)
        * torch.sign(sin_half))
    return q[:, 1:] * scale


def rotation_matrix_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    """Closed-form log map [N,3,3] -> [N,3], angle in [0, pi], through the
    quaternion (the JAX package's route, robust at angle ~ 0 and ~ pi)."""
    return quaternion_to_axis_angle(rotation_matrix_to_quaternion(r))


def rotation_matrix_to_r6d(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D: first two columns (reference: angular.py:185-192)."""
    r = r.reshape(-1, 3, 3)
    return r[:, :, :2].transpose(1, 2).reshape(-1, 6)


@f32_matmuls
def angle_between(rot1: torch.Tensor, rot2: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two batches of rotation matrices
    (reference: angular.py:86-99), in full float32."""
    r1, r2 = rot1.reshape(-1, 3, 3), rot2.reshape(-1, 3, 3)
    offsets = r1.transpose(-1, -2) @ r2
    return torch.linalg.vector_norm(rotation_matrix_to_axis_angle(offsets),
                                    dim=-1)


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
