"""Rotation math on tensors (counterpart of `mobileposer_tpu/kinematics/rotation.py`).

The JAX module's whole surface, with its names and argument order. Shapes
are batched over leading dimensions, as in the JAX package; quaternions
are wxyz, euler angles follow scipy's convention (uppercase seq
intrinsic, lowercase extrinsic). `generate_random_rotation_matrix` takes
a `torch.Generator` where the JAX function takes a key. The
rotation-matrix log map is the JAX package's branchless quaternion route,
copied exactly (its
`safe_sqrt` clamp included): another log map, such as `acos` of the
trace, differs near 0 and pi and would move the angle metrics.
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch

from mobileposer_tpu_torch.precision import f32_matmuls

_EPS = 1e-8


class RotationRepresentation(enum.Enum):
    AXIS_ANGLE = 0
    ROTATION_MATRIX = 1
    QUATERNION = 2
    R6D = 3
    EULER_ANGLE = 4


def lerp(a, b, t):
    """Unclamped linear interpolation (reference: general.py:15-24)."""
    return a * (1 - t) + b * t


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True):
    """Norm with the squared value clamped to _EPS**2 before the sqrt, so
    a zero vector normalizes to zero instead of NaN."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, _EPS * _EPS))


def normalize_tensor(x: torch.Tensor, dim: int = -1,
                     return_norm: bool = False):
    """Normalize to unit norm along `dim` (reference: general.py:27-39);
    zero vectors map to zero vectors. With return_norm, (x / |x|, |x|)."""
    norm = _safe_norm(x, dim=dim)
    return (x / norm, norm) if return_norm else x / norm


def radian_to_degree(q):
    return q * (180.0 / math.pi)


def degree_to_radian(q):
    return q * (math.pi / 180.0)


def normalize_angle(q):
    """Normalize radians into [-pi, pi) (reference: angular.py:67-76)."""
    mod = torch.remainder(q, 2 * math.pi)
    return torch.where(mod >= math.pi, mod - 2 * math.pi, mod)


def angle_difference(target, source):
    return normalize_angle(target - source)


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


def axis_angle_to_quaternion(a: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion wxyz (reference: angular.py:211-221)."""
    a = a.reshape(-1, 3)
    angle = _safe_norm(a)
    axis = a / angle
    return torch.cat((torch.cos(angle / 2), torch.sin(angle / 2) * axis), -1)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(Unnormalized) quaternion wxyz -> rotation matrix
    (angular.py:224-236)."""
    q = normalize_tensor(q.reshape(-1, 4))
    a, b, c, d = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = torch.stack(
        (1 - 2 * (c * c + d * d), 2 * (b * c - a * d), 2 * (a * c + b * d),
         2 * (b * c + a * d), 1 - 2 * (b * b + d * d), 2 * (c * d - a * b),
         2 * (b * d - a * c), 2 * (a * b + c * d), 1 - 2 * (b * b + c * c)),
        dim=1)
    return r.reshape(-1, 3, 3)


def rotation_matrix_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    """Closed-form log map [N,3,3] -> [N,3], angle in [0, pi], through the
    quaternion (the JAX package's route, robust at angle ~ 0 and ~ pi)."""
    return quaternion_to_axis_angle(rotation_matrix_to_quaternion(r))


def rotation_matrix_to_r6d(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D: first two columns (reference: angular.py:185-192)."""
    r = r.reshape(-1, 3, 3)
    return r[:, :, :2].transpose(1, 2).reshape(-1, 6)


@f32_matmuls
def angle_between(rot1: torch.Tensor, rot2: torch.Tensor,
                  rep: RotationRepresentation =
                  RotationRepresentation.ROTATION_MATRIX) -> torch.Tensor:
    """Angle in radians between two batches of rotations in
    representation `rep` (reference: angular.py:86-99), in full
    float32."""
    r1, r2 = to_rotation_matrix(rot1, rep), to_rotation_matrix(rot2, rep)
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


# ---------------------------------------------------------------------------
# Euler angles (scipy convention: uppercase intrinsic, lowercase extrinsic)
# ---------------------------------------------------------------------------

_AXIS2IDX = {"x": 0, "y": 1, "z": 2}


def _elementary_rotation(axis: int, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(angle), torch.ones_like(angle)
    if axis == 0:
        rows = (ones, zeros, zeros, zeros, c, -s, zeros, s, c)
    elif axis == 1:
        rows = (c, zeros, s, zeros, ones, zeros, -s, zeros, c)
    else:
        rows = (c, -s, zeros, s, c, zeros, zeros, zeros, ones)
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


@f32_matmuls
def euler_angle_to_rotation_matrix(q: torch.Tensor,
                                   seq: str = "XYZ") -> torch.Tensor:
    """Euler angles [N, 3] -> rotation matrices (reference:
    angular.py:255-268). Intrinsic (uppercase): R = R_{s0}(a0) @ R_{s1}(a1)
    @ R_{s2}(a2); extrinsic (lowercase): R = R_{s2}(a2) @ R_{s1}(a1) @
    R_{s0}(a0)."""
    q = q.reshape(-1, 3)
    axes = [_AXIS2IDX[ch.lower()] for ch in seq]
    mats = [_elementary_rotation(axes[i], q[:, i]) for i in range(3)]
    if seq.isupper():
        return mats[0] @ mats[1] @ mats[2]
    if seq.islower():
        return mats[2] @ mats[1] @ mats[0]
    raise ValueError(f"mixed intrinsic/extrinsic seq not supported: {seq}")


def _levi_civita(i: int, j: int, k: int) -> int:
    return 1 if (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1


def rotation_matrix_to_euler_angle(r: torch.Tensor,
                                   seq: str = "XYZ") -> torch.Tensor:
    """Rotation matrices -> euler angles [N, 3] (reference:
    angular.py:239-252), all 12 sequences: Tait-Bryan (three distinct
    axes, second angle in [-pi/2, pi/2]) and proper Euler (first axis
    repeated, second angle in [0, pi]), intrinsic or extrinsic. At gimbal
    lock the third angle absorbs the ambiguity, as in the JAX package."""
    r = r.reshape(-1, 3, 3)
    if seq.islower():
        return rotation_matrix_to_euler_angle(r, seq[::-1].upper()).flip(1)
    if not seq.isupper():
        raise ValueError(f"mixed intrinsic/extrinsic seq not supported: {seq}")
    i, j, k = (_AXIS2IDX[ch.lower()] for ch in seq)
    if len({i, j, k}) == 3:                       # Tait-Bryan
        eps = _levi_civita(i, j, k)
        b = torch.arcsin(torch.clamp(eps * r[:, i, k], -1.0, 1.0))
        a = torch.atan2(-eps * r[:, j, k], r[:, k, k])
        c = torch.atan2(-eps * r[:, i, j], r[:, i, i])
        return torch.stack((a, b, c), dim=-1)
    if i == k and i != j:                         # proper Euler (i-j-i)
        # R = R_i(a) R_j(b) R_i(c); with m the axis absent from the
        # sequence and eps = levi_civita(i, j, m): R[i,i] = cos b,
        # R[j,i] = sin a sin b, R[m,i] = -eps cos a sin b,
        # R[i,j] = sin b sin c, R[i,m] = eps sin b cos c
        m = 3 - i - j
        eps = _levi_civita(i, j, m)
        b = torch.arccos(torch.clamp(r[:, i, i], -1.0, 1.0))
        a = torch.atan2(r[:, j, i], -eps * r[:, m, i])
        c = torch.atan2(r[:, i, j], eps * r[:, i, m])
        return torch.stack((a, b, c), dim=-1)
    raise ValueError(f"invalid euler sequence (adjacent repeated axis): "
                     f"{seq}")


# ---------------------------------------------------------------------------
# Conversions, point-set alignment, random rotations
# ---------------------------------------------------------------------------

def to_rotation_matrix(r: torch.Tensor,
                       rep: RotationRepresentation) -> torch.Tensor:
    """Any representation -> [N, 3, 3] (reference: angular.py:31-50)."""
    if rep == RotationRepresentation.AXIS_ANGLE:
        return axis_angle_to_rotation_matrix(r)
    if rep == RotationRepresentation.QUATERNION:
        return quaternion_to_rotation_matrix(r)
    if rep == RotationRepresentation.R6D:
        return r6d_to_rotation_matrix(r)
    if rep == RotationRepresentation.EULER_ANGLE:
        return euler_angle_to_rotation_matrix(r)
    if rep == RotationRepresentation.ROTATION_MATRIX:
        return r.reshape(-1, 3, 3)
    raise ValueError("unknown rotation representation")


@f32_matmuls
def svd_rotate(source_points: torch.Tensor,
               target_points: torch.Tensor) -> torch.Tensor:
    """The rotation that best maps source onto target point sets
    [.., N, 3] (Kabsch; angular.py:102-118), reflections corrected by
    flipping the last column of V."""
    m = source_points.transpose(-1, -2) @ target_points
    u, _, vt = torch.linalg.svd(m)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    flip = torch.ones_like(v[..., 0, :])
    flip[..., 2] = torch.where(det < 0, -1.0, 1.0)
    return (v * flip[..., None, :]) @ u.transpose(-1, -2)


def generate_random_rotation_matrix(generator: Optional[torch.Generator]
                                    = None, n: int = 1) -> torch.Tensor:
    """n uniform random rotations [n, 3, 3] from normalized Gaussian
    quaternions (angular.py:121-136), drawn from `generator` on its
    device (the JAX function takes a key)."""
    device = generator.device if generator is not None else None
    q = torch.randn((n, 4), generator=generator, device=device)
    return quaternion_to_rotation_matrix(q)
