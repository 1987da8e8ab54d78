"""Host-side quaternion helpers (numpy, xyzw convention); the port's copy
of `mobileposer_tpu/stream/quat_np.py`, the same code.

The sensor path runs on the host at ~25-30 Hz per device; its math is tiny
and latency-bound, so it stays in numpy (no device round-trips). Quaternions
here use the sensor wire convention xyzw (scipy order) — unlike the model
library (kinematics/rotation.py) which uses wxyz.

Replaces the reference's scipy.spatial.transform escapes
(utils/sensor_utils.py:1,57-61,115-119) with closed-form numpy.
"""

from __future__ import annotations

import numpy as np


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """[..., 4] xyzw (not necessarily normalized) -> [..., 3, 3]."""
    q = np.asarray(q, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (w * y + x * z)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> [..., 4] xyzw with w >= 0 (branchless Shepperd)."""
    m = np.asarray(m, np.float64)
    t = np.stack([
        1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
        1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
        1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
        1 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]], -1)
    t = np.sqrt(np.maximum(t, 1e-12))
    qx = np.stack([0.5 * t[..., 0],
                   (m[..., 0, 1] + m[..., 1, 0]) / (2 * t[..., 0]),
                   (m[..., 0, 2] + m[..., 2, 0]) / (2 * t[..., 0]),
                   (m[..., 2, 1] - m[..., 1, 2]) / (2 * t[..., 0])], -1)
    qy = np.stack([(m[..., 0, 1] + m[..., 1, 0]) / (2 * t[..., 1]),
                   0.5 * t[..., 1],
                   (m[..., 1, 2] + m[..., 2, 1]) / (2 * t[..., 1]),
                   (m[..., 0, 2] - m[..., 2, 0]) / (2 * t[..., 1])], -1)
    qz = np.stack([(m[..., 0, 2] + m[..., 2, 0]) / (2 * t[..., 2]),
                   (m[..., 1, 2] + m[..., 2, 1]) / (2 * t[..., 2]),
                   0.5 * t[..., 2],
                   (m[..., 1, 0] - m[..., 0, 1]) / (2 * t[..., 2])], -1)
    qw = np.stack([(m[..., 2, 1] - m[..., 1, 2]) / (2 * t[..., 3]),
                   (m[..., 0, 2] - m[..., 2, 0]) / (2 * t[..., 3]),
                   (m[..., 1, 0] - m[..., 0, 1]) / (2 * t[..., 3]),
                   0.5 * t[..., 3]], -1)
    # pick the candidate with the largest pivot
    idx = np.argmax(t, axis=-1)
    q = np.select([idx[..., None] == 0, idx[..., None] == 1,
                   idx[..., None] == 2], [qx, qy, qz], qw)
    q = np.where(q[..., 3:4] < 0, -q, q)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_mean(quats: np.ndarray) -> np.ndarray:
    """Chordal-L2 mean rotation (Markley's eigenvector method) of [N, 4]
    xyzw quaternions. Matches scipy Rotation.mean semantics
    (reference: sensor_utils.py:57-61)."""
    q = np.asarray(quats, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    M = q.T @ q
    _, vecs = np.linalg.eigh(M)
    mean = vecs[:, -1]
    if mean[3] < 0:
        mean = -mean
    return mean


def euler_xyz_from_quat(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> extrinsic xyz euler angles (scipy 'xyz')."""
    m = quat_to_matrix(q)
    # scipy extrinsic xyz == intrinsic ZYX reading
    sy = np.clip(-m[..., 2, 0], -1.0, 1.0)
    y = np.arcsin(sy)
    x = np.arctan2(m[..., 2, 1], m[..., 2, 2])
    z = np.arctan2(m[..., 1, 0], m[..., 0, 0])
    return np.stack([x, y, z], -1)


def quat_from_euler_xyz(e: np.ndarray) -> np.ndarray:
    """Extrinsic xyz euler -> xyzw quaternion."""
    e = np.asarray(e, np.float64)
    hx, hy, hz = e[..., 0] / 2, e[..., 1] / 2, e[..., 2] / 2
    cx, sx = np.cos(hx), np.sin(hx)
    cy, sy = np.cos(hy), np.sin(hy)
    cz, sz = np.cos(hz), np.sin(hz)
    # R = Rz @ Ry @ Rx  (extrinsic xyz)
    w = cz * cy * cx + sz * sy * sx
    x = cz * cy * sx - sz * sy * cx
    y = cz * sy * cx + sz * cy * sx
    z = sz * cy * cx - cz * sy * sx
    q = np.stack([x, y, z, w], -1)
    return np.where(q[..., 3:4] < 0, -q, q)
