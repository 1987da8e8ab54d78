"""Virtual-IMU synthesis (counterpart of `mobileposer_tpu/data/synthesis.py`;
reference `mobileposer/process.py`).

The whole-sequence math of the reference's per-frame loops
(`_syn_acc`, process.py:23-35; `_foot_ground_probs`, process.py:38-46) as
batched tensor ops on the port's FK and skinning, and the raw datasets'
frame alignment and cleanup that `data/process.py` applies (AMASS and
IMUPoser to the DIP frame, the DIP NaN fill, TotalCapture's accelerometer
bias). Every op takes tensors on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.kinematics import rotation as R

TARGET_FPS = C.datasets.fps  # 30

# Fixed global-frame alignment AMASS -> DIP (reference: process.py:92).
AMASS_ROT = np.array([[1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0],
                      [0.0, -1.0, 0.0]])

# IMUPoser global-frame alignment (reference: process.py:320).
IMUPOSER_ROT = np.array([[-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0],
                         [0.0, 1.0, 0.0]])

VI_MASK = np.asarray(C.VI_MASK)
JI_MASK = np.asarray(C.JI_MASK)


def tracked_vertex_indices(num_vertices: int) -> np.ndarray:
    """The 6 tracked mesh vertices (process.py:18). The official indices
    assume the 6890-vertex SMPL mesh; for smaller fixture bodies they wrap
    deterministically so tests run without the official file."""
    if num_vertices > int(VI_MASK.max()):
        return VI_MASK
    return VI_MASK % num_vertices


def synthesize_acceleration(vert: torch.Tensor, smooth_n: int = 4,
                            fps: int = TARGET_FPS) -> torch.Tensor:
    """Virtual accelerometer from vertex positions (process.py:23-35).

    vert: [T, M, 3] tracked-vertex trajectories. Central 2nd difference
    x fps^2; interior frames use the smoothed wide stencil (stride
    `smooth_n`, scaled 1/smooth_n^2); two frames of zeros at each boundary
    exactly as the reference produces.
    """
    T = vert.shape[0]
    scale = float(fps) ** 2
    zero = torch.zeros_like(vert[:1])
    acc = (vert[:-2] + vert[2:] - 2 * vert[1:-1]) * scale     # [T-2, M, 3]
    acc = torch.cat([zero, acc, zero])
    mid = smooth_n // 2
    if mid != 0 and T > smooth_n * 2:
        smoothed = (vert[:-2 * smooth_n] + vert[2 * smooth_n:]
                    - 2 * vert[smooth_n:-smooth_n]) * scale / smooth_n ** 2
        acc = torch.cat([acc[:smooth_n], smoothed, acc[-smooth_n:]])
    return acc


def foot_ground_probs(joint: torch.Tensor,
                      threshold: float = 0.008) -> torch.Tensor:
    """Binary foot-ground contact from foot displacement (process.py:38-46).

    joint: [T, 24, 3] -> [T, 2] float {0,1}; frame 0 is no-contact.
    """
    disp_l = torch.linalg.norm(joint[1:, 10] - joint[:-1, 10], dim=1)
    disp_r = torch.linalg.norm(joint[1:, 11] - joint[:-1, 11], dim=1)
    contact = torch.stack([disp_l < threshold, disp_r < threshold], dim=1)
    return torch.cat([torch.zeros((1, 2), dtype=torch.bool,
                                  device=joint.device), contact]).float()


def synthesize_virtual_imu(body_model, pose_rot: torch.Tensor,
                           shape: Optional[torch.Tensor] = None,
                           tran: Optional[torch.Tensor] = None,
                           smooth_n: int = 4):
    """Full virtual-IMU synthesis for one sequence (process.py:102-121).

    pose_rot: [T, 24, 3, 3] local rotations. Returns a dict with joint
    [T,24,3], vacc [T,6,3], vrot [T,6,3,3] and contact [T,2].
    """
    grot, joint, vert = body_model.forward_kinematics(
        pose_rot, shape=shape, tran=tran, calc_mesh=True)
    vi = torch.as_tensor(tracked_vertex_indices(vert.shape[1]),
                         device=vert.device)
    ji = torch.as_tensor(JI_MASK, device=grot.device)
    return {
        "joint": joint,
        "vacc": synthesize_acceleration(vert.index_select(1, vi), smooth_n),
        "vrot": grot.index_select(1, ji),
        "contact": foot_ground_probs(joint),
    }


def _rot(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def align_amass_to_dip(pose_aa: torch.Tensor, tran: torch.Tensor):
    """Rotate the AMASS world frame into the DIP convention
    (process.py:92-95).

    pose_aa: [T, 24, 3] axis-angle (root in channel 0); tran: [T, 3].
    The root goes axis-angle -> matrix -> AMASS_ROT @ matrix -> axis-angle
    (the log map's angle in [0, pi]).
    """
    rot = _rot(AMASS_ROT, tran)
    tran = (rot @ tran[..., None])[..., 0]
    root = R.axis_angle_to_rotation_matrix(pose_aa[:, 0])
    root = R.rotation_matrix_to_axis_angle(rot @ root)
    pose_aa = torch.cat([root[:, None], pose_aa[:, 1:]], dim=1)
    return pose_aa, tran


def align_imuposer_to_dip(pose_rot: torch.Tensor, tran: torch.Tensor):
    """IMUPoser frame alignment (process.py:320-323).

    pose_rot: [T, 24, 3, 3]; tran: [T, 3].
    """
    rot = _rot(IMUPOSER_ROT, tran)
    pose_rot = torch.cat([(rot @ pose_rot[:, 0])[:, None], pose_rot[:, 1:]],
                         dim=1)
    return pose_rot, tran @ rot


def nan_fill_nearest(x: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Fill NaNs from temporal neighbours (DIP cleanup, process.py:253-258).

    Each of `iters` passes copies the previous frame's value into NaN
    slots, then the next frame's value into the slots still NaN, as the
    reference's forward/backward masked_scatter loop does. A NaN run longer
    than the passes reach stays NaN.
    """
    for _ in range(iters):
        fwd = torch.cat([x[:1], x[:-1]])
        x = torch.where(torch.isnan(x), fwd, x)
        bwd = torch.cat([x[1:], x[-1:]])
        x = torch.where(torch.isnan(x), bwd, x)
    return x


def downsample_step(framerate: float, target_fps: int = TARGET_FPS) -> int:
    """Integer decimation step (process.py:70-72)."""
    return max(1, round(framerate / target_fps))


def remove_acceleration_bias(real_acc: torch.Tensor,
                             virtual_acc: torch.Tensor) -> torch.Tensor:
    """Shift each (imu, axis) channel of the real accelerometer so that its
    mean matches the synthetic acceleration's (TotalCapture,
    process.py:207-214)."""
    d = virtual_acc.mean(dim=0) - real_acc.mean(dim=0)
    return real_acc + d
