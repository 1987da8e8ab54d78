"""Virtual-IMU synthesis (counterpart of the synthesis ops of
`mobileposer_tpu/data/synthesis.py`; reference `mobileposer/process.py`).

The whole-sequence math of the reference's per-frame loops
(`_syn_acc`, process.py:23-35; `_foot_ground_probs`, process.py:38-46) as
batched tensor ops on the port's FK and skinning, on any device. What the
synthetic training data needs is carried; the raw-dataset alignment and
cleanup helpers arrive with `data/process.py` (ROADMAP.md queue A item 23).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C

TARGET_FPS = C.datasets.fps  # 30

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
