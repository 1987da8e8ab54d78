"""Model-level utilities (counterpart of `mobileposer_tpu/models/utils.py`;
reference `mobileposer/utils/model_utils.py`)."""

from __future__ import annotations

import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS

_REDUCED = tuple(C.joint_set.reduced)


def load_model(path) -> dict:
    """Weights as the params tree (JAX layout, numpy leaves) from either
    the JAX package's combined .npz or the reference's torch checkpoint
    (reference: model_utils.py:6-15); `nn.convert.params_from_jax` makes
    the port's modules from it."""
    path = str(path)
    if path.endswith(".npz"):
        from mobileposer_tpu_torch.nn.convert import load_npz
        return load_npz(path)
    from mobileposer_tpu_torch.nn.torch_convert import \
        convert_mobileposer_checkpoint
    return convert_mobileposer_checkpoint(path, MODULE_CONFIGS)


def reduced_pose_to_full(reduced_pose: torch.Tensor) -> torch.Tensor:
    """[B, S, n_reduced*9] reduced rotation matrices -> [B, S, 24*9] with
    the identity at the joints not in the reduced set (reference:
    model_utils.py:18-25)."""
    B, S = reduced_pose.shape[0], reduced_pose.shape[1]
    reduced = reduced_pose.reshape(B, S, C.joint_set.n_reduced, 3, 3)
    full = torch.eye(3, dtype=reduced.dtype, device=reduced.device).expand(
        B, S, 24, 3, 3).clone()
    full[:, :, list(_REDUCED)] = reduced
    return full.reshape(B, S, -1)


def smooth_avg(acc: torch.Tensor, s: int = 3) -> torch.Tensor:
    """Centered moving average over time whose window shrinks at the ends
    (the nanmean-window semantics of reference model_utils.py:28-37), from
    a cumulative sum: frame t averages [t - s//2, t + s//2], clipped to
    the sequence. acc [T, ...]; returns the same shape."""
    T = acc.shape[0]
    half = s // 2
    cum = torch.cumsum(torch.cat([torch.zeros_like(acc[:1]), acc]), dim=0)
    idx = torch.arange(T, device=acc.device)
    lo = torch.clamp(idx - half, 0, T)
    hi = torch.clamp(idx + half + 1, 0, T)
    count = (hi - lo).reshape((T,) + (1,) * (acc.dim() - 1)).to(acc.dtype)
    return (cum[hi] - cum[lo]) / count


def normalize_and_concat(glb_acc: torch.Tensor,
                         glb_ori: torch.Tensor) -> torch.Tensor:
    """6-IMU root-relative normalization (reference: model_utils.py:40-46):
    the 5 body IMUs' acceleration relative to the root IMU's, rotated into
    the root frame and scaled by 1 / acc_scale; their orientations
    relative to the root's. glb_acc [N, 6, 3], glb_ori [N, 6, 3, 3] ->
    [N, 72]."""
    glb_acc = glb_acc.reshape(-1, 6, 3)
    glb_ori = glb_ori.reshape(-1, 6, 3, 3)
    root_ori = glb_ori[:, 5]                                    # [N, 3, 3]
    acc = torch.cat([glb_acc[:, :5] - glb_acc[:, 5:], glb_acc[:, 5:]], 1)
    acc = (acc @ root_ori) / C.amass.acc_scale                  # [N, 6, 3]
    rel = root_ori.transpose(1, 2)[:, None] @ glb_ori[:, :5]
    ori = torch.cat([rel, glb_ori[:, 5:]], dim=1)               # [N, 6, 3, 3]
    n = glb_acc.shape[0]
    return torch.cat([acc.reshape(n, -1), ori.reshape(n, -1)], dim=1)
