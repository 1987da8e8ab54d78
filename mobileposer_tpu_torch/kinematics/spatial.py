"""Articulated-tree kinematics (counterpart of `mobileposer_tpu/kinematics/spatial.py`).

Conventions match the reference: parent[i] < i for i > 0; parent[0] is
None/-1; local = expressed in the parent frame; global = base frame. The
tree is walked level by level, as in the JAX package: joints at equal
depth are composed with one batched gather and matmul (9 steps for the
24-joint SMPL tree instead of 24).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch

from mobileposer_tpu_torch.precision import f32_matmuls


def _canon_parent(parent: Sequence) -> Tuple[int, ...]:
    """Normalize the parent list: root's parent becomes -1."""
    out = []
    for i, p in enumerate(parent):
        out.append(-1 if (i == 0 or p is None or p < 0) else int(p))
    return tuple(out)


@lru_cache(maxsize=None)
def _tree_levels(parent: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Group joint indices by tree depth. Level 0 is the root alone."""
    depth = [0] * len(parent)
    for i in range(1, len(parent)):
        depth[i] = depth[parent[i]] + 1
    levels = [[] for _ in range(max(depth) + 1)]
    for i, d in enumerate(depth):
        levels[d].append(i)
    return tuple(tuple(lv) for lv in levels)


def joint_position_to_bone_vector(joint_pos: torch.Tensor,
                                  parent: Sequence) -> torch.Tensor:
    """bone[i] = pos[i] - pos[parent[i]]; the root keeps its position
    (spatial.py:148-167). joint_pos [N, J, 3] (or [N, J*3])."""
    parent = _canon_parent(parent)
    joint_pos = joint_pos.reshape(joint_pos.shape[0], -1, 3)
    par = torch.tensor([0 if p < 0 else p for p in parent],
                       device=joint_pos.device)
    parent_pos = joint_pos.index_select(-2, par).clone()
    parent_pos[..., 0, :] = 0.0
    return joint_pos - parent_pos


@f32_matmuls
def forward_kinematics(R_local: torch.Tensor, p_local: torch.Tensor,
                       parent: Sequence):
    """Fused (R, p) tree FK (spatial.py:280-309) without 4x4 matmuls, in
    full float32:

        R_global[i] = R_global[par] @ R_local[i]
        p_global[i] = p_global[par] + R_global[par] @ p_local[i]

    R_local [N, J, 3, 3], p_local [N, J, 3] -> (R_global, p_global).
    """
    parent = _canon_parent(parent)
    R_local = R_local.reshape(R_local.shape[0], -1, 3, 3)
    p_local = p_local.reshape(p_local.shape[0], -1, 3)
    R_global, p_global = R_local.clone(), p_local.clone()
    for level in _tree_levels(parent)[1:]:
        idx = torch.tensor(level, device=R_local.device)
        par = torch.tensor([parent[i] for i in level], device=R_local.device)
        Rp = R_global.index_select(-3, par)
        pp = p_global.index_select(-2, par)
        R_global[..., idx, :, :] = Rp @ R_local.index_select(-3, idx)
        p_global[..., idx, :] = pp + (
            Rp @ p_local.index_select(-2, idx)[..., None])[..., 0]
    return R_global, p_global
