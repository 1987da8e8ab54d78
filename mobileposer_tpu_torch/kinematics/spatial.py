"""SE(3) helpers and articulated-tree kinematics (counterpart of
`mobileposer_tpu/kinematics/spatial.py`).

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


def _parent_index(parent: Tuple[int, ...], device) -> torch.Tensor:
    """The root-clamped parent of each joint as an index tensor."""
    return torch.tensor([0 if p < 0 else p for p in parent], device=device)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def transformation_matrix(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Homogeneous T [*, 4, 4] from R [*, 3, 3] and p [*, 3]
    (spatial.py:60-75)."""
    Rp = torch.cat((R, p[..., None]), dim=-1)
    bottom = torch.zeros(Rp.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat((Rp, bottom), dim=-2)


def decode_transformation_matrix(T: torch.Tensor):
    """Split T [*, 4, 4] into (R [*, 3, 3], p [*, 3]) (spatial.py:78-87)."""
    return T[..., :3, :3], T[..., :3, 3]


@f32_matmuls
def inverse_transformation_matrix(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (spatial.py:90-101)."""
    R, p = decode_transformation_matrix(T)
    invR = R.transpose(-1, -2)
    return transformation_matrix(invR, -(invR @ p[..., None])[..., 0])


# ---------------------------------------------------------------------------
# Tree reductions, level by level
# ---------------------------------------------------------------------------

def _forward_tree_matmul(x_local: torch.Tensor,
                         parent: Tuple[int, ...]) -> torch.Tensor:
    """x_global[i] = x_global[parent[i]] @ x_local[i], one batched product
    per tree level. x_local [..., J, d, d]."""
    x_global = x_local.clone()
    for level in _tree_levels(parent)[1:]:
        idx = torch.tensor(level, device=x_local.device)
        par = torch.tensor([parent[i] for i in level], device=x_local.device)
        x_global[..., idx, :, :] = (x_global.index_select(-3, par)
                                    @ x_local.index_select(-3, idx))
    return x_global


def _forward_tree_add(x_local: torch.Tensor,
                      parent: Tuple[int, ...]) -> torch.Tensor:
    """x_global[i] = x_global[parent[i]] + x_local[i] for vectors
    [..., J, 3], one batched add per tree level."""
    x_global = x_local.clone()
    for level in _tree_levels(parent)[1:]:
        idx = torch.tensor(level, device=x_local.device)
        par = torch.tensor([parent[i] for i in level], device=x_local.device)
        x_global[..., idx, :] = (x_global.index_select(-2, par)
                                 + x_local.index_select(-2, idx))
    return x_global


@f32_matmuls
def bone_vector_to_joint_position(bone_vec: torch.Tensor,
                                  parent: Sequence) -> torch.Tensor:
    """Accumulate bone vectors [N, J, 3] (or [N, J*3]) into joint
    positions (spatial.py:126-145)."""
    parent = _canon_parent(parent)
    bone_vec = bone_vec.reshape(bone_vec.shape[0], -1, 3)
    return _forward_tree_add(bone_vec, parent)


def joint_position_to_bone_vector(joint_pos: torch.Tensor,
                                  parent: Sequence) -> torch.Tensor:
    """bone[i] = pos[i] - pos[parent[i]]; the root keeps its position
    (spatial.py:148-167). joint_pos [N, J, 3] (or [N, J*3])."""
    parent = _canon_parent(parent)
    joint_pos = joint_pos.reshape(joint_pos.shape[0], -1, 3)
    parent_pos = joint_pos.index_select(
        -2, _parent_index(parent, joint_pos.device)).clone()
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


@f32_matmuls
def forward_kinematics_R(R_local: torch.Tensor,
                         parent: Sequence) -> torch.Tensor:
    """Global joint rotations [N, J, 3, 3] from local ones
    (spatial.py:170-194)."""
    parent = _canon_parent(parent)
    R_local = R_local.reshape(R_local.shape[0], -1, 3, 3)
    return _forward_tree_matmul(R_local, parent)


@f32_matmuls
def inverse_kinematics_R(R_global: torch.Tensor,
                         parent: Sequence) -> torch.Tensor:
    """Local rotations from global ones, one batched product
    (spatial.py:197-221): R_local[i] = R_global[parent[i]]^T @
    R_global[i]; the root keeps its global rotation."""
    parent = _canon_parent(parent)
    R_global = R_global.reshape(R_global.shape[0], -1, 3, 3)
    par = _parent_index(parent, R_global.device)
    R_local = R_global.index_select(-3, par).transpose(-1, -2) @ R_global
    R_local[..., 0, :, :] = R_global[..., 0, :, :]
    return R_local


@f32_matmuls
def forward_kinematics_T(T_local: torch.Tensor,
                         parent: Sequence) -> torch.Tensor:
    """Global homogeneous transforms [N, J, 4, 4] from local ones
    (spatial.py:224-249)."""
    parent = _canon_parent(parent)
    T_local = T_local.reshape(T_local.shape[0], -1, 4, 4)
    return _forward_tree_matmul(T_local, parent)


@f32_matmuls
def inverse_kinematics_T(T_global: torch.Tensor,
                         parent: Sequence) -> torch.Tensor:
    """Local homogeneous transforms from global ones, one batched product
    (spatial.py:252-277); the root keeps its global transform."""
    parent = _canon_parent(parent)
    T_global = T_global.reshape(T_global.shape[0], -1, 4, 4)
    par = _parent_index(parent, T_global.device)
    T_local = (inverse_transformation_matrix(T_global.index_select(-3, par))
               @ T_global)
    T_local[..., 0, :, :] = T_global[..., 0, :, :]
    return T_local


@f32_matmuls
def joint_positions_from_global(R_global: torch.Tensor, bone_vec,
                                parent: Sequence) -> torch.Tensor:
    """Joint positions straight from GLOBAL rotations:
    p[i] = p[parent[i]] + R_global[parent[i]] @ bone[i], the rotations one
    batched product, then the level-by-level prefix add; the root keeps
    its unrotated offset. R_global [..., J, 3, 3]; bone_vec [J, 3] or
    [..., J, 3] (a tensor or an array)."""
    parent = _canon_parent(parent)
    par = _parent_index(parent, R_global.device)
    bone = torch.as_tensor(bone_vec, dtype=R_global.dtype,
                           device=R_global.device).expand(
                               R_global.shape[:-2] + (3,))
    rotated = (R_global.index_select(-3, par) @ bone[..., None])[..., 0]
    rotated[..., 0, :] = bone[..., 0, :]
    return _forward_tree_add(rotated, parent)
