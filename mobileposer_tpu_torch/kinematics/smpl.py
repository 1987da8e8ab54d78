"""SMPL body model (counterpart of `mobileposer_tpu/kinematics/smpl.py`).

The streaming path reads the zero-pose joints (foot anchors and floor
height) and the kinematic tree (the IK parent map); the evaluation and the
dataset also run forward kinematics and linear blend skinning. The body's
arrays stay host-side numpy, as in the JAX package; each device gets its
own tensor copy once.

Only the deterministic synthetic body is built here. Loading the official
SMPL `.pkl` file, and with it shape parameters and pose blend shapes, is
a later slice (ROADMAP.md queue A item 12).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from mobileposer_tpu_torch.kinematics import spatial as S
from mobileposer_tpu_torch.precision import f32_matmuls

_SMPL_ROW = "the official SMPL .pkl loader, ROADMAP.md queue A item 12"

# Standard SMPL kinematic tree (public model constant).
SMPL_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21)

NUM_JOINTS = 24
NUM_VERTICES = 6890  # reference: constants.py:33


def synthetic_smpl_arrays(num_vertices: int = NUM_VERTICES, seed: int = 0) -> dict:
    """Deterministic SMPL-shaped fixture, bit-identical to the JAX
    package's: the same numpy `RandomState` draws in the same order.

    Joints form a plausible T-pose skeleton (feet 10/11 lowest, as the
    floor logic of reference net.py:49 expects); vertices cluster around
    their dominant joint with soft skinning to the parent.
    """
    if num_vertices < NUM_JOINTS:
        raise ValueError(f"synthetic body needs >= {NUM_JOINTS} vertices "
                         f"(one per joint for the regressor), got "
                         f"{num_vertices}")
    rng = np.random.RandomState(seed)
    # Rough T-pose joint positions (y-up, meters): pelvis at origin.
    J = np.array([
        [0.00, 0.00, 0.00],    # 0 pelvis
        [0.08, -0.08, 0.00],   # 1 L hip
        [-0.08, -0.08, 0.00],  # 2 R hip
        [0.00, 0.10, 0.00],    # 3 spine1
        [0.10, -0.50, 0.00],   # 4 L knee
        [-0.10, -0.50, 0.00],  # 5 R knee
        [0.00, 0.22, 0.00],    # 6 spine2
        [0.09, -0.90, -0.02],  # 7 L ankle
        [-0.09, -0.90, -0.02], # 8 R ankle
        [0.00, 0.32, 0.00],    # 9 spine3
        [0.10, -0.95, 0.10],   # 10 L foot
        [-0.10, -0.95, 0.10],  # 11 R foot
        [0.00, 0.50, 0.00],    # 12 neck
        [0.08, 0.42, 0.00],    # 13 L collar
        [-0.08, 0.42, 0.00],   # 14 R collar
        [0.00, 0.60, 0.02],    # 15 head
        [0.17, 0.44, 0.00],    # 16 L shoulder
        [-0.17, 0.44, 0.00],   # 17 R shoulder
        [0.42, 0.44, 0.00],    # 18 L elbow
        [-0.42, 0.44, 0.00],   # 19 R elbow
        [0.67, 0.44, 0.00],    # 20 L wrist
        [-0.67, 0.44, 0.00],   # 21 R wrist
        [0.75, 0.44, 0.00],    # 22 L hand
        [-0.75, 0.44, 0.00],   # 23 R hand
    ], dtype=np.float32)

    # Assign vertices round-robin to joints, offset by small noise.
    owner = np.arange(num_vertices) % NUM_JOINTS
    v_template = J[owner] + rng.uniform(-0.05, 0.05, (num_vertices, 3)).astype(np.float32)

    # Skinning: 0.8 to owner joint, 0.2 to its parent (root: all to root).
    weights = np.zeros((num_vertices, NUM_JOINTS), np.float32)
    weights[np.arange(num_vertices), owner] = 0.8
    parent_of_owner = np.array([max(SMPL_PARENTS[j], 0) for j in owner])
    weights[np.arange(num_vertices), parent_of_owner] += 0.2

    # J_regressor: average of the vertices owned by each joint.
    J_regressor = np.zeros((NUM_JOINTS, num_vertices), np.float32)
    for j in range(NUM_JOINTS):
        idx = np.nonzero(owner == j)[0]
        J_regressor[j, idx] = 1.0 / len(idx)
    # Re-derive J so that J == J_regressor @ v_template exactly.
    J = (J_regressor @ v_template).astype(np.float32)

    shapedirs = rng.uniform(-0.01, 0.01, (num_vertices, 3, 10)).astype(np.float32)
    posedirs = np.zeros((num_vertices, 3, 23 * 9), np.float32)
    faces = np.stack([np.arange(num_vertices - 2),
                      np.arange(1, num_vertices - 1),
                      np.arange(2, num_vertices)], axis=1).astype(np.int32)
    return dict(J_regressor=J_regressor, weights=weights, posedirs=posedirs,
                shapedirs=shapedirs, v_template=v_template, J=J, f=faces,
                parents=SMPL_PARENTS)


class ParametricModel:
    """SMPL body model (reference: model.py:16). Holds the rest-pose
    joints `_J` [24, 3], the vertex template, the skinning weights, the
    joint regressor, the shape and pose blend-shape bases and the
    canonical parent tuple as host numpy."""

    def __init__(self, model_data: dict, use_pose_blendshape: bool = False):
        if use_pose_blendshape:
            raise NotImplementedError(
                f"pose blend shapes are not ported ({_SMPL_ROW})")
        self._J_regressor = np.asarray(model_data["J_regressor"], np.float32)
        self._skinning_weights = np.asarray(model_data["weights"], np.float32)
        self._posedirs = np.asarray(model_data["posedirs"], np.float32)
        self._shapedirs = np.asarray(model_data["shapedirs"], np.float32)
        self._v_template = np.asarray(model_data["v_template"], np.float32)
        self._J = np.asarray(model_data["J"], np.float32)
        self.parent = S._canon_parent(model_data["parents"])

    @classmethod
    def synthetic(cls, num_vertices: int = NUM_VERTICES,
                  seed: int = 0) -> "ParametricModel":
        return cls(synthetic_smpl_arrays(num_vertices, seed))

    @classmethod
    def from_file_or_synthetic(cls, model_file) -> "ParametricModel":
        """The deterministic synthetic body when `model_file` is absent.
        The JAX package loads the official file when it exists; the port
        cannot yet, so it raises rather than score another body."""
        if model_file is not None and os.path.exists(str(model_file)):
            raise NotImplementedError(
                f"{model_file} exists, but loading it is not ported "
                f"({_SMPL_ROW})")
        return cls.synthetic()

    def get_zero_pose_joint_and_vertex(self):
        """Zero-pose joints/vertices with the root at the origin
        (reference: model.py:77-92, the `shape=None` case)."""
        j = self._J - self._J[:1]
        v = self._v_template - self._J[:1]
        return j, v

    def _device_arrays(self, device: torch.device):
        """(zero-pose joints [24,3], vertices [V,3], bone vectors [1,24,3],
        skinning weights [V,24]) as float32 tensors on `device`, built
        once per device."""
        cache = self.__dict__.setdefault("_tensors", {})
        if device not in cache:
            j, v = (torch.as_tensor(a, device=device)
                    for a in self.get_zero_pose_joint_and_vertex())
            cache[device] = (j, v,
                             S.joint_position_to_bone_vector(j[None],
                                                             self.parent),
                             torch.as_tensor(self._skinning_weights,
                                             device=device))
        return cache[device]

    @f32_matmuls
    def forward_kinematics(self, pose: torch.Tensor,
                           shape: Optional[torch.Tensor] = None,
                           tran: Optional[torch.Tensor] = None,
                           calc_mesh: bool = False):
        """Global rotations, joint positions and, with calc_mesh, the
        linear-blend-skinned mesh vertices (reference: model.py:208-240),
        in full float32.

        pose [N, 24, 3, 3] local rotations, tran [N, 3] or None. Returns
        (pose_global [N,24,3,3], joints [N,24,3]) and, with calc_mesh,
        vertices [N,V,3].
        """
        if shape is not None:
            raise NotImplementedError(
                f"shape parameters are not ported ({_SMPL_ROW})")
        pose = pose.reshape(pose.shape[0], -1, 3, 3)
        n = pose.shape[0]
        j, v, bone, W = self._device_arrays(pose.device)
        pose_global, joint_global = S.forward_kinematics(
            pose, bone.expand(n, -1, -1), self.parent)

        def add_tran(x):
            return x if tran is None else x + tran.reshape(-1, 1, 3)

        if not calc_mesh:
            return pose_global, add_tran(joint_global)

        # LBS with the rotation and translation blended separately, as the
        # JAX package does (no [N,V,4,4]): the per-joint translation has
        # the zero-pose joint taken off, p_adj = p_global - R_global @ j
        # (reference: model.py:234); then R_v = sum_j w[v,j] R_global[n,j]
        # and t_v = sum_j w[v,j] p_adj[n,j].
        p_adj = joint_global - (pose_global @ j[..., None])[..., 0]
        R_v = torch.einsum("vj,njab->nvab", W, pose_global)
        t_v = torch.einsum("vj,njc->nvc", W, p_adj)
        vertex_global = (R_v @ v[..., None])[..., 0] + t_v
        return pose_global, add_tran(joint_global), add_tran(vertex_global)
