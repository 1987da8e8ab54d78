"""SMPL body model (counterpart of `mobileposer_tpu/kinematics/smpl.py`).

The streaming path reads the zero-pose joints (foot anchors and floor
height) and the kinematic tree (the IK parent map); the evaluation and the
dataset also run forward kinematics and linear blend skinning. The body's
arrays stay host-side numpy, as in the JAX package; each device gets its
own tensor copy once.

The official SMPL `.pkl` file loads through `load_smpl_arrays`, without
chumpy; without the file the deterministic synthetic body stands in
(`ParametricModel.from_file_or_synthetic`). Forward kinematics takes
shape parameters, and the mesh takes pose blend shapes when the body is
built with `use_pose_blendshape=True`.
"""

from __future__ import annotations

import enum
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics import spatial as S
from mobileposer_tpu_torch.precision import f32_matmuls

# Standard SMPL kinematic tree (public model constant).
SMPL_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21)

NUM_JOINTS = 24
NUM_VERTICES = 6890  # reference: constants.py:33


class SMPLJoint(enum.IntEnum):
    """Named SMPL joint indices (reference: articulate/armature.py:35-64).
    L/R prefixes are left/right; aliases share an index, as in the
    reference's armature (SPINE is the root there too)."""
    ROOT = 0
    PELVIS = 0
    SPINE = 0
    LHIP = 1
    RHIP = 2
    SPINE1 = 3
    LKNEE = 4
    RKNEE = 5
    SPINE2 = 6
    LANKLE = 7
    RANKLE = 8
    SPINE3 = 9
    LFOOT = 10
    RFOOT = 11
    NECK = 12
    LCLAVICLE = 13
    RCLAVICLE = 14
    HEAD = 15
    LSHOULDER = 16
    RSHOULDER = 17
    LELBOW = 18
    RELBOW = 19
    LWRIST = 20
    RWRIST = 21
    LHAND = 22
    RHAND = 23


class _ChumpyShim:
    """Stand-in for the chumpy array classes inside official SMPL pickles.

    Some fields of the official model file are chumpy `Ch` objects.
    Unpickling restores an instance's state into its `__dict__`, so a
    plain class captures it; `_to_np` takes the numpy payload from its
    `x` attribute, where chumpy keeps it.
    """


class _SMPLUnpickler(pickle.Unpickler):
    """Resolves every class of the `chumpy` package to `_ChumpyShim`, so
    chumpy need not be installed and `sys.modules` is left alone."""

    def find_class(self, module, name):
        if module == "chumpy" or module.startswith("chumpy."):
            return _ChumpyShim
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):        # scipy sparse
        return np.asarray(x.toarray())
    if isinstance(x, _ChumpyShim):
        inner = x.__dict__.get("x")
        if inner is None:
            raise ValueError("cannot extract array from chumpy object "
                             f"(attrs: {list(x.__dict__)})")
        return _to_np(inner)
    return np.asarray(x)


def load_smpl_arrays(model_file: str) -> dict:
    """The official SMPL pickle as plain numpy arrays: the fields the
    reference reads (model.py:28-39), float32 (faces int32) and the
    parent tuple from the kinematic tree."""
    with open(model_file, "rb") as f:
        data = _SMPLUnpickler(f, encoding="latin1").load()
    return dict(
        J_regressor=_to_np(data["J_regressor"]).astype(np.float32),
        weights=_to_np(data["weights"]).astype(np.float32),
        posedirs=_to_np(data["posedirs"]).astype(np.float32),
        shapedirs=_to_np(data["shapedirs"]).astype(np.float32),
        v_template=_to_np(data["v_template"]).astype(np.float32),
        J=_to_np(data["J"]).astype(np.float32),
        f=_to_np(data["f"]).astype(np.int32),
        parents=tuple([-1] + [int(p) for p in
                              _to_np(data["kintree_table"])[0][1:].tolist()]),
    )


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


def _fk_dtype(x: torch.Tensor) -> torch.dtype:
    """The body's tensors' dtype for inputs `x`: float64 for float64,
    else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


class ParametricModel:
    """SMPL body model (reference: model.py:16). Holds the rest-pose
    joints `_J` [24, 3], the vertex template, the skinning weights, the
    joint regressor, the shape and pose blend-shape bases, the faces and
    the canonical parent tuple as host numpy. `model_data` is a dict of
    arrays or the path of an official SMPL `.pkl`."""

    def __init__(self, model_data, use_pose_blendshape: bool = False):
        if isinstance(model_data, (str, os.PathLike)):
            model_data = load_smpl_arrays(str(model_data))
        self._J_regressor = np.asarray(model_data["J_regressor"], np.float32)
        self._skinning_weights = np.asarray(model_data["weights"], np.float32)
        self._posedirs = np.asarray(model_data["posedirs"], np.float32)
        self._shapedirs = np.asarray(model_data["shapedirs"], np.float32)
        self._v_template = np.asarray(model_data["v_template"], np.float32)
        self._J = np.asarray(model_data["J"], np.float32)
        self.face = np.asarray(model_data["f"])
        self.parent = S._canon_parent(model_data["parents"])
        self.use_pose_blendshape = use_pose_blendshape
        self.num_joints = self._J.shape[0]
        self.num_vertices = self._v_template.shape[0]

    @classmethod
    def synthetic(cls, num_vertices: int = NUM_VERTICES, seed: int = 0,
                  **kw) -> "ParametricModel":
        return cls(synthetic_smpl_arrays(num_vertices, seed), **kw)

    @classmethod
    def from_file_or_synthetic(cls, model_file, **kw) -> "ParametricModel":
        """The official file if it exists, else the deterministic
        synthetic body."""
        if model_file is not None and os.path.exists(str(model_file)):
            return cls(str(model_file), **kw)
        return cls.synthetic(**kw)

    def _host_tensors(self, device: torch.device,
                      dtype: torch.dtype = torch.float32):
        """(J_regressor [24, V], shapedirs [V, 3, 10], v_template [V, 3],
        posedirs [V, 3, 207]) as `dtype` tensors on `device`, built once
        per device and dtype: the shape and pose blend-shape bases."""
        cache = self.__dict__.setdefault("_blend_tensors", {})
        if (device, dtype) not in cache:
            cache[device, dtype] = tuple(
                torch.as_tensor(a, device=device, dtype=dtype)
                for a in (self._J_regressor, self._shapedirs,
                          self._v_template, self._posedirs))
        return cache[device, dtype]

    @f32_matmuls
    def get_zero_pose_joint_and_vertex(
            self, shape: Optional[torch.Tensor] = None):
        """Zero-pose joints/vertices with the root at the origin
        (reference: model.py:77-92). With shape=None, host numpy
        ([24, 3], [V, 3]); with shape parameters [N, 10] (or [10]),
        tensors [N, 24, 3] and [N, V, 3] on the shape's device, float64
        for float64 parameters and float32 otherwise.
        """
        if shape is None:
            j = self._J - self._J[:1]
            v = self._v_template - self._J[:1]
            return j, v
        dtype = _fk_dtype(shape)
        J_reg, shapedirs, v_template, _ = self._host_tensors(shape.device,
                                                             dtype)
        shape = shape.reshape(-1, 10).to(dtype)
        v = torch.tensordot(shape, shapedirs, dims=([1], [2])) + v_template
        j = torch.einsum("jv,nvc->njc", J_reg, v)
        return j - j[:, :1], v - j[:, :1]

    def _device_arrays(self, device: torch.device,
                       dtype: torch.dtype = torch.float32):
        """(zero-pose joints [24,3], vertices [V,3], bone vectors [1,24,3],
        skinning weights [V,24]) as `dtype` tensors on `device`, built
        once per device and dtype."""
        cache = self.__dict__.setdefault("_tensors", {})
        if (device, dtype) not in cache:
            j, v = (torch.as_tensor(a, device=device, dtype=dtype)
                    for a in self.get_zero_pose_joint_and_vertex())
            cache[device, dtype] = (
                j, v, S.joint_position_to_bone_vector(j[None], self.parent),
                torch.as_tensor(self._skinning_weights, device=device,
                                dtype=dtype))
        return cache[device, dtype]

    # -- tree wrappers (smpl.py:278-310 of the JAX package) -----------------
    def bone_vector_to_joint_position(self, bone_vec):
        return S.bone_vector_to_joint_position(bone_vec, self.parent)

    def joint_position_to_bone_vector(self, joint_pos):
        return S.joint_position_to_bone_vector(joint_pos, self.parent)

    def forward_kinematics_R(self, R_local):
        return S.forward_kinematics_R(R_local, self.parent)

    def inverse_kinematics_R(self, R_global):
        return S.inverse_kinematics_R(R_global, self.parent)

    def forward_kinematics_T(self, T_local):
        return S.forward_kinematics_T(T_local, self.parent)

    def inverse_kinematics_T(self, T_global):
        return S.inverse_kinematics_T(T_global, self.parent)

    def joint_positions_from_global(self, R_global):
        """Joint positions from global rotations (position-only FK), on
        the zero-pose bone vectors, computed once per body."""
        if "_bone_vec_np" not in self.__dict__:
            j = self._J - self._J[:1]
            par = np.array([0 if p < 0 else p for p in self.parent])
            bone = j - j[par]
            bone[0] = j[0]
            self._bone_vec_np = bone.astype(np.float32)
        return S.joint_positions_from_global(R_global, self._bone_vec_np,
                                             self.parent)

    @f32_matmuls
    def forward_kinematics(self, pose: torch.Tensor,
                           shape: Optional[torch.Tensor] = None,
                           tran: Optional[torch.Tensor] = None,
                           calc_mesh: bool = False):
        """Global rotations, joint positions and, with calc_mesh, the
        linear-blend-skinned mesh vertices (reference: model.py:208-240),
        in full float32, or in float64 for a float64 pose (the raw-data
        processing, whose acceleration stencil multiplies the vertices'
        rounding by up to 4 * fps^2).

        pose [N, 24, 3, 3] local rotations; shape [N, 10] (or one [10] /
        [1, 10] vector for the whole batch) or None; tran [N, 3] or None.
        Returns (pose_global [N,24,3,3], joints [N,24,3]) and, with
        calc_mesh, vertices [N,V,3].
        """
        pose = pose.reshape(pose.shape[0], -1, 3, 3)
        n = pose.shape[0]
        dtype = _fk_dtype(pose)
        j, v, bone, W = self._device_arrays(pose.device, dtype)
        if shape is None:
            bone = bone.expand(n, -1, -1)
        else:
            j, v = self.get_zero_pose_joint_and_vertex(
                shape.to(device=pose.device, dtype=dtype))
            if j.shape[0] == 1 and n > 1:
                # one shape vector shared by the whole pose batch
                j = j.expand(n, -1, -1)
                v = v.expand(n, -1, -1)
            bone = S.joint_position_to_bone_vector(j, self.parent)
        pose_global, joint_global = S.forward_kinematics(pose, bone,
                                                         self.parent)

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
        if self.use_pose_blendshape:
            posedirs = self._host_tensors(pose.device, dtype)[3]
            eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
            r = (pose[:, 1:] - eye).reshape(n, -1)
            v = v + torch.tensordot(r, posedirs, dims=([1], [2]))
        R_v = torch.einsum("vj,njab->nvab", W, pose_global)
        t_v = torch.einsum("vj,njc->nvc", W, p_adj)
        vertex_global = (R_v @ v[..., None])[..., 0] + t_v
        return pose_global, add_tran(joint_global), add_tran(vertex_global)

    # -- host-side export (reference: model.py:41-75) ----------------------
    def save_obj_mesh(self, vertex_position, file_name="a.obj"):
        """Write one mesh [V, 3] (a tensor or an array) with the body's
        faces as a Wavefront OBJ."""
        verts = torch.as_tensor(vertex_position).detach().cpu().numpy()
        with open(file_name, "w") as fp:
            for v in verts:
                fp.write("v %f %f %f\n" % (v[0], v[1], v[2]))
            for f in self.face + 1:
                fp.write("f %d %d %d\n" % (f[0], f[1], f[2]))

    @staticmethod
    def save_unity_motion(pose=None, tran=None, output_dir="saved_motions/"):
        """Write `pose.txt` (one frame a line: the local rotations [T, 24,
        3, 3] as 72 axis-angle values, %.4f) and `tran.txt` (the root
        translation [T, 3], %.5f), comma-separated, as Unity reads them."""
        os.makedirs(output_dir, exist_ok=True)
        if pose is not None:
            pose = torch.as_tensor(pose).cpu()
            pose = R.rotation_matrix_to_axis_angle(pose).reshape(
                pose.shape[0], -1).numpy()
            with open(os.path.join(output_dir, "pose.txt"), "w") as f:
                f.write("\n".join(
                    ",".join("%.4f" % x for x in p) for p in pose))
        if tran is not None:
            tran = torch.as_tensor(tran).cpu().reshape(-1, 3).numpy()
            with open(os.path.join(output_dir, "tran.txt"), "w") as f:
                f.write("\n".join(
                    ",".join("%.5f" % x for x in t) for t in tran))
