"""Rigid-body dynamics on the SMPL kinematic tree, on PyTorch (counterpart
of `mobileposer_tpu/physics/dynamics.py`; reference
`articulate/utils/rbdl/model.py:14-273`, the RBDL-wrapper surface):
forward and inverse dynamics, the mass matrix, nonlinear effects, body
and point kinematics, Jacobians, the center of mass and the ZMP.

Model: 24 bodies; the root is a free joint (3 translational + 3
rotational DoF), every other joint spherical (3 DoF). Generalized
coordinates, as in the JAX package:

  q    [75] = [root position (world, 3) | axis-angle per joint (24*3)]
  qdot [75] = [root linear velocity (world, 3) |
               relative angular velocity of each body w.r.t. its parent,
               expressed in the CHILD body frame (24*3)]

`qdot` is an angular velocity, not the time derivative of the axis-angle
coordinates (integrate with `integrate_q`).

The math is the JAX package's; the layout is the port's. Run eagerly,
the JAX code's per-body Python recursions and ~600 indexed slice writes
would be thousands of tiny launches a call, so:

  * world rotations go down the tree level by level (9 batched products
    for the SMPL tree), as `kinematics/spatial.py` does;
  * every other recursion is a sum over a body's ancestors (positions,
    velocities, accelerations) or over its subtree (Newton-Euler's
    backward force pass), one product with the constant [24, 24]
    ancestor mask `A[b, a] = 1 if a is b or an ancestor of b`;
  * the per-body Jacobians that assemble M are [24, 24, 3, 3] blocks
    masked by `A`, built with one batched product, not slice writes.

M (from Jacobians) and Newton-Euler's inverse dynamics stay independent
constructions, so ID(q, qd, qdd) == M(q) qdd + h(q, qd) is a genuine
cross-check. `forward_dynamics` is a Cholesky solve of M with one step of
iterative refinement (the JAX code's `cho_factor` / `cho_solve`; the
reference calls RBDL's ABA). `calc_point_Jacobian` applies the point
velocity map, linear in qdot, to the 75 unit vectors at once: consistent
with `calc_point_velocity` by construction.

Arguments are tensors or arrays; every result is a float32 tensor on the
model's device, the CUDA card unless the caller names one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics.smpl import SMPL_PARENTS
from mobileposer_tpu_torch.kinematics.spatial import _tree_levels
from mobileposer_tpu_torch.precision import f32_matmuls

GRAVITY = np.array([0.0, -9.81, 0.0])
N_BODIES = 24
DOF = 3 + N_BODIES * 3            # 75


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1)], -2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, the others broadcast."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., 3, 3] x [..., 3]."""
    return (m @ v[..., None])[..., 0]


class BodyParams(NamedTuple):
    """Per-body inertial parameters (all in each body's local frame)."""
    mass: np.ndarray        # [24]
    com: np.ndarray         # [24, 3] center of mass offset from joint
    inertia: np.ndarray     # [24, 3, 3] rotational inertia about the com

    @classmethod
    def from_smpl(cls, body_model, total_mass: float = 70.0) -> "BodyParams":
        """Anthropometric approximation from the skeleton geometry (host
        numpy, the JAX package's arithmetic): each body's mass is
        proportional to the total length of its child bones (plus a floor
        so leaves carry mass), its com sits at the mean child-bone
        midpoint, and its inertia is a solid ellipsoid around that com,
        plus 2e-3 kg m^2 on the diagonal so M's leaf eigenvalues stay
        well above float32 round-off. Replace with measured values when
        available."""
        j, _ = body_model.get_zero_pose_joint_and_vertex()
        j = np.asarray(j)
        parents = np.asarray(SMPL_PARENTS)
        children = [[] for _ in range(N_BODIES)]
        for b in range(1, N_BODIES):
            children[int(parents[b])].append(b)

        seg_len = np.zeros(N_BODIES)
        com = np.zeros((N_BODIES, 3))
        for b in range(N_BODIES):
            if children[b]:
                offs = np.stack([j[c] - j[b] for c in children[b]])
                seg_len[b] = np.linalg.norm(offs, axis=1).sum()
                com[b] = offs.mean(axis=0) / 2.0
            else:                         # leaf: small stub segment
                seg_len[b] = 0.08
                com[b] = np.zeros(3)
        weight = seg_len + 0.05
        mass = total_mass * weight / weight.sum()

        inertia = np.zeros((N_BODIES, 3, 3))
        for b in range(N_BODIES):
            a = max(seg_len[b], 0.08) / 2.0       # semi-length
            r_ = 0.25 * max(seg_len[b], 0.08)     # radius
            # solid ellipsoid semi-axes (a, r, r)
            ix = 0.4 * mass[b] * (r_ * r_)
            iy = 0.2 * mass[b] * (a * a + r_ * r_)
            inertia[b] = np.diag([iy, ix, iy]) + np.eye(3) * 2e-3
        return cls(mass.astype(np.float32), com.astype(np.float32),
                   inertia.astype(np.float32))


class DynamicsModel:
    """RBDLModel-equivalent surface on the SMPL tree (reference:
    articulate/utils/rbdl/model.py:14-273). `body` arguments are plain
    ints or int-valued enums (SMPL joint indices). The body's constants
    live on `device`: the CUDA card unless given."""

    def __init__(self, body_model=None, params: Optional[BodyParams] = None,
                 gravity=GRAVITY, total_mass: float = 70.0, device=None):
        self.device = resolve_device(device)
        if body_model is None:
            from mobileposer_tpu_torch import config as C
            from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
            body_model = ParametricModel.from_file_or_synthetic(
                C.paths.smpl_file)
        self.body_model = body_model
        self.params = params or BodyParams.from_smpl(body_model, total_mass)
        self.gravity = np.asarray(gravity, np.float32)
        self.q_size = DOF
        self.qdot_size = DOF
        j, _ = body_model.get_zero_pose_joint_and_vertex()
        j = np.asarray(j, np.float32)
        par = np.asarray(SMPL_PARENTS)
        # bone offset of body b in the parent frame (root offset unused;
        # the root's world position comes from q[:3])
        offset = j - j[np.where(par < 0, 0, par)]
        self._parents = tuple(int(p) for p in par)
        anc = np.zeros((N_BODIES, N_BODIES), np.float32)
        for b in range(N_BODIES):
            a = b
            while a >= 0:
                anc[b, a] = 1.0
                a = self._parents[a] if a > 0 else -1
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        self._offset = t(offset)
        self._anc = t(anc)                        # [24 (b), 24 (a)]
        self._anc_strict = t(anc - np.eye(N_BODIES, dtype=np.float32))
        self._par = t([max(p, 0) for p in self._parents], torch.int64)
        self._not_root = t([0.0] + [1.0] * (N_BODIES - 1))[:, None]
        self._levels = [(t(lv, torch.int64),
                         t([self._parents[i] for i in lv], torch.int64))
                        for lv in _tree_levels(self._parents)[1:]]
        self._mass = t(self.params.mass)
        self._com = t(self.params.com)
        self._inertia = t(self.params.inertia)
        self._g = t(self.gravity)
        self._eye3 = torch.eye(3, device=dev)

    # -- inputs ---------------------------------------------------------------
    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _point(self, point) -> torch.Tensor:
        return (torch.zeros(3, device=self.device) if point is None
                else self._t(point))

    @staticmethod
    def _bid(body) -> int:
        return int(getattr(body, "value", body))

    # -- kinematic recursions -------------------------------------------------
    def _fk(self, q):
        """World rotation Rw [24, 3, 3] and joint origin p [24, 3] per
        body: rotations level by level, positions as each body's sum of
        rotated bone offsets over its ancestors."""
        q = self._t(q)
        R_loc = R.axis_angle_to_rotation_matrix(q[3:].reshape(N_BODIES, 3))
        Rw = R_loc.clone()
        for idx, par in self._levels:
            Rw[idx] = Rw[par] @ R_loc[idx]
        # offset of b from its parent in the world: Rw[parent] @ offset[b]
        # (the root's is its world position)
        d = _mv(Rw[self._par], self._offset) * self._not_root
        d[0] = q[:3]
        return Rw, self._anc @ d

    def _vel(self, q, qdot):
        """Adds the world angular velocity w [..., 24, 3] and joint-origin
        linear velocity v [..., 24, 3]; qdot may carry leading batch
        dimensions (the velocity map is linear in qdot)."""
        Rw, p = self._fk(q)
        qdot = self._t(qdot)
        u = qdot[..., 3:].reshape(qdot.shape[:-1] + (N_BODIES, 3))
        w = self._anc @ _mv(Rw, u)                     # sum over ancestors
        d = (p - p[self._par]) * self._not_root        # p[b] - p[parent]
        # d[root] = 0: the root's velocity is qdot[:3] alone
        v = self._anc @ _cross(w[..., self._par, :], d) + qdot[..., None, :3]
        return Rw, p, w, v, u, d

    def _acc(self, q, qdot, qddot):
        """Adds the world angular / linear accelerations alpha, a
        [24, 3] of each joint origin."""
        Rw, p, w, v, u, d = self._vel(q, qdot)
        qddot = self._t(qddot)
        ud = qddot[3:].reshape(N_BODIES, 3)
        # the root's parent does not move: its w_parent term is zero
        w_par = w[self._par] * self._not_root
        alpha = self._anc @ (_mv(Rw, ud) + _cross(w_par, _mv(Rw, u)))
        alpha_par = alpha[self._par] * self._not_root
        a = (self._anc @ (_cross(alpha_par, d)
                          + _cross(w_par, _cross(w_par, d)))
             + qddot[:3])
        return Rw, p, w, v, alpha, a, d

    def _world_inertia(self, Rw):
        return Rw @ self._inertia @ Rw.transpose(-1, -2)

    # -- dynamics -------------------------------------------------------------
    @f32_matmuls
    def inverse_dynamics(self, q, qdot, qddot) -> torch.Tensor:
        """Newton-Euler: generalized forces tau [75] for a prescribed
        motion (reference: model.py:44-55). The backward pass sums each
        subtree: f[a] = sum of F over a's subtree, and the moment about a
        gathers its subtree's own moments and each descendant's force at
        its offset from its parent."""
        Rw, p, w, v, alpha, a, d = self._acc(q, qdot, qddot)
        c_off = _mv(Rw, self._com)                         # com offset, world
        I_w = self._world_inertia(Rw)
        a_com = a + _cross(alpha, c_off) + _cross(w, _cross(w, c_off))
        F = self._mass[:, None] * (a_com - self._g)        # [24, 3]
        N = _mv(I_w, alpha) + _cross(w, _mv(I_w, w))
        f = self._anc.t() @ F                              # subtree sums
        n = (self._anc.t() @ (N + _cross(c_off, F))
             + self._anc_strict.t() @ _cross(d, f))
        tau = _mv(Rw.transpose(-1, -2), n)                 # child-frame torque
        return torch.cat([f[0], tau.reshape(-1)])

    @f32_matmuls
    def calc_h(self, q, qdot) -> torch.Tensor:
        """Nonlinear effects h(q, qdot): Coriolis/centrifugal + gravity
        (reference: model.py:68-78)."""
        return self.inverse_dynamics(q, qdot,
                                     torch.zeros(DOF, device=self.device))

    def _body_jacobians(self, q):
        """Per-body world Jacobians at the coms: Jv [24, 3, 75] maps qdot
        to com linear velocity, Jw [24, 3, 75] to body angular velocity.
        Independent of the Newton-Euler recursion (used to assemble M).
        Block (b, a) is Rw[a] (angular) and -skew(c_w[b] - p[a]) Rw[a]
        (linear) where a is b or one of its ancestors, else zero."""
        Rw, p = self._fk(q)
        c_w = p + _mv(Rw, self._com)
        mask = self._anc[:, :, None, None]                 # [b, a, 1, 1]
        Jw_blk = mask * Rw[None]                           # [b, a, 3, 3]
        Jv_blk = -mask * (_skew(c_w[:, None] - p[None]) @ Rw[None])
        eye = self._eye3.expand(N_BODIES, 3, 3)
        Jw = torch.cat([torch.zeros_like(eye),
                        Jw_blk.permute(0, 2, 1, 3).reshape(N_BODIES, 3, -1)],
                       dim=-1)
        Jv = torch.cat([eye,
                        Jv_blk.permute(0, 2, 1, 3).reshape(N_BODIES, 3, -1)],
                       dim=-1)
        return Jv, Jw, Rw, p, c_w

    @f32_matmuls
    def calc_M(self, q) -> torch.Tensor:
        """Joint-space inertia matrix M(q) [75, 75]
        (reference: model.py:57-66): sum_b Jv_b^T m_b Jv_b +
        Jw_b^T I_b Jw_b."""
        Jv, Jw, Rw, _, _ = self._body_jacobians(q)
        I_w = self._world_inertia(Rw)
        return (torch.einsum("b,bik,bil->kl", self._mass, Jv, Jv)
                + torch.einsum("bik,bij,bjl->kl", Jw, I_w, Jw))

    @f32_matmuls
    def forward_dynamics(self, q, qdot, tau) -> torch.Tensor:
        """qddot [75] from applied generalized forces (reference:
        model.py:31-42, RBDL's ABA): a Cholesky solve of M, then one step
        of iterative refinement, which recovers the digits float32 loses
        on M's small leaf-inertia eigenvalues."""
        M = self.calc_M(q)
        h = self.calc_h(q, qdot)
        rhs = (self._t(tau) - h)[:, None]
        L = torch.linalg.cholesky(M)
        qddot = torch.cholesky_solve(rhs, L)
        r = rhs - M @ qddot
        return (qddot + torch.cholesky_solve(r, L))[:, 0]

    # -- body / point kinematics ----------------------------------------------
    @f32_matmuls
    def calc_body_to_base_coordinates(self, q, body, point=None):
        """Body-frame point -> world (reference: model.py:80-91)."""
        b = self._bid(body)
        Rw, p = self._fk(q)
        return p[b] + Rw[b] @ self._point(point)

    @f32_matmuls
    def calc_base_to_body_coordinates(self, q, body, point=None):
        b = self._bid(body)
        Rw, p = self._fk(q)
        return Rw[b].t() @ (self._point(point) - p[b])

    def calc_body_position(self, q, body):
        return self.calc_body_to_base_coordinates(q, body)

    def calc_body_orientation(self, q, body):
        Rw, _ = self._fk(q)
        return Rw[self._bid(body)]

    @f32_matmuls
    def calc_point_Jacobian(self, q, body, point=None):
        """3D world Jacobian [3, 75] of a body-fixed point: J qdot = world
        point velocity (reference: model.py:153-166). The point velocity
        is linear in qdot, so its columns are the velocities of the 75
        unit qdots, all in one call of the velocity map."""
        eye = torch.eye(DOF, device=self.device)
        return self.calc_point_velocity(q, eye, body, point).t()

    @f32_matmuls
    def calc_body_Jacobian(self, q, body):
        """6D Jacobian [angular; linear] of the body frame expressed in
        the BODY frame (reference: model.py:126-136)."""
        b = self._bid(body)
        Jv, Jw, Rw, p, c_w = self._body_jacobians(q)
        # _body_jacobians' Jv is at the com; shift back to the joint origin
        Jv_origin = Jv[b] + _skew(c_w[b] - p[b]) @ Jw[b]
        return torch.cat([Rw[b].t() @ Jw[b], Rw[b].t() @ Jv_origin])

    @f32_matmuls
    def calc_space_Jacobian(self, q, body):
        """6D space Jacobian [angular; linear] in the base frame
        (reference: model.py:138-151): the linear rows give the velocity
        of the body point instantaneously at the origin,
        v_s = v_origin - w x p."""
        b = self._bid(body)
        Jv, Jw, Rw, p, c_w = self._body_jacobians(q)
        Jv_origin = Jv[b] + _skew(c_w[b] - p[b]) @ Jw[b]
        return torch.cat([Jw[b], Jv_origin + _skew(p[b]) @ Jw[b]])

    @f32_matmuls
    def calc_point_velocity(self, q, qdot, body, point=None):
        """World velocity [..., 3] of a body-fixed point (qdot [..., 75])."""
        b = self._bid(body)
        Rw, p, w, v, _, _ = self._vel(q, qdot)
        return v[..., b, :] + _cross(w[..., b, :],
                                     Rw[b] @ self._point(point))

    @f32_matmuls
    def calc_point_acceleration(self, q, qdot, qddot, body, point=None):
        b = self._bid(body)
        Rw, p, w, v, alpha, a, _ = self._acc(q, qdot, qddot)
        off = Rw[b] @ self._point(point)
        return a[b] + _cross(alpha[b], off) + _cross(w[b], _cross(w[b], off))

    # -- center of mass / ZMP -------------------------------------------------
    def _com_terms(self, q, qdot, qddot=None):
        Rw, p, w, v, alpha, a, _ = self._acc(
            q, qdot, torch.zeros(DOF, device=self.device) if qddot is None
            else qddot)
        c_off = _mv(Rw, self._com)
        c_w = p + c_off
        v_c = v + _cross(w, c_off)
        a_c = a + _cross(alpha, c_off) + _cross(w, _cross(w, c_off))
        return self._mass, c_w, v_c, a_c, w, alpha, self._world_inertia(Rw)

    @f32_matmuls
    def calc_center_of_mass_position(self, q, qdot):
        m, c_w, *_ = self._com_terms(q, qdot)
        mass = m.sum()
        return mass, m @ c_w / mass

    @f32_matmuls
    def calc_center_of_mass_position_velocity(self, q, qdot):
        m, c_w, v_c, a_c, w, alpha, I_w = self._com_terms(q, qdot)
        mass = m.sum()
        com = m @ c_w / mass
        com_v = m @ v_c / mass
        # angular momentum about the com
        L = _mv(I_w, w).sum(0) + m @ _cross(c_w - com, v_c)
        return mass, com, com_v, L

    @f32_matmuls
    def calc_center_of_mass_position_velocity_acceleration(self, q, qdot,
                                                           qddot):
        m, c_w, v_c, a_c, w, alpha, I_w = self._com_terms(q, qdot, qddot)
        mass = m.sum()
        com = m @ c_w / mass
        com_v = m @ v_c / mass
        com_a = m @ a_c / mass
        L = _mv(I_w, w).sum(0) + m @ _cross(c_w - com, v_c)
        dL = (_mv(I_w, alpha).sum(0) + _cross(w, _mv(I_w, w)).sum(0)
              + m @ _cross(c_w - com, a_c))
        return mass, com, com_v, L, com_a, dL

    @f32_matmuls
    def calc_zero_moment_point(self, q, qdot, qddot,
                               plane_normal=np.array([0.0, 1.0, 0.0])):
        """ZMP on the plane through the origin with the given normal
        (reference: model.py:251-263): the point where the tipping moment
        of gravity + inertial forces vanishes in the plane."""
        mass, com, com_v, L, com_a, dL = \
            self.calc_center_of_mass_position_velocity_acceleration(
                q, qdot, qddot)
        n = self._t(plane_normal)
        f_gi = mass * (self._g - com_a)           # gravity+inertia wrench
        m_gi = _cross(com, f_gi) - dL             # moment about origin
        denom = n @ f_gi
        denom = torch.where(denom.abs() < 1e-9,
                            torch.full_like(denom, 1e-9), denom)
        return _cross(n, m_gi) / denom

    # -- integration helper ---------------------------------------------------
    @f32_matmuls
    def integrate_q(self, q, qdot, dt: float):
        """Semi-implicit update of q by qdot over dt: the root position
        moves in the world; each local rotation composes with exp(u dt)
        (u is the child-frame relative angular velocity, so
        R_loc <- R_loc exp(skew(u) dt))."""
        q, qdot = self._t(q), self._t(qdot)
        R_loc = R.axis_angle_to_rotation_matrix(q[3:].reshape(N_BODIES, 3))
        dR = R.axis_angle_to_rotation_matrix(
            qdot[3:].reshape(N_BODIES, 3) * dt)
        aa_new = R.rotation_matrix_to_axis_angle(R_loc @ dR)
        return torch.cat([q[:3] + qdot[:3] * dt, aa_new.reshape(-1)])
