"""Physics-refinement hook (the reference's vestigial PHYSICS path), the
counterpart of `mobileposer_tpu/physics/optimizer.py`.

The reference gates `from dynamics import PhysicsOptimizer` behind the
PHYSICS env var (reference net.py:66-69, 157-169, 211-217), but that
module is missing from it, so enabling the flag raises ImportError. The
JAX package keeps the interface and the gating and backs them with a
working lightweight kinematic refiner; this is its port:

  * per-frame pose smoothing toward the previous frame (jerk suppression)
  * contact-consistent root correction: when a foot is confidently in
    contact, the root translation is adjusted so that foot stays put

It is a refinement hook, not a rigid-body dynamics engine (state in,
state out). As in the JAX package, no entry point calls it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.utils.helpers import getenv_flag


def physics_enabled() -> bool:
    """PHYSICS env gate (reference helpers.py getenv + net.py:66;
    numeric strings int-cast so PHYSICS=0 disables)."""
    return getenv_flag("PHYSICS")


class PhysicsState(NamedTuple):
    prev_pose: torch.Tensor      # [24, 3, 3]
    prev_lfoot: torch.Tensor     # [3]
    prev_rfoot: torch.Tensor     # [3]
    initialized: torch.Tensor    # bool


class PhysicsOptimizer:
    """Per-frame refiner with the reference's optimize_frame signature.

    With `dynamics` (a physics.DynamicsModel), the contact anchoring
    becomes balance-aware: the quasi-static Zero-Moment Point of the pose
    is computed each frame, and the further it falls outside the planted
    foot's support box, the harder the anchor pulls (a dynamically
    implausible pose earns less trust than the contact evidence). Without
    `dynamics` the anchoring is driven by contact probability alone.

    The state lives on `device`: the dynamics model's when one is given,
    else the CUDA card unless the caller names another.
    """

    def __init__(self, body_model=None, smoothing: float = 0.2,
                 contact_threshold: float = 0.7, debug: bool = False,
                 dynamics=None, support_halfwidth: float = 0.12,
                 zmp_scale: float = 0.3, device=None):
        self.body = body_model
        self.smoothing = smoothing
        self.contact_threshold = contact_threshold
        self.debug = debug
        self.dynamics = dynamics
        self.support_halfwidth = support_halfwidth
        self.zmp_scale = zmp_scale
        self.device = resolve_device(
            device if device is not None or dynamics is None
            else dynamics.device)

    def _zmp_overshoot(self, pose, tran, foot_xz):
        """Quasi-static ZMP distance outside the support box around the
        planted foot (meters in the ground plane); 0 when balanced."""
        aa = R.rotation_matrix_to_axis_angle(pose).reshape(-1)
        q = torch.cat([tran, aa])
        zero = torch.zeros(self.dynamics.qdot_size, device=q.device)
        zmp = self.dynamics.calc_zero_moment_point(q, zero, zero)
        d = (zmp[[0, 2]] - foot_xz).abs()
        return torch.linalg.vector_norm(
            torch.clamp_min(d - self.support_halfwidth, 0.0))

    def reset_states(self) -> PhysicsState:
        dev = self.device
        return PhysicsState(
            prev_pose=torch.eye(3, device=dev).expand(24, 3, 3).clone(),
            prev_lfoot=torch.zeros(3, device=dev),
            prev_rfoot=torch.zeros(3, device=dev),
            initialized=torch.tensor(False, device=dev))

    def optimize_frame(self, pose, joint_velocity, contact, acc,
                       state: Optional[PhysicsState] = None,
                       tran: Optional[torch.Tensor] = None):
        """Refine one frame (reference call sites: net.py:163, 216).

        pose: [24, 3, 3]; joint_velocity: [24, 3]; contact: [2] logits;
        acc: unused by this refiner (kept for signature parity).
        Returns ((pose', tran'), state').
        """
        if state is None:
            state = self.reset_states()
        dev = self.device
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        tran = (torch.zeros(3, device=dev) if tran is None
                else torch.as_tensor(tran, dtype=torch.float32, device=dev))
        s = self.smoothing

        # temporal smoothing in rotation space: matrix blend, then QR
        # re-orthonormalization with the signs of diag(R) folded into Q
        # (unique where diag(R) != 0, whatever signs the library chose);
        # skipped on the first frame
        blended = (1 - s) * pose + s * state.prev_pose
        q, r = torch.linalg.qr(blended)
        signs = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
        pose_smoothed = q * signs[..., None, :]
        pose_out = torch.where(state.initialized, pose_smoothed, pose)

        if self.body is not None:
            _, joints = self.body.forward_kinematics(pose_out[None])
            lfoot, rfoot = joints[0, 10] + tran, joints[0, 11] + tran
            prob = torch.sigmoid(torch.as_tensor(
                contact, dtype=torch.float32, device=dev))
            # if a foot is confidently planted, cancel its drift
            left = prob[0] > prob[1]
            anchored = torch.where(left, state.prev_lfoot - lfoot,
                                   state.prev_rfoot - rfoot)
            strength = torch.clamp((prob.max() - self.contact_threshold)
                                   / (1 - self.contact_threshold), 0.0, 1.0)
            if self.dynamics is not None:
                planted = torch.where(left, lfoot, rfoot)
                overshoot = self._zmp_overshoot(pose_out, tran,
                                                planted[[0, 2]])
                # ZMP outside the support box: the pose alone cannot be
                # statically balanced there, so lean harder on the
                # contact. Multiplicative: the boost amplifies anchoring
                # the contact probability already justifies; with no
                # confident contact (flight) it must not pin the foot.
                boost = torch.clamp(overshoot / self.zmp_scale, 0.0, 1.0)
                strength = torch.clamp(strength * (1.0 + boost), 0.0, 1.0)
            tran = tran + torch.where(state.initialized, strength,
                                      torch.zeros_like(strength)) * anchored
            lfoot, rfoot = joints[0, 10] + tran, joints[0, 11] + tran
        else:
            lfoot = rfoot = torch.zeros(3, device=dev)

        new_state = PhysicsState(pose_out, lfoot, rfoot,
                                 torch.tensor(True, device=dev))
        return (pose_out, tran), new_state
