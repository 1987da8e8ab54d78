"""MobilePoserNet, the composite pose + translation estimator, on PyTorch.

Counterpart of `mobileposer_tpu/models/net.py` for the exact streaming
path and offline inference (reference `mobileposer/models/net.py:101-219`):

  * `forward`                           — chained 4-module pass, ragged
                                          batches through `lengths`, with
                                          the pose assembly at one emit
                                          index or every frame
  * `forward_offline`                   — whole-sequence inference with the
                                          translation fusion
  * `forward_online_batched`            — one streaming step for S streams
  * `forward_online_sequence_batched`   — S streams x N frames, in 'scan'
                                          (per-frame replay) or 'unfolded'
                                          (windows batched) mode
  * `forward_online`, `forward_online_sequence`
                                        — one stream, S = 1 adapters over
                                          `forward_online_batched`
  * `forward_carry_batched`, `forward_carry_sequence_batched`
                                        — carry-mode streaming
                                          (`models/streaming.py`)
  * `reduced_r6d_to_global`, `reduced_global_to_full`
                                        — the pose assembly in the
                                          array-of-structures layout, the
                                          reference for the streaming
                                          layout's `reduced_global_to_full_soa`

The four RNN blocks run their LSTM layers through the CUDA kernels of
`ops/lstm_cuda.py` on the card (plain versions on the CPU). Linears,
input projections, the r6d -> rotation -> IK assembly and the translation
fusion are plain batched PyTorch. The JAX package's `lax.scan` loops
become Python loops; the semantics are unchanged, and the parity tests
hold every output and state field to the JAX package.

W8A8 int8 params (`ops.quant.quantize_params_int8`, or a quantized tree
through `nn.convert.params_from_jax`) flow through every entry point
unchanged: the dtype of each LSTM layer's w_ih sends it to the int8
projections and the int8 kernels #4 to #6; on a bf16 cast quantized
(int8 on bf16 params) with a bf16 input and state, to their bf16 entries
(x_proj rounded to bf16 once, the carry float32).

`forward(backend='fused')` runs the poser / footcontact / velocity trio
of a single full-length window on the multicell kernel
(`models/fused.py`); every other entry point computes 'fused' as 'auto'.

bfloat16 inference: params cast with `nn.convert.cast_params`, the IMU
input and the streaming state (`dtype=torch.bfloat16`) in bf16, and every
entry point runs in bf16 with the JAX package's dtypes: the LSTM layers
on the kernels' bf16 entries (float32 carry), the IK products in float32
cast back, and the fusion accumulators and foot anchors of the streaming
state always float32.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics.smpl import SMPL_PARENTS, ParametricModel
from mobileposer_tpu_torch.models.fused import trio_apply
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS, module_apply
from mobileposer_tpu_torch.nn.lstm import (check_backend, check_dtype,
                                           check_lengths, rnn_zero_state)
from mobileposer_tpu_torch.precision import f32_matmuls
from mobileposer_tpu_torch.utils.profiling import span

GRAVITY_VELOCITY = (0.0, C.joint_set.gravity_velocity, 0.0)
PROB_THRESHOLD = (0.5, 0.9)           # reference: net.py:53
VEL_SCALE_PER_FRAME = C.datasets.fps / C.amass.vel_scale   # 15
NUM_PAST = C.model_config.past_frames       # 40
NUM_TOTAL = C.model_config.total_frames     # 45


def prob_to_weight(p: torch.Tensor) -> torch.Tensor:
    """Map contact probability to fusion weight in [0, 1] (net.py:90-91)."""
    lo, hi = PROB_THRESHOLD
    return (torch.clamp(p, lo, hi) - lo) / (hi - lo)


# joint j -> slot in [reduced_rot | identity]: position in the reduced list,
# or the appended identity slot for non-reduced joints
_GATHER_MAP = np.full(24, len(C.joint_set.reduced), np.int64)
for _pos, _j in enumerate(C.joint_set.reduced):
    _GATHER_MAP[_j] = _pos
_REDUCED = np.asarray(C.joint_set.reduced)
# joint j -> reduced-list position of its nearest reduced ancestor (itself
# if reduced): each joint's effective global rotation after the
# IK -> identity-at-ignored -> FK round trip the model performs
_EFFECTIVE_GATHER_MAP = np.zeros(24, np.int64)
for _j in range(24):
    _a = _j
    while _a not in C.joint_set.reduced:
        _a = SMPL_PARENTS[_a]
    _EFFECTIVE_GATHER_MAP[_j] = list(C.joint_set.reduced).index(_a)
_IGNORED_MASK = np.zeros((24, 1, 1), np.float32)
_IGNORED_MASK[list(C.joint_set.ignored)] = 1.0
_ROOT_MASK = np.zeros((24, 1, 1), np.float32)
_ROOT_MASK[0] = 1.0


def reduced_r6d_to_global(reduced_r6d: torch.Tensor,
                          effective: bool = False) -> torch.Tensor:
    """16-joint r6d [N, 96] -> the 24 joints' GLOBAL rotations
    [N, 24, 3, 3], gather-assembled (net.py:80 of the JAX package).

    effective=False: the identity at the joints not in the reduced set
    (the raw assembly fed into IK). effective=True: each such joint takes
    its nearest reduced ancestor's rotation, its actual global rotation
    after the IK -> identity-at-ignored -> FK round trip.
    """
    n = reduced_r6d.shape[0]
    rot = R.r6d_to_rotation_matrix(reduced_r6d).reshape(n, -1, 3, 3)
    if effective:
        return rot.index_select(1, torch.as_tensor(
            _EFFECTIVE_GATHER_MAP, device=rot.device))
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(n, 1, 3, 3)
    padded = torch.cat([rot, eye], dim=1)                    # [n, 17, 3, 3]
    return padded.index_select(1, torch.as_tensor(_GATHER_MAP,
                                                  device=rot.device))


def reduced_global_to_full(reduced_r6d: torch.Tensor,
                           body_model: ParametricModel) -> torch.Tensor:
    """16-joint global r6d [N, 96] -> the 24 joints' local rotations
    [N, 24, 3, 3] in the array-of-structures layout (net.py:100 of
    the JAX package; reference net.py:93-99): r6d -> global rotations
    (identity elsewhere) -> IK to local -> identity at the ignored joints
    -> the root keeps its global rotation. `reduced_global_to_full_soa`
    computes the same in the streaming layout."""
    global_pose = reduced_r6d_to_global(reduced_r6d)
    local_pose = body_model.inverse_kinematics_R(global_pose)
    dev = local_pose.device
    eye = torch.eye(3, dtype=local_pose.dtype, device=dev)
    local_pose = torch.where(torch.as_tensor(_IGNORED_MASK > 0, device=dev),
                             eye, local_pose)
    return torch.where(torch.as_tensor(_ROOT_MASK > 0, device=dev),
                       global_pose[:, 0:1], local_pose)


def _soa_parent_map(body_model: ParametricModel) -> np.ndarray:
    """Root-clamped parent indices, cached on the body."""
    if not hasattr(body_model, "_soa_parent_np"):
        body_model._soa_parent_np = np.array(
            [0 if p < 0 else p for p in body_model.parent], np.int64)
    return body_model._soa_parent_np


class _SoaConstants(NamedTuple):
    gather: torch.Tensor     # [24] slot in [reduced | identity]
    parent: torch.Tensor     # [24] root-clamped parent
    ignored: torch.Tensor    # [24, 1, 1, 1] bool
    root: torch.Tensor       # [24, 1, 1, 1] bool
    eye: torch.Tensor        # [1, 3, 3, 1]


def _soa_constants(body_model: ParametricModel, device: torch.device,
                   dtype: torch.dtype) -> _SoaConstants:
    """The assembly's index maps and masks as tensors on `device`, built
    once per (body, device, dtype): copying them per call would put a
    host-to-device copy on every streaming step."""
    cache = body_model.__dict__.setdefault("_soa_tensors", {})
    key = (device, dtype)
    if key not in cache:
        cache[key] = _SoaConstants(
            gather=torch.as_tensor(_GATHER_MAP, device=device),
            parent=torch.as_tensor(_soa_parent_map(body_model),
                                   device=device),
            ignored=torch.as_tensor(_IGNORED_MASK[..., None] > 0,
                                    device=device),
            root=torch.as_tensor(_ROOT_MASK[..., None] > 0, device=device),
            eye=torch.eye(3, dtype=dtype, device=device)[None, :, :, None])
    return cache[key]


def _r6d_to_rot_soa(x: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt r6d -> rotation (reference angular.py:167-182) in the
    lane-major layout: x [J, 6, N] -> [J, 3, 3, N]. The norm clamp matches
    kinematics.rotation._safe_norm exactly."""
    eps_sq = 1e-8 * 1e-8
    v1, v2 = x[:, 0:3], x[:, 3:6]                                # [J, 3, N]
    col0 = v1 / torch.sqrt(torch.clamp_min(
        torch.sum(v1 * v1, dim=1, keepdim=True), eps_sq))
    v2 = v2 - torch.sum(col0 * v2, dim=1, keepdim=True) * col0
    col1 = v2 / torch.sqrt(torch.clamp_min(
        torch.sum(v2 * v2, dim=1, keepdim=True), eps_sq))
    col2 = torch.linalg.cross(col0, col1, dim=1)
    return torch.stack([col0, col1, col2], dim=2)                # [J,3,3,N]


def reduced_global_to_full_soa(reduced_r6d: torch.Tensor,
                               body_model: ParametricModel) -> torch.Tensor:
    """16-joint global r6d [N, 96] -> full 24-joint local rotations
    [N, 24, 3, 3] (reference net.py:93-99), in the structure-of-arrays
    layout of the JAX package: every array is [..., N] with the batch in
    the minor axis, so the small-matrix math is elementwise.

    r6d -> global rotations at the reduced joints (identity elsewhere) ->
    IK to local (parent^T @ child) -> identity at ignored joints -> the
    root keeps its global rotation. The IK products accumulate in float32
    and are cast back to the input's dtype, as the JAX package does under
    bf16 streaming.
    """
    with span("mp.decode_ik"):
        N = reduced_r6d.shape[0]
        k = _soa_constants(body_model, reduced_r6d.device, reduced_r6d.dtype)
        x = reduced_r6d.reshape(N, -1, 6).permute(1, 2, 0)      # [16, 6, N]
        rot = _r6d_to_rot_soa(x)                                 # [16,3,3,N]
        padded = torch.cat([rot, k.eye.expand(1, 3, 3, N)], 0)   # [17,3,3,N]
        glob = padded.index_select(0, k.gather)                  # [24,3,3,N]

        # IK: local[j] = glob[parent[j]]^T @ glob[j] — three elementwise FMAs
        par = glob.index_select(0, k.parent)
        if glob.dtype == torch.float32:
            local = sum(par[:, i, :, None] * glob[:, i, None, :]
                        for i in range(3))
        else:  # bf16: the products summed in float32, then cast back
            par32, glob32 = par.float(), glob.float()
            local = sum(par32[:, i, :, None] * glob32[:, i, None, :]
                        for i in range(3)).to(glob.dtype)
        local = torch.where(k.ignored, k.eye, local)
        local = torch.where(k.root, glob[0:1], local)
        return local.permute(3, 0, 1, 2)                         # [N,24,3,3]


def _position_basis(body_model: ParametricModel):
    """The linear map from the 16 reduced GLOBAL rotations to the 24 joint
    positions, cached on the body (net.py:179-207 of the JAX package).

    Every joint position is a sum of rotated bone vectors up its ancestor
    chain, and after the effective gather only the 16 reduced rotations
    appear, so p[j, a] = sum_{r,b} W[(j,a),(r,a,b)] * R[r,a,b] + bone[0].
    Returns (W [72, 144], root_offset [3]) as numpy.
    """
    if not hasattr(body_model, "_pos_basis_np"):
        j0 = np.asarray(body_model._J, np.float32)
        j0 = j0 - j0[:1]
        parent = [0 if p < 0 else p for p in body_model.parent]
        bone = j0 - j0[parent]
        bone[0] = j0[0]
        V = np.zeros((24, len(_REDUCED), 3), np.float32)
        for j in range(24):
            i = j
            while i != 0:
                V[j, _EFFECTIVE_GATHER_MAP[parent[i]]] += bone[i]
                i = parent[i]
        W = np.zeros((24, 3, len(_REDUCED), 3, 3), np.float32)
        for a in range(3):
            W[:, a, :, a, :] = V
        body_model._pos_basis_np = (W.reshape(72, len(_REDUCED) * 9),
                                    bone[0].copy())
    return body_model._pos_basis_np


def _position_basis_tensors(body_model: ParametricModel, device):
    """`_position_basis` as float32 tensors on `device`, built once per
    device: (W [72, 144], root offset tiled to [72, 1])."""
    cache = body_model.__dict__.setdefault("_pos_basis_tensors", {})
    if device not in cache:
        W, root = _position_basis(body_model)
        cache[device] = (torch.as_tensor(W, device=device),
                         torch.as_tensor(np.tile(root, 24)[:, None],
                                         device=device))
    return cache[device]


@f32_matmuls
def joint_positions_from_r6d_soa(reduced_r6d: torch.Tensor,
                                 body_model: ParametricModel) -> torch.Tensor:
    """Joint positions [N, 72] straight from reduced r6d [N, 96]
    (net.py:210-230 of the JAX package): the effective gather, the bone
    rotations and the tree prefix sum as one [72, 144] @ [144, N] product
    over the bone basis, with the batch in the minor axis. The product
    runs in full float32 whatever the TF32 setting, as the JAX code pins
    float32. The poser loss's position term."""
    N = reduced_r6d.shape[0]
    x = reduced_r6d.reshape(N, -1, 6).permute(1, 2, 0)          # [16, 6, N]
    rot = _r6d_to_rot_soa(x)                                     # [16,3,3,N]
    W, root = _position_basis_tensors(body_model, reduced_r6d.device)
    pos = W @ rot.reshape(-1, N) + root                          # [72, N]
    return pos.transpose(0, 1)                                   # [N, 72]


def forward(params, imu: torch.Tensor, body_model: ParametricModel,
            lengths=None, vel_h0c0=None, backend: str = "auto",
            pose_index: Optional[int] = None):
    """Chained 4-module pass (reference: net.py:101-119).

    params: the four modules (`init_all_modules`, `nn.convert.params_from_jax`).
    imu: [B, T, 60]. Returns (pose_local [B, T, 24, 3, 3],
    joints [B, T, 72], vel [B, T, 72], contact_logits [B, T, 2], vel_hc).
    The velocity module's LSTM carry is explicit: `vel_h0c0=None` starts a
    fresh stream (zero carries), or thread the returned carry.
    lengths: [B] valid frames per row, or None; with lengths every LSTM
    layer of the four modules runs the masked kernels, and outputs past a
    row's length are finite but meaningless.

    pose_index: when set, the r6d -> IK assembly runs only at that time
    index and pose_local is [B, 24, 3, 3]; the streaming path emits one
    frame per window (reference net.py:181).

    backend: 'auto' runs every module on the layer kernels. 'fused'
    without `lengths` runs joints as 'auto' does, then the poser /
    footcontact / velocity trio as two multicell launches
    (`models/fused.py` `trio_apply`, which raises ValueError on int8
    params); with `lengths` it runs the per-module masked path as 'auto'
    does (net.py:269-288 of the JAX package).
    """
    check_backend(backend, allow_train=False)
    check_dtype(imu.dtype)
    B, T, _ = imu.shape
    if lengths is not None:
        # checked and moved to the device once, not once per module
        lengths = check_lengths(lengths, B, T, imu.device)
    # the chain runs time-major [T, B, *], the LSTM core's own layout
    imu_tm = imu.transpose(0, 1)
    pred_joints_tm, _ = module_apply("joints", params["joints"], imu_tm,
                                     lengths, time_major=True)
    x132 = torch.cat([pred_joints_tm, imu_tm], dim=-1)
    if vel_h0c0 is None:
        vel_h0c0 = rnn_zero_state(MODULE_CONFIGS["velocity"], B, imu.dtype,
                                  imu.device)
    if backend == "fused" and lengths is None:
        # the trio's five cells per layer-row in one multicell launch
        pred_pose_r6d, contact, vel, vel_hc = trio_apply(params, x132,
                                                         vel_h0c0)
    else:
        pred_pose_r6d, _ = module_apply("poser", params["poser"], x132,
                                        lengths, time_major=True)
        contact, _ = module_apply("footcontact", params["footcontact"],
                                  x132, lengths, time_major=True)
        vel, vel_hc = module_apply("velocity", params["velocity"], x132,
                                   lengths, h0c0=vel_h0c0, time_major=True)
    if pose_index is None:
        pose_local = reduced_global_to_full_soa(
            pred_pose_r6d.reshape(T * B, -1), body_model).reshape(T, B, 24, 3, 3)
        pose_out = pose_local.transpose(0, 1)
    else:
        pose_out = reduced_global_to_full_soa(pred_pose_r6d[pose_index],
                                              body_model)
    return (pose_out, pred_joints_tm.transpose(0, 1), vel.transpose(0, 1),
            contact.transpose(0, 1), vel_hc)


def _fuse_velocity(joints: torch.Tensor, vel: torch.Tensor,
                   contact: torch.Tensor, floor_y: float) -> torch.Tensor:
    """Whole-sequence translation fusion (reference: net.py:129-154) for
    a batch of sequences at once, the port's form of the JAX package's
    `jax.vmap` over `_fuse_velocity`.

    joints [N, T, 24, 3], vel [N, T, 72], contact logits [N, T, 2] ->
    tran [N, T, 3].
    """
    N, T = joints.shape[:2]
    zero = joints.new_zeros((N, 1, 3))
    lfoot_disp = torch.cat([zero, joints[:, :-1, 10] - joints[:, 1:, 10]], 1)
    rfoot_disp = torch.cat([zero, joints[:, :-1, 11] - joints[:, 1:, 11]], 1)
    # argmax takes the first maximum, as jnp.argmax does
    pick_right = torch.argmax(contact, dim=2).to(joints.dtype)[..., None]
    # + GRAVITY_VELOCITY (float32 there, so a bf16 lerp is widened first),
    # whose x and z are 0: a scalar add, so no host-to-device copy makes
    # the host wait for the device here
    contact_vel = R.lerp(lfoot_disp, rfoot_disp, pick_right).float()
    contact_vel[..., 1] += GRAVITY_VELOCITY[1]

    root_vel = vel.reshape(N, T, 24, 3)[:, :, 0] / VEL_SCALE_PER_FRAME
    weight = prob_to_weight(torch.sigmoid(contact.amax(dim=2)))[..., None]
    velocity = R.lerp(root_vel, contact_vel, weight)

    # Floor-penetration clamp: the reference's frame-serial loop
    # (net.py:149-153), one step per frame for all N sequences at once.
    foot_min_y = torch.amin(joints[:, :, 10:12, 1], dim=2)       # [N, T]
    # in velocity's dtype, float32 (the JAX scan promotes its 0.0 carry)
    root_y = velocity.new_zeros((N,))
    v_y = []
    for t in range(T):
        current_foot_y = root_y + foot_min_y[:, t]
        v = velocity[:, t, 1]
        v = torch.where(current_foot_y + v <= floor_y,
                        floor_y - current_foot_y, v)
        root_y = root_y + v
        v_y.append(v)
    velocity = torch.cat([velocity[..., :1], torch.stack(v_y, 1)[..., None],
                          velocity[..., 2:]], dim=-1)
    return torch.cumsum(velocity, dim=1)


class OnlineState(NamedTuple):
    """Streaming state for S streams, stream axis leading everywhere except
    the velocity carry, which keeps the LSTM stack layout [2, S, 256]."""
    imu: torch.Tensor             # [S, 45, 60] sliding window
    initialized: torch.Tensor     # [S] bool
    vel_h: torch.Tensor           # [2, S, 256] velocity LSTM h
    vel_c: torch.Tensor           # [2, S, 256] velocity LSTM c
    last_lfoot: torch.Tensor      # [S, 3]
    last_rfoot: torch.Tensor      # [S, 3]
    current_root_y: torch.Tensor  # [S]
    last_root_pos: torch.Tensor   # [S, 3]


# Stream-axis index per field of a BATCHED state, read by
# `parallel.shard_stream_state` so that sharding the slots never guesses
# from shapes (a stream count equal to the layer stack's 2 or the
# window's 45 would defeat the guess).
OnlineState.STREAM_AXES = OnlineState(
    imu=0, initialized=0, vel_h=1, vel_c=1, last_lfoot=0, last_rfoot=0,
    current_root_y=0, last_root_pos=0)


class MobilePoserNet:
    """Binds the SMPL body constants and a device; the methods take the
    module parameters explicitly, like the JAX package's (reference class:
    net.py:22).

    body_model: the official SMPL body at `C.paths.smpl_file` when that
    file exists, else the synthetic body, unless given. device: the CUDA
    card unless given; `device="cpu"` runs the plain kernel versions.
    """

    OnlineState = OnlineState

    #: Below this many streams 'auto' picks the unfolded mode. The value is
    #: the JAX package's, measured on a TPU; it is inherited so both
    #: packages pick the same mode, and has not been measured on the card
    #: (ROADMAP.md queue A item 11).
    UNFOLD_MAX_STREAMS = 32

    def __init__(self, body_model: Optional[ParametricModel] = None,
                 online_sigmoid: bool = True, device=None):
        self.device = resolve_device(device)
        self.body_model = (body_model if body_model is not None
                           else ParametricModel.from_file_or_synthetic(
                               C.paths.smpl_file))
        j, _ = self.body_model.get_zero_pose_joint_and_vertex()
        self.feet_pos = j[10:12]                     # net.py:48
        self.floor_y = float(j[10:12, 1].min())      # net.py:49
        # The reference's online path feeds raw contact logits into the
        # fusion weight (net.py:196); the default applies the sigmoid as
        # the offline path does, online_sigmoid=False reproduces the
        # reference.
        self.online_sigmoid = online_sigmoid
        self._gravity = torch.tensor(GRAVITY_VELOCITY, dtype=torch.float32,
                                     device=self.device)

    def on(self, device) -> "MobilePoserNet":
        """This net bound to `device` (itself when it is there already):
        the body and its constants are shared, only the device-resident
        ones are moved. The sharded paths run one per mesh device."""
        device = resolve_device(device)
        if device == self.device:
            return self
        other = copy.copy(self)
        other.device = device
        other._gravity = self._gravity.to(device)
        return other

    def forward_offline(self, params, imu: torch.Tensor, vel_h0c0=None,
                        length=None):
        """imu [T, 60] -> (pose [T,24,3,3], joints [T,24,3], tran [T,3],
        contact [T,2]) (reference: net.py:121-171).

        `length` marks the valid prefix of a padded sequence; outputs past
        it are meaningless, to be sliced off. All fusion state flows
        forward in time, so the valid prefix does not depend on the
        padding.
        """
        lengths = None if length is None else [int(length)]
        pose, joints, vel, contact, _ = forward(
            params, imu[None], self.body_model, lengths=lengths,
            vel_h0c0=vel_h0c0)
        T = imu.shape[0]
        joints = joints.reshape(1, T, 24, 3)
        tran = _fuse_velocity(joints, vel, contact, self.floor_y)
        return pose[0], joints[0], tran[0], contact[0]

    def init_online_state_batched(self, n_streams: int,
                                  dtype: torch.dtype = torch.float32
                                  ) -> OnlineState:
        """Fresh streaming state for `n_streams` independent streams on
        the net's device: the window and the velocity carry in `dtype`
        (float32 or bfloat16), the fusion accumulators and foot anchors
        always float32 (net.py:450-456 of the JAX package: a bf16
        accumulator's ulp passes a 30 Hz step past ~16 m, and translation
        would freeze)."""
        check_dtype(dtype)
        S, dev = n_streams, self.device
        cfg = MODULE_CONFIGS["velocity"]
        feet = torch.as_tensor(np.asarray(self.feet_pos, np.float32),
                               device=dev)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return OnlineState(
            imu=zeros(S, NUM_TOTAL, C.model_config.n_imu, dtype=dtype),
            initialized=torch.zeros((S,), dtype=torch.bool, device=dev),
            vel_h=zeros(cfg.n_layers, S, cfg.n_hidden, dtype=dtype),
            vel_c=zeros(cfg.n_layers, S, cfg.n_hidden, dtype=dtype),
            last_lfoot=feet[0].expand(S, 3).clone(),
            last_rfoot=feet[1].expand(S, 3).clone(),
            current_root_y=zeros(S),
            last_root_pos=zeros(S, 3))

    def init_online_state(self, dtype: torch.dtype = torch.float32
                          ) -> OnlineState:
        """Fresh state of one stream (reference: net.py:58-64 and the
        reset at net.py:84): the batched state's fields without the
        stream axis, the velocity carry kept as [2, 1, 256]."""
        st = self.init_online_state_batched(1, dtype)
        return OnlineState(
            imu=st.imu[0], initialized=st.initialized[0],
            vel_h=st.vel_h, vel_c=st.vel_c,
            last_lfoot=st.last_lfoot[0], last_rfoot=st.last_rfoot[0],
            current_root_y=st.current_root_y[0],
            last_root_pos=st.last_root_pos[0])

    def forward_online(self, params, state: OnlineState,
                       frame: torch.Tensor):
        """One streaming step of one stream (reference: net.py:174-219).

        frame [60]. Returns ((pose [24,3,3], joints [24,3], root [3],
        contact [2]), new_state): an S = 1 adapter over
        `forward_online_batched`, the one implementation of the fusion.
        """
        bstate = OnlineState(
            imu=state.imu[None], initialized=state.initialized.reshape(1),
            vel_h=state.vel_h, vel_c=state.vel_c,
            last_lfoot=state.last_lfoot[None],
            last_rfoot=state.last_rfoot[None],
            current_root_y=state.current_root_y.reshape(1),
            last_root_pos=state.last_root_pos[None])
        (pose, joints, root, contact), nb = self.forward_online_batched(
            params, bstate, frame[None])
        new_state = OnlineState(
            imu=nb.imu[0], initialized=nb.initialized[0],
            vel_h=nb.vel_h, vel_c=nb.vel_c,
            last_lfoot=nb.last_lfoot[0], last_rfoot=nb.last_rfoot[0],
            current_root_y=nb.current_root_y[0],
            last_root_pos=nb.last_root_pos[0])
        return (pose[0], joints[0], root[0], contact[0]), new_state

    def forward_online_sequence(self, params, state: OnlineState,
                                frames: torch.Tensor):
        """One stream over frames [N, 60]: N successive `forward_online`
        calls (the JAX package's `lax.scan`). Returns ((pose
        [N,24,3,3], joints [N,24,3], root [N,3], contact [N,2]),
        final_state)."""
        if frames.device != self.device:
            raise ValueError(f"frames are on {frames.device}, the net on "
                             f"{self.device}")
        outs = []
        for frame in frames:
            out, state = self.forward_online(params, state, frame)
            outs.append(out)
        pose, joints, root, contact = (torch.stack(o) for o in zip(*outs))
        return (pose, joints, root, contact), state

    # -- carry-mode streaming (opt-in approximation; models/streaming.py) --
    def init_carry_state_batched(self, n_streams: int,
                                 dtype: torch.dtype = torch.float32):
        """Fresh state for carry-mode streaming: forward LSTM states
        carried across frames, backward directions recomputed over the
        5-frame lookahead tail only; see `models/streaming.py`."""
        from mobileposer_tpu_torch.models.streaming import \
            init_carry_state_batched
        return init_carry_state_batched(self, n_streams, dtype)

    def forward_carry_batched(self, params, state, frames: torch.Tensor):
        """One carry-mode step for S streams. frames [S, 60]."""
        from mobileposer_tpu_torch.models.streaming import \
            forward_carry_batched
        return forward_carry_batched(self, params, state, frames)

    def forward_carry_sequence_batched(self, params, state,
                                       frames: torch.Tensor):
        """Carry-mode streaming over [N, S, 60] frames."""
        from mobileposer_tpu_torch.models.streaming import \
            forward_carry_sequence_batched
        return forward_carry_sequence_batched(self, params, state, frames)

    def _fusion_step(self, joints, contact, vel_emit, last_lfoot, last_rfoot,
                     current_root_y, last_root_pos):
        """One frame of the streaming translation fusion for S streams
        (reference net.py:186-208), shared by both sequence modes.

        joints [S,24,3], contact [S,2] logits, vel_emit [S,72].
        Returns (velocity [S,3], v_y [S], lfoot [S,3], rfoot [S,3]).
        """
        with span("mp.fusion"):
            lfoot, rfoot = joints[:, 10], joints[:, 11]
            contact_vel = torch.where(
                (contact[:, 0] > contact[:, 1])[:, None],
                last_lfoot - lfoot, last_rfoot - rfoot) + self._gravity
            root_vel = (vel_emit.reshape(-1, 24, 3)[:, 0]
                        / VEL_SCALE_PER_FRAME)
            cmax = contact.max(dim=1).values
            weight = prob_to_weight(
                torch.sigmoid(cmax) if self.online_sigmoid else cmax)[:, None]
            velocity = R.lerp(root_vel, contact_vel, weight)

            current_foot_y = current_root_y + torch.minimum(lfoot[:, 1],
                                                            rfoot[:, 1])
            v_y = torch.where(
                current_foot_y + velocity[:, 1] <= self.floor_y,
                self.floor_y - current_foot_y, velocity[:, 1])
            velocity = torch.cat(
                [velocity[:, :1], v_y[:, None], velocity[:, 2:]], dim=1)
            # velocity and v_y are float32 already (the float32 state
            # promotes them); bf16 joints give bf16 feet, cast to the
            # float32 anchors
            if lfoot.dtype != last_lfoot.dtype:
                lfoot = lfoot.to(last_lfoot.dtype)
                rfoot = rfoot.to(last_rfoot.dtype)
            return velocity, v_y, lfoot, rfoot

    def forward_online_batched(self, params, state: OnlineState,
                               frames: torch.Tensor):
        """One streaming step for S streams at once. frames: [S, 60].

        Returns ((pose [S,24,3,3], joints [S,24,3], root [S,3],
        contact [S,2]), new_state). A fresh stream's window is its first
        frame repeated 45 times (reference net.py:175).
        """
        S = frames.shape[0]
        slid = torch.cat([state.imu[:, 1:], frames[:, None]], dim=1)
        fresh = frames[:, None].expand(S, NUM_TOTAL, frames.shape[1])
        window = torch.where(state.initialized[:, None, None], slid, fresh)

        pose_t, joints_seq, vel, contact_seq, vel_hc = forward(
            params, window, self.body_model,
            vel_h0c0=(state.vel_h, state.vel_c), pose_index=NUM_PAST)

        joints = joints_seq[:, NUM_PAST].reshape(S, 24, 3)
        contact = contact_seq[:, NUM_PAST]

        velocity, v_y, lfoot, rfoot = self._fusion_step(
            joints, contact, vel[:, NUM_PAST], state.last_lfoot,
            state.last_rfoot, state.current_root_y, state.last_root_pos)

        new_state = OnlineState(
            imu=window,
            initialized=torch.ones((S,), dtype=torch.bool,
                                   device=frames.device),
            vel_h=vel_hc[0], vel_c=vel_hc[1],
            last_lfoot=lfoot, last_rfoot=rfoot,
            current_root_y=state.current_root_y + v_y,
            last_root_pos=state.last_root_pos + velocity)
        return (pose_t, joints, new_state.last_root_pos, contact), new_state

    def forward_online_sequence_batched(self, params, state: OnlineState,
                                        frames: torch.Tensor,
                                        mode: str = "auto",
                                        chunk: int = 25,
                                        backend: str = "auto"):
        """S streams x N frames. frames: [N, S, 60].

        Returns ((pose [N,S,24,3,3], joints [N,S,24,3], root [N,S,3],
        contact [N,S,2]), final_state). Both modes compute the same
        outputs; 'auto' picks by stream count (UNFOLD_MAX_STREAMS).

        mode='scan' replays the per-frame step N times, the reference's
        own control flow (net.py:174-178).

        mode='unfolded' materializes the sliding windows of `chunk` frames
        at a time and runs the three bidirectional modules over them as
        one batch of chunk*S windows (their windows are independent: fresh
        h0 per window). Only the velocity module's cross-window carry and
        the fusion run frame by frame.

        backend: 'auto' or 'fused'; both run the same layer kernels here,
        as in the JAX package (the multicell kernel is `forward`'s alone).
        """
        check_backend(backend, allow_train=False)
        if frames.device != self.device:
            raise ValueError(f"frames are on {frames.device}, the net on "
                             f"{self.device}")
        if mode == "auto":
            mode = ("unfolded" if frames.shape[1] < self.UNFOLD_MAX_STREAMS
                    else "scan")
        if mode == "scan":
            outs = []
            for frame in frames:
                out, state = self.forward_online_batched(params, state, frame)
                outs.append(out)
            pose, joints, root, contact = (torch.stack(o) for o in zip(*outs))
            return (pose, joints, root, contact), state
        if mode != "unfolded":
            raise ValueError(f"unknown streaming mode {mode!r}")
        return self._forward_online_sequence_unfolded(params, state, frames,
                                                      chunk)

    def _forward_online_sequence_unfolded(self, params, state: OnlineState,
                                          frames: torch.Tensor, chunk: int):
        N, S, D = frames.shape
        W, E = NUM_TOTAL, NUM_PAST
        K = min(chunk, N)

        # stream-major frame history: 44 frames of context before frame 0
        # (the previous window's tail, or frame 0 repeated for a fresh
        # stream — reference net.py:175), then the N frames.
        frames_sm = frames.transpose(0, 1)                  # [S, N, D]
        prefix = torch.where(state.initialized[:, None, None],
                             state.imu[:, 1:],
                             frames_sm[:, :1].expand(S, W - 1, D))
        full = torch.cat([prefix, frames_sm], dim=1)        # [S, 44+N, D]

        vel_h, vel_c = state.vel_h, state.vel_c
        lf, rf = state.last_lfoot, state.last_rfoot
        root_y, root_pos = state.current_root_y, state.last_root_pos
        poses, joints_out, roots, contacts = [], [], [], []
        # The JAX package pads N to a multiple of `chunk` (lax.scan needs
        # one static shape) and masks the padded frames; here the last
        # chunk simply runs at its own size, so no frame is computed and
        # discarded and no carry needs freezing.
        for start in range(0, N, K):
            k_n = min(K, N - start)
            seg = full[:, start:start + k_n + W - 1]        # [S, k_n+44, D]
            # windows time-major, frames*streams as batch (index k*S + s)
            x_tm = seg.unfold(1, W, 1).permute(3, 1, 0, 2).reshape(
                W, k_n * S, D)
            joints_tm, _ = module_apply("joints", params["joints"], x_tm,
                                        time_major=True)
            x132_tm = torch.cat([joints_tm, x_tm], dim=-1)
            r6d_tm, _ = module_apply("poser", params["poser"], x132_tm,
                                     time_major=True)
            contact_tm, _ = module_apply("footcontact", params["footcontact"],
                                         x132_tm, time_major=True)
            poses.append(reduced_global_to_full_soa(
                r6d_tm[E], self.body_model).reshape(k_n, S, 24, 3, 3))
            joints_e = joints_tm[E].reshape(k_n, S, 24, 3)
            contact_e = contact_tm[E].reshape(k_n, S, 2)
            joints_out.append(joints_e)
            contacts.append(contact_e)

            # velocity: the one module whose LSTM carry crosses windows
            # (reference velocity.py:45-48), then the fusion, frame by frame
            x132_w = x132_tm.reshape(W, k_n, S, x132_tm.shape[-1])
            for k in range(k_n):
                y_tm, (vel_h, vel_c) = module_apply(
                    "velocity", params["velocity"], x132_w[:, k],
                    h0c0=(vel_h, vel_c), time_major=True)
                velocity, v_y, lf, rf = self._fusion_step(
                    joints_e[k], contact_e[k], y_tm[E], lf, rf, root_y,
                    root_pos)
                root_y = root_y + v_y
                root_pos = root_pos + velocity
                roots.append(root_pos)

        new_state = OnlineState(
            imu=full[:, N - 1:N - 1 + W],
            initialized=torch.ones((S,), dtype=torch.bool,
                                   device=frames.device),
            vel_h=vel_h, vel_c=vel_c,
            last_lfoot=lf, last_rfoot=rf,
            current_root_y=root_y, last_root_pos=root_pos)
        return ((torch.cat(poses), torch.cat(joints_out), torch.stack(roots),
                 torch.cat(contacts)), new_state)
