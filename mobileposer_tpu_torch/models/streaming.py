"""Carry-mode streaming on PyTorch (counterpart of
`mobileposer_tpu/models/streaming.py`): O(lookahead) work per frame
instead of O(window).

The exact path re-runs the whole 45-frame window through all four
modules for every emitted frame (reference net.py:174-178). Carry mode is
the JAX package's documented approximation of those semantics (opt-in;
exact stays the default):

  * FORWARD LSTM directions carry their state across the stream and are
    never reset: each new frame costs one forward step per layer.
  * BACKWARD directions reach the emitted frame only through the window
    tail: the emit index is 40 of 45, so the backward state there has
    consumed exactly the last 5 frames from a zero init. Carry mode
    recomputes that 5-step tail per frame (this half is exact).
  * Tail positions after the emit index feed downstream layers with
    PROVISIONAL values (the lookahead available so far); committed
    forward carries only consume the emit position.
  * Velocity consumes each frame once with a continuously carried state.

Outputs at step t correspond to input frame t-4, as on the exact path;
warm-up fills the rings with the first frame. The fusion on top of the
module outputs is `MobilePoserNet._fusion_step`, shared with the exact
path.

No Pallas kernel runs here in the JAX package, and none runs here: every
step is a few batched matmuls (`nn.lstm.lstm_cell_step`, or its W8A8
route `ops.quant.lstm_cell_step_int8` when w_ih is int8) and elementwise
ops, cuBLAS on the card. The JAX `lax.scan` over frames is a Python loop.
On bf16 params with a bf16 state every step runs in bf16, carries
included, as the JAX package's cell step does; the fusion state stays
float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
from mobileposer_tpu_torch.models.net import (NUM_PAST, NUM_TOTAL,
                                              reduced_global_to_full_soa)
from mobileposer_tpu_torch.nn.lstm import lstm_cell_step as lstm_step

LOOKAHEAD = NUM_TOTAL - NUM_PAST          # 5 tail positions (emit + 4 future)


def _bwd_tail(p, x_tail: torch.Tensor) -> torch.Tensor:
    """Backward direction over the L-frame tail from a zero init: exactly
    the backward state the windowed path has at the emit position.
    x_tail [L, S, D] -> outputs [L, S, H]."""
    L, S = x_tail.shape[:2]
    H = p.w_hh.shape[0]
    h = c = x_tail.new_zeros((S, H))
    outs = [None] * L
    for i in reversed(range(L)):
        h, c = lstm_step(p, x_tail[i], h, c)
        outs[i] = h
    return torch.stack(outs)


def _fwd_prov(p, x_rest: torch.Tensor, h, c) -> torch.Tensor:
    """Provisional forward steps over the tail positions after the emit
    (x_rest [L-1, S, D]); the committed carry is not advanced."""
    outs = []
    for i in range(x_rest.shape[0]):
        h, c = lstm_step(p, x_rest[i], h, c)
        outs.append(h)
    return torch.stack(outs)


class BiCarry(NamedTuple):
    """Forward-direction carries of one 2-layer biLSTM block."""
    f1_h: torch.Tensor
    f1_c: torch.Tensor
    f2_h: torch.Tensor
    f2_c: torch.Tensor


class JointsCarry(NamedTuple):
    """Joints block: raw inputs are final on arrival, so layer-1 forward
    commits on the newest frame and rings hold the committed tail."""
    x1_ring: torch.Tensor      # [L, S, H] relu(linear1(imu)) tail
    f1_ring: torch.Tensor      # [L, S, H] committed fwd-1 outputs tail
    f1_h: torch.Tensor
    f1_c: torch.Tensor
    f2_h: torch.Tensor
    f2_c: torch.Tensor


def _gated(ini: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where the stream is initialized, else zeros (a fresh carry)."""
    return torch.where(ini, x, x.new_zeros(()))


def _push(ini: torch.Tensor, ring: torch.Tensor, x: torch.Tensor):
    """Slide x into the ring's newest slot; a fresh stream's ring is x
    repeated, as if the stream had always been at its first frame."""
    return torch.where(ini, torch.cat([ring[1:], x[None]]),
                       x.expand(ring.shape))


def joints_carry_step(params, st: JointsCarry, imu_t: torch.Tensor,
                      initialized: torch.Tensor):
    """One frame through the joints block (an `RNNBlock`). imu_t [S, 60].

    Returns (joints_tail [L, S, 72], emit first, then the provisional
    lookahead positions, and the new carry)."""
    l1, l2 = params.lstm
    x1_t = torch.relu(params.linear1(imu_t))
    ini = initialized[:, None]

    x1_ring = _push(ini, st.x1_ring, x1_t)
    h1, c1 = lstm_step(l1["fwd"], x1_t, _gated(ini, st.f1_h),
                       _gated(ini, st.f1_c))
    f1_ring = _push(ini, st.f1_ring, h1)

    b1_tail = _bwd_tail(l1["bwd"], x1_ring)
    x2_tail = torch.cat([f1_ring, b1_tail], dim=-1)           # [L, S, 2H]

    h2, c2 = lstm_step(l2["fwd"], x2_tail[0], _gated(ini, st.f2_h),
                       _gated(ini, st.f2_c))
    f2_tail = torch.cat([h2[None], _fwd_prov(l2["fwd"], x2_tail[1:], h2, c2)])
    b2_tail = _bwd_tail(l2["bwd"], x2_tail)
    y_tail = params.linear2(torch.cat([f2_tail, b2_tail], dim=-1))
    return y_tail, JointsCarry(x1_ring, f1_ring, h1, c1, h2, c2)


def bi_carry_step(params, st: BiCarry, x_tail: torch.Tensor,
                  initialized: torch.Tensor):
    """One frame through a downstream biLSTM block (poser / footcontact)
    whose inputs after the emit position are provisional. x_tail
    [L, S, D], emit position first. Returns (y_emit [S, out], new carry)."""
    l1, l2 = params.lstm
    ini = initialized[:, None]
    x1_tail = torch.relu(params.linear1(x_tail))

    h1, c1 = lstm_step(l1["fwd"], x1_tail[0], _gated(ini, st.f1_h),
                       _gated(ini, st.f1_c))
    f1_tail = torch.cat([h1[None], _fwd_prov(l1["fwd"], x1_tail[1:], h1, c1)])
    b1_tail = _bwd_tail(l1["bwd"], x1_tail)
    x2_tail = torch.cat([f1_tail, b1_tail], dim=-1)

    h2, c2 = lstm_step(l2["fwd"], x2_tail[0], _gated(ini, st.f2_h),
                       _gated(ini, st.f2_c))
    b2 = _bwd_tail(l2["bwd"], x2_tail)[0]
    y_emit = params.linear2(torch.cat([h2, b2], dim=-1))
    return y_emit, BiCarry(h1, c1, h2, c2)


def velocity_carry_step(params, h: torch.Tensor, c: torch.Tensor,
                        x_emit: torch.Tensor, initialized: torch.Tensor):
    """Velocity block: unidirectional, consumes the emit-position input
    once per frame with a continuously carried state (the training-time
    data flow). x_emit [S, 132], h/c [2, S, H]."""
    l1, l2 = params.lstm
    ini = initialized[:, None]
    xv = torch.relu(params.linear1(x_emit))
    h1, c1 = lstm_step(l1["fwd"], xv, _gated(ini, h[0]), _gated(ini, c[0]))
    h2, c2 = lstm_step(l2["fwd"], h1, _gated(ini, h[1]), _gated(ini, c[1]))
    y = params.linear2(h2)
    return y, torch.stack([h1, h2]), torch.stack([c1, c2])


class CarryState(NamedTuple):
    """Full streaming state for S carry-mode streams."""
    imu_ring: torch.Tensor      # [L, S, 60] raw frame tail (emit first)
    initialized: torch.Tensor   # [S] bool
    joints: JointsCarry
    poser: BiCarry
    footcontact: BiCarry
    vel_h: torch.Tensor         # [2, S, 256]
    vel_c: torch.Tensor
    last_lfoot: torch.Tensor    # [S, 3]
    last_rfoot: torch.Tensor
    current_root_y: torch.Tensor  # [S]
    last_root_pos: torch.Tensor   # [S, 3]


# Stream-axis index per field: rings and stacked LSTM carries keep the
# stream axis second, everything else leads with it.
CarryState.STREAM_AXES = CarryState(
    imu_ring=1, initialized=0,
    joints=JointsCarry(x1_ring=1, f1_ring=1, f1_h=0, f1_c=0,
                       f2_h=0, f2_c=0),
    poser=BiCarry(f1_h=0, f1_c=0, f2_h=0, f2_c=0),
    footcontact=BiCarry(f1_h=0, f1_c=0, f2_h=0, f2_c=0),
    vel_h=1, vel_c=1, last_lfoot=0, last_rfoot=0,
    current_root_y=0, last_root_pos=0)


def init_carry_state_batched(net, n_streams: int,
                             dtype: torch.dtype = torch.float32
                             ) -> CarryState:
    """Fresh carry-mode state for `n_streams` streams on the net's device:
    rings and LSTM carries in `dtype` (float32 or bfloat16), the fusion
    accumulators and foot anchors always float32, as in the JAX package
    (a bf16 translation accumulator would freeze past ~16 m)."""
    from mobileposer_tpu_torch.nn.lstm import check_dtype
    check_dtype(dtype)
    S, dev = n_streams, net.device
    Hv = MODULE_CONFIGS["velocity"].n_hidden
    Hj = MODULE_CONFIGS["joints"].n_hidden
    Hp = MODULE_CONFIGS["poser"].n_hidden
    Hf = MODULE_CONFIGS["footcontact"].n_hidden
    feet = torch.as_tensor(np.asarray(net.feet_pos, np.float32), device=dev)

    def z(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return CarryState(
        imu_ring=z(LOOKAHEAD, S, C.model_config.n_imu),
        initialized=torch.zeros((S,), dtype=torch.bool, device=dev),
        joints=JointsCarry(z(LOOKAHEAD, S, Hj), z(LOOKAHEAD, S, Hj),
                           z(S, Hj), z(S, Hj), z(S, Hj), z(S, Hj)),
        poser=BiCarry(z(S, Hp), z(S, Hp), z(S, Hp), z(S, Hp)),
        footcontact=BiCarry(z(S, Hf), z(S, Hf), z(S, Hf), z(S, Hf)),
        vel_h=z(2, S, Hv), vel_c=z(2, S, Hv),
        last_lfoot=feet[0].expand(S, 3).clone(),
        last_rfoot=feet[1].expand(S, 3).clone(),
        current_root_y=z(S, dtype=torch.float32),
        last_root_pos=z(S, 3, dtype=torch.float32))


def forward_carry_batched(net, params, state: CarryState,
                          frames: torch.Tensor):
    """One carry-mode step for S streams. frames [S, 60]. Returns
    ((pose [S,24,3,3], joints [S,24,3], root [S,3], contact [S,2]),
    new_state); outputs correspond to input frame t-4, as on the windowed
    path. `root` is the new state's `last_root_pos` itself."""
    S = frames.shape[0]
    ini = state.initialized[:, None]
    imu_ring = _push(ini, state.imu_ring, frames)

    joints_tail, jc = joints_carry_step(params["joints"], state.joints,
                                        frames, state.initialized)
    x132_tail = torch.cat([joints_tail, imu_ring], dim=-1)

    r6d_emit, pc = bi_carry_step(params["poser"], state.poser, x132_tail,
                                 state.initialized)
    contact, fc = bi_carry_step(params["footcontact"], state.footcontact,
                                x132_tail, state.initialized)
    vel_emit, vel_h, vel_c = velocity_carry_step(
        params["velocity"], state.vel_h, state.vel_c, x132_tail[0],
        state.initialized)

    pose = reduced_global_to_full_soa(r6d_emit, net.body_model)
    joints = joints_tail[0].reshape(S, 24, 3)

    velocity, v_y, lfoot, rfoot = net._fusion_step(
        joints, contact, vel_emit, state.last_lfoot, state.last_rfoot,
        state.current_root_y, state.last_root_pos)

    new_state = CarryState(
        imu_ring=imu_ring,
        initialized=torch.ones((S,), dtype=torch.bool, device=frames.device),
        joints=jc, poser=pc, footcontact=fc,
        vel_h=vel_h, vel_c=vel_c,
        last_lfoot=lfoot, last_rfoot=rfoot,
        current_root_y=state.current_root_y + v_y,
        last_root_pos=state.last_root_pos + velocity)
    return (pose, joints, new_state.last_root_pos, contact), new_state


def forward_carry_sequence_batched(net, params, state: CarryState,
                                   frames: torch.Tensor):
    """S streams x N frames. frames [N, S, 60]. Returns ((pose
    [N,S,24,3,3], joints [N,S,24,3], root [N,S,3], contact [N,S,2]),
    final_state)."""
    if frames.device != net.device:
        raise ValueError(f"frames are on {frames.device}, the net on "
                         f"{net.device}")
    outs = []
    for frame in frames:
        out, state = forward_carry_batched(net, params, state, frame)
        outs.append(out)
    pose, joints, root, contact = (torch.stack(o) for o in zip(*outs))
    return (pose, joints, root, contact), state
