"""The four MobilePoser estimation modules and their training losses
(counterpart of `mobileposer_tpu/models/modules.py`).

Each module is an RNN block (`nn/lstm.py`). The configs are the
reference's layer sizes (joints.py:29, poser.py:32, footcontact.py:28,
velocity.py:29); the losses follow joints.py:54-75, poser.py:65-103,
footcontact.py:43-72 and velocity.py:51-86 as the JAX package writes them,
with an optional `lengths` that masks the padding of ragged windows.

Random draws. The JAX package draws the input noise and the dropout masks
inside each loss from one key (`fold_in(rng, k)`); torch cannot reproduce
those numbers. So each loss here is two parts: `draw` takes the noise and
the dropout keep mask from a `torch.Generator`, and the `*_loss` function
is deterministic given those draws. The parity tests feed the JAX
package's own draws to the deterministic part. As in the JAX package, the
joint-input noise is added whether or not `train` is set; dropout applies
only when it is.

Data parallelism. Under the trainer's 'gspmd' rule each process holds
some rows of a global batch, and its losses must add up, over the
processes, to the loss of the whole batch. So every loss takes
`count_lengths`, the whole batch's lengths: the numerators sum this
process's rows, the normalizers count the whole batch's valid entries
(and its rows, for the batch means). `draw(..., rows=)` draws the whole
batch's noise and masks and keeps this process's rows.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.nn.lstm import (LSTMConfig, RNNBlock,
                                           draw_dropout_keep, rnn_apply)

N_IMU = C.model_config.n_imu                     # 60
N_JOINTS_OUT = C.model_config.n_output_joints    # 24
N_REDUCED = C.joint_set.n_reduced                # 16

MODULE_CONFIGS: Dict[str, LSTMConfig] = {
    # IMU(60) -> 24x3 joint positions
    "joints": LSTMConfig(N_IMU, N_JOINTS_OUT * 3, 256),
    # [joints(72) | IMU(60)] -> 16 reduced joints x r6d
    "poser": LSTMConfig(N_JOINTS_OUT * 3 + N_IMU, N_REDUCED * 6, 256),
    # [joints | IMU](132) -> 2 foot-contact logits
    "footcontact": LSTMConfig(N_JOINTS_OUT * 3 + N_IMU, 2, 64),
    # [joints | IMU](132) -> 24x3 per-joint velocity; streaming (uni) LSTM
    "velocity": LSTMConfig(N_JOINTS_OUT * 3 + N_IMU, N_JOINTS_OUT * 3, 256,
                           bidirectional=False),
}

# Gaussian-noise std of the joint-input augmentation (reference:
# poser.py:80, footcontact.py:57 use 0.04; velocity.py:64 0.025).
NOISE_STD = {"poser": 0.04, "footcontact": 0.04, "velocity": 0.025}

T_WEIGHT = 1e-5  # temporal-loss weight (reference: joints.py:33, poser.py:36)


def init_all_modules(generator: Optional[torch.Generator] = None,
                     device=None,
                     dtype: torch.dtype = torch.float32) -> nn.ModuleDict:
    """Random weights for the four modules on `device` (the CUDA card
    unless given) in `dtype` (float32 or bfloat16, as the JAX
    `init_all_modules(key, dtype)`), drawn from `generator` so a seed
    fixes them. The JAX package draws other numbers from the same seed:
    tests that compare the two carry weights over with
    `nn.convert.params_from_jax`. The losses below train either: on bf16
    params a float32 batch is promoted as JAX promotes it."""
    device = resolve_device(device)
    return nn.ModuleDict({name: RNNBlock(cfg, device=device,
                                         generator=generator, dtype=dtype)
                          for name, cfg in MODULE_CONFIGS.items()})


def module_apply(name: str, params: RNNBlock, x: torch.Tensor,
                 lengths=None, h0c0=None, backend: str = "auto",
                 time_major: bool = False, train: bool = False,
                 dropout_keep=None):
    """Run one module's RNN block. Returns (y, (h_T, c_T))."""
    return rnn_apply(params, MODULE_CONFIGS[name], x, lengths, h0c0,
                     backend=backend, time_major=time_major, train=train,
                     dropout_keep=dropout_keep)


# ---------------------------------------------------------------------------
# Loss helpers
# ---------------------------------------------------------------------------

def _length_mask(x: torch.Tensor, lengths,
                 time_major: bool = False) -> Optional[torch.Tensor]:
    """Validity mask matching x's layout ([B, T, 1] or [T, B, 1]), or None
    when lengths is None. `lengths` is always [B]."""
    if lengths is None:
        return None
    if time_major:
        T = x.shape[0]
        m = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
    else:
        T = x.shape[1]
        m = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    return m.to(x.dtype)[..., None]


def _count_mask(x: torch.Tensor, lengths, count_lengths, time_major: bool):
    """The mask the normalizer counts: of `count_lengths` (the whole
    batch's, under data parallelism) when given, else of `lengths`."""
    return _length_mask(x, lengths if count_lengths is None
                        else count_lengths, time_major)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, lengths=None,
               time_major: bool = False,
               count_lengths=None) -> torch.Tensor:
    """MSE over valid positions (reference: plain nn.MSELoss)."""
    err = (pred - target) ** 2
    m = _length_mask(pred, lengths, time_major)
    if m is None:
        return torch.mean(err)
    cm = _count_mask(pred, lengths, count_lengths, time_major)
    # a fully padded (sub)batch yields loss 0, not 0/0
    return torch.sum(err * m) / torch.clamp_min(
        torch.sum(cm) * err.shape[-1], 1.0)


def temporal_smoothness_loss(pred: torch.Tensor, order: int = 2,
                             lengths=None, time_major: bool = False,
                             count_lengths=None) -> torch.Tensor:
    """L1 norm of the `order`-th finite time difference, summed over time,
    averaged over the batch (reference: joints.py:71-75 for order=2, the
    "temporal" loss; poser.py:100-103 for order=3, the "jerk" loss)."""
    t_ax = 0 if time_major else 1
    d = torch.diff(pred, n=order, dim=t_ax)
    l1 = torch.sum(torch.abs(d), dim=2)       # [B, T-order] or [T-order, B]
    if lengths is not None:
        T = pred.shape[t_ax]
        idx = torch.arange(T - order, device=pred.device) + order
        valid = (idx[:, None] < lengths[None, :] if time_major
                 else idx[None, :] < lengths[:, None])
        l1 = l1 * valid.to(l1.dtype)
    if count_lengths is not None:
        # the mean over the whole batch's rows
        return torch.sum(l1) / count_lengths.shape[0]
    return torch.mean(torch.sum(l1, dim=t_ax))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    lengths=None, time_major: bool = False,
                    count_lengths=None) -> torch.Tensor:
    """Binary cross-entropy on logits (reference: footcontact.py loss),
    the explicit formula of the JAX package."""
    per = (torch.maximum(logits, logits.new_zeros(())) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    m = _length_mask(logits, lengths, time_major)
    if m is None:
        return torch.mean(per)
    cm = _count_mask(logits, lengths, count_lengths, time_major)
    return torch.sum(per * m) / torch.clamp_min(
        torch.sum(cm) * per.shape[-1], 1.0)


def multiscale_velocity_loss(pred: torch.Tensor, target: torch.Tensor,
                             lengths=None, time_major: bool = False,
                             count_lengths=None) -> torch.Tensor:
    """Sum of per-chunk MSEs over chunk sizes n in {1, 3, 9}
    (reference: velocity.py:74-86): for chunk size n, T // n chunks (the
    partial tail chunk is dropped), each the mean over its valid (batch,
    frame, feature) entries; the chunk means are summed over the chunks
    and the three scales."""
    total = 0.0
    if time_major:
        T, B, D = pred.shape
    else:
        B, T, D = pred.shape
    err = (pred - target) ** 2
    m = _length_mask(pred, lengths, time_major)
    if m is not None:
        err = err * m
        m = _count_mask(pred, lengths, count_lengths, time_major)
    Bc = B if m is None else m.shape[1 if time_major else 0]
    for n in (1, 3, 9):
        n_chunks = T // n
        if time_major:
            e = err[:n_chunks * n].reshape(n_chunks, n, B, D)
            sum_dims = (1, 2, 3)
            mm = (None if m is None
                  else m[:n_chunks * n].reshape(n_chunks, n, Bc, 1))
        else:
            e = err[:, :n_chunks * n].reshape(B, n_chunks, n, D)
            sum_dims = (0, 2, 3)
            mm = (None if m is None
                  else m[:, :n_chunks * n].reshape(Bc, n_chunks, n, 1))
        if mm is None:
            counts = torch.full((n_chunks,), float(B * n * D),
                                dtype=err.dtype, device=err.device)
        else:
            counts = mm.sum(dim=sum_dims) * D
        chunk_mean = e.sum(dim=sum_dims) / torch.clamp_min(counts, 1.0)
        total = total + torch.sum(chunk_mean)
    return total


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------

class Draws(NamedTuple):
    """The random inputs of one module's loss: `noise`, standard normal
    of the joint targets' shape (scaled by NOISE_STD inside the loss; None
    for joints, which adds no noise), and `keep`, the dropout keep mask of
    the hidden activation (None unless training)."""
    noise: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]


def draw(name: str, batch: dict, generator: torch.Generator,
         train: bool = True, rows=None) -> Draws:
    """Draw one module's loss randomness from `generator`: the noise
    first, then the dropout mask. The batch layout (batch- or time-major)
    sets the shapes. The draws are made on the generator's device and
    land on the batch's (the trainer keeps both on the card; a CPU
    generator gives the same draws to a run on the card and one on the
    CPU).

    rows=(start, total): the batch (batch-major) is rows start.. of a
    batch of `total` rows; the draws are the whole batch's, of which this
    batch's rows are kept, so every process of a data-parallel step draws
    what one process would draw for the whole batch."""
    cfg = MODULE_CONFIGS[name]
    device = batch["imu"].device
    B = batch["imu"].shape[0]
    start, total = (0, B) if rows is None else rows

    def whole(shape):
        return (total,) + tuple(shape[1:])
    noise = None
    if name in NOISE_STD:
        noise = torch.randn(whole(batch["joints"].shape), generator=generator,
                            device=generator.device)[start:start + B]
        noise = noise.to(device)
    keep = None
    if train and cfg.dropout > 0.0:
        keep = draw_dropout_keep(
            cfg, whole(tuple(batch["imu"].shape[:2]) + (cfg.n_hidden,)),
            generator)[start:start + B].to(device)
    return Draws(noise, keep)


# ---------------------------------------------------------------------------
# Per-module training losses (deterministic given the draws)
# ---------------------------------------------------------------------------

def joints_loss(params, batch, draws: Draws, train: bool = True,
                backend: str = "auto_train", time_major: bool = False,
                count_lengths=None):
    """MSE + 1e-5 * 2nd-diff temporal L1 (reference: joints.py:54-75)."""
    imu, lengths = batch["imu"], batch.get("lengths")
    pred, _ = module_apply("joints", params, imu, lengths, backend=backend,
                           time_major=time_major, train=train,
                           dropout_keep=draws.keep)
    tgt = batch["joints"].reshape(pred.shape)
    return (masked_mse(pred, tgt, lengths, time_major, count_lengths)
            + T_WEIGHT * temporal_smoothness_loss(pred, 2, lengths,
                                                  time_major, count_lengths))


def poser_loss(params, batch, draws: Draws, body_model=None,
               train: bool = True, backend: str = "auto_train",
               time_major: bool = False, count_lengths=None):
    """r6d MSE + 1e-5 * jerk L1 + FK joint-position MSE
    (reference: poser.py:65-98). `body_model` enables the position loss."""
    imu, lengths = batch["imu"], batch.get("lengths")
    target_pose = batch["pose_r6d"]          # [B, T, 24, 6] full r6d
    target_joints = batch["joints"]          # [B, T, 72]
    A0, A1 = imu.shape[:2]                   # [T, B] when time_major
    noise = draws.noise * NOISE_STD["poser"]
    noisy = target_joints.reshape(A0, A1, -1) + noise.reshape(A0, A1, -1)
    x = torch.cat([noisy, imu], dim=-1)
    pred, _ = module_apply("poser", params, x, lengths, backend=backend,
                           time_major=time_major, train=train,
                           dropout_keep=draws.keep)
    tgt = target_pose.reshape(A0, A1, 24, 6)[:, :, list(C.joint_set.reduced)]
    tgt = tgt.reshape(A0, A1, -1)
    loss = masked_mse(pred, tgt, lengths, time_major, count_lengths)
    loss = loss + T_WEIGHT * temporal_smoothness_loss(pred, 3, lengths,
                                                      time_major,
                                                      count_lengths)
    if body_model is not None:
        # positions straight from the predicted global rotations through
        # the bone basis (net.joint_positions_from_r6d_soa)
        from mobileposer_tpu_torch.models.net import \
            joint_positions_from_r6d_soa
        joints_p = joint_positions_from_r6d_soa(pred.reshape(A0 * A1, -1),
                                                body_model)
        joints_p = joints_p.reshape(A0, A1, -1)
        loss = loss + masked_mse(joints_p, target_joints.reshape(A0, A1, -1),
                                 lengths, time_major, count_lengths)
    return loss


def footcontact_loss(params, batch, draws: Draws, train: bool = True,
                     backend: str = "auto_train", time_major: bool = False,
                     count_lengths=None):
    """BCE-with-logits on [L, R] contact (reference: footcontact.py:43-72)."""
    imu, lengths = batch["imu"], batch.get("lengths")
    target_joints = batch["joints"].reshape(imu.shape[0], imu.shape[1], -1)
    noise = draws.noise.reshape(target_joints.shape) * NOISE_STD["footcontact"]
    x = torch.cat([target_joints + noise, imu], dim=-1)
    pred, _ = module_apply("footcontact", params, x, lengths,
                           backend=backend, time_major=time_major,
                           train=train, dropout_keep=draws.keep)
    return bce_with_logits(pred, batch["contacts"].reshape(pred.shape),
                           lengths, time_major, count_lengths)


def velocity_loss(params, batch, draws: Draws, train: bool = True,
                  backend: str = "auto_train", time_major: bool = False,
                  count_lengths=None):
    """Multi-scale chunked MSE (reference: velocity.py:51-86)."""
    imu, lengths = batch["imu"], batch.get("lengths")
    target_joints = batch["joints"].reshape(imu.shape[0], imu.shape[1], -1)
    target_vel = batch["vels"].reshape(imu.shape[0], imu.shape[1], -1)
    noise = draws.noise.reshape(target_joints.shape) * NOISE_STD["velocity"]
    x = torch.cat([target_joints + noise, imu], dim=-1)
    pred, _ = module_apply("velocity", params, x, lengths, backend=backend,
                           time_major=time_major, train=train,
                           dropout_keep=draws.keep)
    return multiscale_velocity_loss(pred, target_vel, lengths, time_major,
                                    count_lengths)


LOSSES = {"joints": joints_loss, "poser": poser_loss,
          "footcontact": footcontact_loss, "velocity": velocity_loss}
