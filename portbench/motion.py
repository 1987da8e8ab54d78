"""The one generator of inputs: every traffic mix is a data file of
parameters (`traffic/<name>.json`) that this module reads.

Frames are a smooth seeded motion in the model's 60-float IMU layout,
[5 x 3 accelerations | 5 x 9 rotation matrices], each of the 5 device
slots turning and shaking at its own low frequencies; each sequence wears
one of the reference's device combinations (the traffic file's `combos`),
its absent devices zero, as the reference feeds them. Training batches
pair such windows with seeded targets. Everything is drawn on `device`
from generators seeded by `seed`, so the same seed gives the same inputs.
"""

from __future__ import annotations

import math

import torch

N_SLOTS = 5


def generator(seed: int, purpose: int, device) -> torch.Generator:
    """A generator on `device` for one purpose of one seed. Seeds are any
    non-negative whole number; distinct purposes draw distinct streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + purpose) % (2 ** 63))
    return g


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    theta = aa.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    k = aa / theta
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                    dim=-1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1 - c) * (K @ K)


def motion_frames(traffic: dict, seed: int, purpose: int, n_frames: int,
                  n_seq: int, device) -> torch.Tensor:
    """[n_frames, n_seq, 60] float32 frames: n_seq independent smooth
    motions sampled at 30 Hz, each masked by a combination drawn from the
    seed."""
    p = traffic["motion"]
    g = generator(seed, purpose, device)
    shape = (n_seq, N_SLOTS, 3)
    rot_amp = _uniform(g, shape, *p["rot_amp"], device)
    rot_f = _uniform(g, shape, *p["freq_hz"], device)
    rot_ph = _uniform(g, shape, 0.0, 2 * math.pi, device)
    rot0 = _uniform(g, shape, -math.pi, math.pi, device)
    acc_amp = _uniform(g, shape, *p["acc_amp"], device)
    acc_f = _uniform(g, shape, *p["freq_hz"], device)
    acc_ph = _uniform(g, shape, 0.0, 2 * math.pi, device)
    offset = _uniform(g, (n_seq, 1, 1), 0.0, 1000.0, device)
    combos = traffic["combos"]
    pick = torch.randint(len(combos), (n_seq,), generator=g, device=device)
    masks = torch.zeros((len(combos), N_SLOTS), device=device)
    for i, slots in enumerate(combos):
        masks[i, list(slots)] = 1.0
    mask = masks[pick]                                          # [n_seq, 5]

    t = (torch.arange(n_frames, device=device, dtype=torch.float32)
         / 30.0)[:, None, None, None] + offset                   # [F,S,1,1]
    aa = rot0 + rot_amp * torch.sin(2 * math.pi * rot_f * t + rot_ph)
    acc = acc_amp * torch.sin(2 * math.pi * acc_f * t + acc_ph)
    ori = _rodrigues(aa)                                        # [F,S,5,3,3]
    acc = acc * mask[:, :, None]
    ori = ori * mask[:, :, None, None]
    return torch.cat([acc.reshape(n_frames, n_seq, 15),
                      ori.reshape(n_frames, n_seq, 45)], dim=-1).contiguous()


def stream_table(traffic: dict, seed: int, device) -> torch.Tensor:
    """The stream mix's frames, [period_ticks, streams, 60] float32 on
    `device`: tick t sends row t % period_ticks."""
    return motion_frames(traffic, seed, 0, traffic["period_ticks"],
                         traffic["streams"], device)


def train_pool(traffic: dict, seed: int, device) -> list:
    """The train mix's pool of `pool` batches on `device`, each a dict of
    the data pipeline's float32 arrays, batch-major: imu [B, T, 60],
    joints [B, T, 72], pose_r6d [B, T, 24, 6], vels [B, T, 72], tran
    [B, T, 3], contacts [B, T, 2] and lengths [B] (every window full)."""
    B, T, n = traffic["batch"], traffic["window"], traffic["pool"]
    q = traffic["targets"]
    imu = motion_frames(traffic, seed, 1, T, n * B, device)
    imu = imu.transpose(0, 1).reshape(n, B, T, 60)
    g = generator(seed, 2, device)

    def randn(*shape, std):
        return std * torch.randn((n,) + shape, generator=g, device=device)
    joints = randn(B, T, 72, std=q["joints_std"])
    r6d = randn(B, T, 24, 6, std=q["r6d_std"])
    vels = randn(B, T, 72, std=q["vels_std"])
    tran = randn(B, T, 3, std=q["tran_std"])
    contacts = (torch.rand((n, B, T, 2), generator=g, device=device)
                < q["contact_p"]).float()
    lengths = torch.full((B,), T, dtype=torch.int64, device=device)
    return [{"imu": imu[i].contiguous(), "joints": joints[i],
             "pose_r6d": r6d[i], "vels": vels[i], "tran": tran[i],
             "contacts": contacts[i], "lengths": lengths}
            for i in range(n)]
