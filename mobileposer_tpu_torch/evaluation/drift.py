"""Stream-age drift characterization for the streaming modes (counterpart
of `mobileposer_tpu/evaluation/drift.py`).

Carry-mode streaming (`models/streaming.py`) never resets its forward
LSTM states, so its divergence from the exact windowed semantics
(reference net.py:174-219) could grow with stream age. This module
measures accuracy as a function of stream age: it streams S independent
synthetic motions through a streaming mode window by window with the
state carried across windows, and computes per-window SIP (masked global
angle error, deg) and root-aligned joint position error (cm) against
ground truth on the device; only two [S] vectors a window leave it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R

_MASK = np.asarray(C.EVAL_JOINT_MASK)          # joint indices


def make_stream_motion(rng: np.random.Generator, n_frames: int,
                       n_streams: int, theta: float = 0.01,
                       pose_std: float = 0.35
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth stationary random motions for S independent streams: a
    mean-reverting (Ornstein-Uhlenbeck) walk of every joint's axis-angle
    around the neutral pose (stationary at ~pose_std rad, ~1/theta-frame
    correlation time), so a window at frame 10^5 is statistically a
    window at frame 10^3, and an OU velocity integrated to the root
    position. The same numpy draws, in the same order, as the JAX
    package's.

    Returns (aa [N, S, 24, 3] axis-angle local pose, tran [N, S, 3]) as
    float32 numpy.
    """
    sigma = pose_std * np.sqrt(2 * theta - theta * theta)
    noise = rng.normal(0.0, sigma, (n_frames, n_streams, 24, 3))
    aa = np.zeros((n_frames, n_streams, 24, 3), np.float32)
    x = rng.normal(0.0, pose_std, (n_streams, 24, 3))       # stationary init
    for t in range(n_frames):
        x = (1.0 - theta) * x + noise[t]
        aa[t] = x
    vel_noise = rng.normal(0.0, 0.01 * np.sqrt(2 * theta),
                           (n_frames, n_streams, 3))
    tran = np.zeros((n_frames, n_streams, 3), np.float32)
    v = np.zeros((n_streams, 3))
    pos = np.zeros((n_streams, 3))
    for t in range(n_frames):
        v = (1.0 - theta) * v + vel_noise[t]
        pos = pos + v
        tran[t] = pos
    return aa, tran


def synthesize_stream_frames(body_model, aa: np.ndarray, tran: np.ndarray,
                             combo: str = "lw_rp", chunk: int = 2048,
                             device=None) -> torch.Tensor:
    """Virtual-IMU model inputs [N, S, 60] for the ground-truth motions,
    on `device` (the CUDA card unless given).

    Runs the synthesis pipeline (`data/synthesis.py`: FK, skinning, the
    acceleration stencil) per stream in chunks with 8 frames of overlap,
    so the stencil sees continuous context at chunk joins; chunks keep
    their natural lengths. Inputs are masked and flattened as the dataset
    does (acc / acc_scale, the combo's zero mask, [acc15 | ori45]).
    """
    from mobileposer_tpu_torch.data.dataset import COMBO_MASKS, COMBO_NAMES
    from mobileposer_tpu_torch.data.synthesis import synthesize_virtual_imu

    device = resolve_device(device)
    mask = torch.as_tensor(COMBO_MASKS[COMBO_NAMES.index(combo)],
                           device=device)
    pad = 8
    N, S = aa.shape[:2]

    def synth_chunk(aa_c, tran_c):
        """[T, 24, 3] axis-angle -> [T, 60] masked imu features."""
        pose = R.axis_angle_to_rotation_matrix(
            aa_c.reshape(-1, 3)).reshape(-1, 24, 3, 3)
        out = synthesize_virtual_imu(body_model, pose, tran=tran_c)
        acc = out["vacc"][:, :5] / C.amass.acc_scale
        ori = out["vrot"][:, :5]
        a = acc * mask[None, :, None]
        o = ori * mask[None, :, None, None]
        return torch.cat([a.reshape(-1, 15), o.reshape(-1, 45)], dim=1)

    frames = torch.zeros((N, S, 60), dtype=torch.float32, device=device)
    for s in range(S):
        for t0 in range(0, N, chunk):
            lo = max(t0 - pad, 0)
            hi = min(t0 + chunk + pad, N)
            f = synth_chunk(torch.as_tensor(aa[lo:hi, s], device=device),
                            torch.as_tensor(tran[lo:hi, s], device=device))
            inner0 = t0 - lo
            frames[t0:min(t0 + chunk, N), s] = f[
                inner0:inner0 + min(chunk, N - t0)]
    return frames


def make_window_stepper(net, params, mode: str):
    """(state, frames_w [W,S,60], aa_w [W,S,24,3]) -> (state, sip_deg
    [S], pos_cm [S], tran_p [W,S,3]), on the net's device.

    Streams one window with the carried state and computes the windowed
    metrics against ground truth: SIP = geodesic global-rotation error at
    the EVAL_JOINT_MASK joints (deg, reference evaluate.py:18), pos =
    root-aligned joint position error over all 24 joints (cm). The
    predicted root trajectory is returned too, for the 1-7 m
    translation-drift windows.
    """
    if mode == "exact":
        run = net.forward_online_sequence_batched
    elif mode == "carry":
        run = net.forward_carry_sequence_batched
    else:
        raise ValueError(f"unknown mode {mode!r}")
    body = net.body_model
    mask = torch.as_tensor(_MASK, device=net.device)

    def step(state, frames_w, aa_w):
        (pose, _, tran_p, _), state = run(params, state, frames_w)
        W, S = frames_w.shape[:2]
        gt_pose = R.axis_angle_to_rotation_matrix(
            aa_w.reshape(-1, 3)).reshape(W * S, 24, 3, 3)
        gt_g, gt_j = body.forward_kinematics(gt_pose)
        pr_g, pr_j = body.forward_kinematics(pose.reshape(W * S, 24, 3, 3))
        # geodesic angle per masked joint
        m = torch.einsum("njab,njac->njbc", gt_g[:, mask], pr_g[:, mask])
        tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
        ang = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0,
                                                     -1.0, 1.0)))
        sip = ang.reshape(W, S, -1).mean(dim=(0, 2))
        # root-aligned positional error, cm
        off = gt_j[:, :1] - pr_j[:, :1]
        pe = torch.linalg.norm(pr_j + off - gt_j, dim=-1) * 100.0
        pos = pe.reshape(W, S, 24).mean(dim=(0, 2))
        return state, sip, pos, tran_p

    return step


def windowed_stream_metrics(net, params, frames: torch.Tensor,
                            aa: np.ndarray, mode: str, window: int,
                            dtype: torch.dtype = torch.float32,
                            tran_gt: Optional[np.ndarray] = None) -> dict:
    """Stream [N,S,60] frames through `mode` in N // window windows with
    the state carried across windows; returns per-window metric curves.

    Returns {"sip_deg": [n_windows, S], "pos_cm": [n_windows, S]} numpy;
    with `tran_gt` ([N, S, 3] ground-truth root trajectory) it adds the
    reference's 1-7 m translation-drift windows (evaluate.py:66-92 via
    `pose_eval.translation_drift`) per stream-age window: "tran_drift_m"
    [n_windows, S], each window's mean normalized drift over the window
    sizes, and "tran_drift_per_w", each size's [n_windows] stream-mean
    curve.
    """
    N, S = frames.shape[:2]
    n_windows = N // window
    if mode == "exact":
        state = net.init_online_state_batched(S, dtype=dtype)
    else:
        state = net.init_carry_state_batched(S, dtype=dtype)
    step = make_window_stepper(net, params, mode)
    sips, poss, trans = [], [], []
    with torch.no_grad():
        for w in range(n_windows):
            sl = slice(w * window, (w + 1) * window)
            state, sip, pos, tran_p = step(
                state, frames[sl], torch.as_tensor(aa[sl], device=net.device))
            sips.append(sip)
            poss.append(pos)
            if tran_gt is not None:
                trans.append(tran_p)
    # one copy to the host for the whole curve
    out = {"sip_deg": torch.stack(sips).cpu().numpy(),
           "pos_cm": torch.stack(poss).cpu().numpy()}
    if tran_gt is not None:
        from mobileposer_tpu_torch.evaluation.pose_eval import \
            translation_drift
        trans = torch.stack(trans).float().cpu().numpy()
        w_sizes = range(1, 8)
        drift = np.full((n_windows, S), np.nan, np.float32)
        per_w = {w: np.full(n_windows, np.nan, np.float32) for w in w_sizes}
        for wi in range(n_windows):
            sl = slice(wi * window, (wi + 1) * window)
            per_w_acc = {w: [] for w in w_sizes}
            for s in range(S):
                d = translation_drift(trans[wi][:, s], tran_gt[sl][:, s],
                                      window_sizes=w_sizes)
                if d:
                    drift[wi, s] = float(np.mean(list(d.values())))
                for w, v in d.items():
                    per_w_acc[w].append(v)
            for w in w_sizes:
                if per_w_acc[w]:
                    per_w[w][wi] = float(np.mean(per_w_acc[w]))
        out["tran_drift_m"] = drift
        out["tran_drift_per_w"] = per_w
    return out
