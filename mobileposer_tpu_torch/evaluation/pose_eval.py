"""Pose evaluation on PyTorch (counterpart of
`mobileposer_tpu/evaluation/pose_eval.py`): the 8-row metric report, the
offline and ONLINE protocols and the translation-drift windows.

Behavioral parity target: reference `mobileposer/evaluate.py:16-107`.
The reference prints `errs[9]` for both "SIP Error" and "Masked Angular
Error" (a latent defect, SURVEY §2); both rows are kept so printouts
align.

Offline, sequences are grouped by their 512-frame bucket, padded with
their last frame to the bucket and run as one ragged batch per group
(`lengths`), so every LSTM layer runs the masked CUDA kernels at T = 512
(1024, ...). The JAX package also pads each group's batch to a power of
two so that jit compiles few programs; eager PyTorch needs no such
padding, so a group runs at its own size. ONLINE, each sequence is one
stream of the exact streaming path (`forward_online_sequence_batched`,
the full-length kernels), or with `online_mode='carry'` of carry-mode
streaming (`forward_carry_sequence_batched`, no LSTM kernel); a group's
streams run to the group's longest sequence rather than to the bucket,
since an output at frame t depends only on frames up to t in both modes.

`bf16=True` casts the params to bfloat16 and runs both protocols in bf16
(frames and state; the offline groups through the masked kernels' bf16
entries); the metrics are computed in float32 on the cast-back outputs,
as in the JAX package. On quantized params (int8 on bf16 params, as
`cli.evaluate --int8 --bf16` makes them) the cast leaves the int8 tensors
and their scales alone and casts `b` and the linears, and the layers run
the int8 kernels' bf16 entries: the masked #5 offline, #4 and #6 ONLINE.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.evaluation.evaluator import FullMotionEvaluator
from mobileposer_tpu_torch.models.net import MobilePoserNet, _fuse_velocity, forward
from mobileposer_tpu_torch.nn.convert import cast_params

_IGNORED = np.asarray(C.joint_set.ignored)
_BUCKET = 512

METRIC_NAMES = (
    "SIP Error (deg)", "Angular Error (deg)", "Masked Angular Error (deg)",
    "Positional Error (cm)", "Masked Positional Error (cm)",
    "Mesh Error (cm)", "Jitter Error (100m/s^3)", "Distance Error (cm)")


class PoseEvaluator:
    """8-row error report (reference: evaluate.py:16-36)."""

    def __init__(self, body_model=None, device=None):
        self._eval_fn = FullMotionEvaluator(
            body_model, joint_mask=C.EVAL_JOINT_MASK, fps=C.datasets.fps,
            device=device)

    def eval(self, pose_p, pose_t, tran_p=None, tran_t=None) -> np.ndarray:
        # identity at the ignored joints, on copies of both poses
        pose_p = np.array(pose_p, np.float32).reshape(-1, 24, 3, 3)
        pose_t = np.array(pose_t, np.float32).reshape(-1, 24, 3, 3)
        pose_p[:, _IGNORED] = np.eye(3, dtype=np.float32)
        pose_t[:, _IGNORED] = np.eye(3, dtype=np.float32)
        errs = self._eval_fn(pose_p, pose_t, tran_p=tran_p, tran_t=tran_t)
        return np.stack([errs[9], errs[3], errs[9], errs[0] * 100,
                         errs[7] * 100, errs[1] * 100, errs[4] / 100, errs[6]])

    @staticmethod
    def print(errors: np.ndarray) -> None:
        for i, name in enumerate(METRIC_NAMES):
            print("%s: %.2f (+/- %.2f)" % (name, errors[i, 0], errors[i, 1]))


def translation_drift(tran_p: np.ndarray, tran_t: np.ndarray,
                      window_sizes: Sequence[int] = range(1, 8)
                      ) -> Dict[int, float]:
    """Mean translation error over windows where GT travels `w` meters
    (reference: evaluate.py:66-92). Returns {window_m: mean_err_m} for
    windows that occurred."""
    tran_p = np.asarray(tran_p).reshape(-1, 3)
    tran_t = np.asarray(tran_t).reshape(-1, 3)
    move = np.zeros(len(tran_t))
    move[1:] = np.cumsum(np.linalg.norm(tran_t[1:] - tran_t[:-1], axis=1))
    out = {}
    for w in window_sizes:
        frame_pairs = []
        start, end = 0, 1
        while end < len(move):
            if move[end] - move[start] < w:
                end += 1
            else:
                if not frame_pairs or frame_pairs[-1][1] != end:
                    frame_pairs.append((start, end))
                start += 1
        errs = [np.linalg.norm((tran_t[e] - tran_t[s]) - (tran_p[e] - tran_p[s]))
                / (move[e] - move[s]) * w for s, e in frame_pairs]
        if errs:
            out[w] = float(np.mean(errs))
    return out


def forward_offline_batched(net: MobilePoserNet, params,
                            imu_batch: torch.Tensor, lengths: torch.Tensor):
    """Offline inference over several padded sequences at once.

    imu_batch [N, T_pad, 60], lengths [N]. Returns (pose [N,T,24,3,3],
    joints [N,T,24,3], tran [N,T,3], contact [N,T,2]); entries beyond each
    sequence's length are meaningless, to be sliced off. The translation
    fusion runs on all N sequences at once.
    """
    pose, joints, vel, contact, _ = forward(
        params, imu_batch, net.body_model, lengths=lengths)
    N, T = imu_batch.shape[:2]
    joints = joints.reshape(N, T, 24, 3)
    tran = _fuse_velocity(joints, vel, contact, net.floor_y)
    return pose, joints, tran, contact


def _pad_to_bucket(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad [n, ...] to n_pad frames by repeating the last frame, which
    keeps rotations valid (evaluator.py:41-47 of the JAX package)."""
    pad = n_pad - x.shape[0]
    if pad == 0:
        return np.asarray(x)
    return np.concatenate([np.asarray(x),
                           np.repeat(np.asarray(x[-1:]), pad, axis=0)])


def _bucket_len(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _groups(ns: Sequence[int], bucket: int, max_batch: int):
    """Chunks of at most max_batch sequence indices with the same padded
    bucket length, shortest bucket first: [(bucket_len, [i, ...]), ...]."""
    groups: Dict[int, List[int]] = {}
    for i, n in enumerate(ns):
        groups.setdefault(_bucket_len(n, bucket), []).append(i)
    return [(P, idxs[c0:c0 + max_batch])
            for P, idxs in sorted(groups.items())
            for c0 in range(0, len(idxs), max_batch)]


def _predict_offline_batched(net, params, imus, bucket, max_batch,
                             dtype=torch.float32):
    """Offline predictions for a list of [T_i, 60] sequences, one ragged
    batch per bucket group, the IMU in `dtype`. Returns [(pose
    [T_i,24,3,3], tran [T_i,3]) float32, ...] in the order of `imus`."""
    ns = [x.shape[0] for x in imus]
    out: List = [None] * len(imus)
    for P, chunk in _groups(ns, bucket, max_batch):
        batch = np.stack([_pad_to_bucket(imus[i], P) for i in chunk])
        lengths = torch.as_tensor([ns[i] for i in chunk])
        pose, _, tran, _ = forward_offline_batched(
            net, params, torch.as_tensor(batch, device=net.device).to(dtype),
            lengths)
        pose, tran = pose.float().cpu().numpy(), tran.float().cpu().numpy()
        for k, i in enumerate(chunk):
            out[i] = (pose[k, :ns[i]], tran[k, :ns[i]])
    return out


def _predict_online_batched(net, params, imus, num_future_frames, bucket,
                            max_batch, mode: str = "exact",
                            dtype=torch.float32):
    """ONLINE-protocol predictions for a list of sequences, batched as
    independent streams with fresh state (reference protocol:
    evaluate.py:62-64, per-frame streaming with `num_future_frames` of
    last-frame padding). Each sequence is padded with its last frame to
    its group's longest sequence; outputs at frame t depend only on frames
    up to t, so the padding cannot reach the sliced-off prefix.

    mode='carry' runs the same protocol through carry-mode streaming,
    whose emission timing is the exact path's, so the metrics measure
    the approximation's accuracy cost. Frames and state in `dtype`;
    outputs returned as float32."""
    if mode == "carry":
        init_state = net.init_carry_state_batched
        run = net.forward_carry_sequence_batched
    else:
        init_state = net.init_online_state_batched
        run = net.forward_online_sequence_batched
    ns = [x.shape[0] + num_future_frames for x in imus]
    out: List = [None] * len(imus)
    for _, chunk in _groups(ns, bucket, max_batch):
        n_max = max(ns[i] for i in chunk)
        frames = np.stack([_pad_to_bucket(imus[i], n_max) for i in chunk],
                          axis=1)                          # [n_max, S, 60]
        (poses, _, trans, _), _ = run(
            params, init_state(len(chunk), dtype),
            torch.as_tensor(frames, device=net.device).to(dtype))
        poses, trans = poses.float().cpu().numpy(), trans.float().cpu().numpy()
        for k, i in enumerate(chunk):
            out[i] = (poses[num_future_frames:ns[i], k],
                      trans[num_future_frames:ns[i], k])
    return out


def _check_scope(online_mode: str, bf16: bool, batch_sequences: bool,
                 mesh) -> None:
    if online_mode not in ("exact", "carry"):
        # an unknown mode must not fall back to the exact path
        raise ValueError(f"online_mode must be 'exact' or 'carry', "
                         f"got {online_mode!r}")
    if bf16 and not batch_sequences:
        raise ValueError("bf16=True requires batch_sequences=True")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel evaluation is not ported (ROADMAP.md queue A "
            "item 16)")


def evaluate_pose(net: MobilePoserNet, params, dataset,
                  online: bool = False, evaluate_tran: bool = False,
                  num_future_frames: int = C.model_config.future_frames,
                  verbose: bool = True, batch_sequences: bool = True,
                  max_batch: int = 64, online_mode: str = "exact",
                  bf16: bool = False, mesh=None):
    """Offline (and optionally online) evaluation over a sequence dataset
    (reference: evaluate.py:39-107), on the net's device.

    dataset yields (imu [T,60], pose_local [T,24,3,3], joints, tran [T,3]).
    Returns a dict with 'offline' [8,2], optional 'online' [8,2] and
    'tran_errors' {window: mean}.

    batch_sequences=True (default) groups sequences by padded length and
    runs both protocols batched. False runs the offline pass one sequence
    at a time through `forward_offline(length=n)` and the ONLINE protocol
    as a single stream per sequence (same numbers; the tests' oracle).

    online_mode: 'exact' (the reference's window semantics) or 'carry'
    (the carry-mode approximation, `models/streaming.py`; requires
    batch_sequences=True, as in the JAX package).

    bf16=True (requires batch_sequences=True, as in the JAX package)
    casts the params to bfloat16 (`nn.convert.cast_params`) and runs both
    protocols with bf16 frames and state; the metric math stays float32
    on the cast-back outputs.
    """
    _check_scope(online_mode, bf16, batch_sequences, mesh)
    if online_mode != "exact" and not batch_sequences:
        raise ValueError("online_mode='carry' requires batch_sequences=True")
    evaluator = PoseEvaluator(net.body_model, device=net.device)
    offline_errs, online_errs = [], []
    tran_errors: Dict[int, List[float]] = {w: [] for w in range(1, 8)}

    items = list(dataset)
    imus = [np.asarray(item[0], np.float32) for item in items]
    none = [None] * len(items)

    if batch_sequences:
        dtype = torch.float32
        if bf16:
            params = cast_params(params, torch.bfloat16)
            dtype = torch.bfloat16
        offline_preds = _predict_offline_batched(net, params, imus, _BUCKET,
                                                 max_batch, dtype)
        online_preds = (_predict_online_batched(net, params, imus,
                                                num_future_frames, _BUCKET,
                                                max_batch, online_mode, dtype)
                        if online else none)
    else:
        offline_preds = []
        for imu in imus:
            n = imu.shape[0]
            pose_p, _, tran_p, _ = net.forward_offline(
                params, torch.as_tensor(
                    _pad_to_bucket(imu, _bucket_len(n, _BUCKET)),
                    device=net.device), length=n)
            offline_preds.append((pose_p[:n].cpu().numpy(),
                                  tran_p[:n].cpu().numpy()))
        online_preds = ([_predict_online_batched(
            net, params, [imu], num_future_frames, _BUCKET, 1)[0]
            for imu in imus] if online else none)

    for item, off_p, on_p in zip(items, offline_preds, online_preds):
        pose_t, tran_t = item[1], item[3]

        if online:
            pose_po, tran_po = on_p
            online_errs.append(evaluator.eval(pose_po, pose_t,
                                              tran_p=tran_po, tran_t=tran_t))

        pose_p, tran_p = off_p

        if evaluate_tran:
            for w, err in translation_drift(tran_p, tran_t).items():
                tran_errors[w].append(err)

        offline_errs.append(evaluator.eval(pose_p, pose_t,
                                           tran_p=tran_p, tran_t=tran_t))

    result = {}
    if offline_errs:
        result["offline"] = np.mean(np.stack(offline_errs), axis=0)
        if verbose:
            print("============== offline ================")
            PoseEvaluator.print(result["offline"])
    if online_errs:
        result["online"] = np.mean(np.stack(online_errs), axis=0)
        if verbose:
            print("============== online ================")
            PoseEvaluator.print(result["online"])
    if evaluate_tran:
        result["tran_errors"] = {w: float(np.mean(v))
                                 for w, v in tran_errors.items() if v}
        if verbose:
            print("translation drift:", result["tran_errors"])
    return result
