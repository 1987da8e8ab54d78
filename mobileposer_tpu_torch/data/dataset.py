"""Windowed, combo-masked pose datasets for training and evaluation
(counterpart of `mobileposer_tpu/data/dataset.py`).

Behavioral parity target: reference `mobileposer/data.py` (PoseDataset).
Reads the reference's processed files (`.pt` dicts of per-sequence tensor
lists: acc/ori/pose/tran[/joint/contact], process.py:113-121, or the JAX
package's `.npz` layout) and runs FK for the ground-truth joints on the
dataset's device.

  * fold='train': 125-frame windows x all 12 device combos. A sample is
    (window, combo); the combo's zero mask is applied when a batch is
    assembled, so the stored arrays exist once. Batches are fixed-shape
    [B, W, ...] numpy arrays with explicit `lengths`, assembled by fancy
    indexing into one zero-padded monolith (`_assemble`), bit for bit as
    the JAX package assembles them.
  * fold='test': whole sequences, served with a combo mask by
    `EvalSequence`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel

COMBO_NAMES = list(C.COMBOS.keys())

# [n_combos, 5] 0/1 mask over the 5 IMU slots (reference: data.py:71-74).
COMBO_MASKS = np.zeros((len(C.COMBOS), 5), np.float32)
for _i, _slots in enumerate(C.COMBOS.values()):
    COMBO_MASKS[_i, list(_slots)] = 1.0

_FK_CHUNK = 1024  # frames per FK call, so memory stays bounded


def _chunked_fk(body_model: ParametricModel, pose: np.ndarray, device):
    """FK over [N, 24, 3, 3] local poses in chunks of _FK_CHUNK frames on
    `device`. Returns (global rotations [N,24,3,3], joints [N,24,3]) as
    numpy."""
    grots, joints = [], []
    for i in range(0, pose.shape[0], _FK_CHUNK):
        g, j = body_model.forward_kinematics(
            torch.as_tensor(pose[i:i + _FK_CHUNK], device=device))
        grots.append(g.cpu().numpy())
        joints.append(j.cpu().numpy())
    return np.concatenate(grots), np.concatenate(joints)


def load_processed_file(path) -> List[Dict[str, np.ndarray]]:
    """Load one processed dataset file into per-sequence numpy dicts."""
    path = Path(path)
    if path.suffix == ".npz":
        # the JAX package's layout stores the sequence dicts as an object
        # array, which only unpickling reads: load only files this
        # system wrote
        with np.load(path, allow_pickle=True) as z:
            if "sequences" in z:
                return z["sequences"].tolist()
        raise ValueError(f"unrecognized npz layout: {path}")
    # .pt: dict of lists of tensors (plain containers, no pickled code)
    data = torch.load(path, map_location="cpu", weights_only=True)
    out = []
    for i in range(len(data["acc"])):
        seq = {}
        for key in ("acc", "ori", "pose", "tran", "joint", "contact"):
            if key in data and i < len(data[key]) and data[key][i] is not None:
                seq[key] = np.asarray(data[key][i])
        out.append(seq)
    return out


class PoseDataset:
    """Sequences -> windows x combos (reference: data.py:18-110).

    fold: 'train' (125-frame windows, all 12 combos) or 'test' (whole
    sequences). evaluate/finetune select the file set like the reference
    (_get_data_files, data.py:29-43); data_files overrides the file list.
    FK runs on `device`, the CUDA card unless given.
    """

    def __init__(self, fold: str = "train", evaluate: Optional[str] = None,
                 finetune: Optional[str] = None,
                 body_model: Optional[ParametricModel] = None,
                 data_files: Optional[Sequence] = None,
                 combos: Optional[Sequence[str]] = None, device=None):
        if fold not in ("train", "test"):
            raise ValueError(f"Unknown data fold: {fold}")
        self.fold = fold
        self.evaluate = evaluate
        self.finetune = finetune
        self.device = resolve_device(device)
        self.body_model = body_model or ParametricModel.from_file_or_synthetic(
            C.paths.smpl_file)
        self.combo_names = list(combos) if combos else COMBO_NAMES
        self.combo_masks = np.stack(
            [COMBO_MASKS[COMBO_NAMES.index(name)] for name in self.combo_names])
        if data_files is None:
            data_files = self._default_files()
        self.windows: List[Dict[str, np.ndarray]] = []
        for f in data_files:
            try:
                seqs = load_processed_file(f)
            except Exception as e:  # corrupt file: skip (reference data.py:50-54)
                print(f"Error processing {f}: {e}.")
                continue
            for seq in seqs:
                self._add_sequence(seq)

    def _default_files(self) -> List[Path]:
        """File selection (reference: data.py:29-47): every file of the
        processed folder for training, the finetune set's file, or the
        test file of `evaluate`."""
        folder = C.paths.processed_datasets
        if self.finetune or self.evaluate:
            folder = C.paths.eval_dir
        if self.fold == "train":
            if self.finetune:
                return [folder / C.datasets.finetune_datasets[self.finetune]]
            if not folder.exists():
                return []
            return [p for p in folder.iterdir() if p.is_file()]
        return [folder / C.datasets.test_datasets[self.evaluate]]

    def _add_sequence(self, seq: Dict[str, np.ndarray]) -> None:
        """Per-sequence processing (reference: data.py:57-92)."""
        acc = np.asarray(seq["acc"], np.float32)[:, :5] / C.amass.acc_scale
        ori = np.asarray(seq["ori"], np.float32)[:, :5]
        pose = np.asarray(seq["pose"], np.float32).reshape(-1, 24, 3, 3)
        tran = np.asarray(seq["tran"], np.float32).reshape(-1, 3)
        T = pose.shape[0]

        pose_global, joint = _chunked_fk(self.body_model, pose, self.device)
        # training targets use the global pose; evaluation keeps local
        # (reference: data.py:66-67)
        target_pose = pose if self.evaluate else pose_global
        pose_r6d = R.rotation_matrix_to_r6d(
            torch.from_numpy(target_pose)).numpy().reshape(T, 24, 6)

        # translation-stage targets (reference: data.py:87-92)
        root_vel = np.concatenate([np.zeros((1, 3), np.float32),
                                   tran[1:] - tran[:-1]])
        vel = np.concatenate([np.zeros((1, 24, 3), np.float32),
                              np.diff(joint, axis=0)])
        vel[:, 0] = root_vel
        vel = vel * (C.datasets.fps / C.amass.vel_scale)
        contact = (np.asarray(seq["contact"], np.float32)
                   if "contact" in seq else None)

        W = T if self.evaluate else C.datasets.window_length
        for t0 in range(0, T, W):
            sl = slice(t0, min(t0 + W, T))
            self.windows.append({
                "acc": acc[sl], "ori": ori[sl],
                "pose_r6d": pose_r6d[sl], "pose_local": pose[sl],
                "joints": joint[sl].reshape(-1, 72),
                "tran": tran[sl], "vels": vel[sl].reshape(-1, 72),
                "contacts": (contact[sl] if contact is not None else
                             np.zeros((sl.stop - sl.start, 2), np.float32)),
            })

    # -- batching (numpy only, as the JAX package batches) -----------------
    def __len__(self) -> int:
        return len(self.windows) * len(self.combo_names)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        """One (window, combo) sample with the combo mask applied and the
        IMU features flattened to 60 dims (reference: data.py:69-99)."""
        w = self.windows[idx // len(self.combo_names)]
        mask = self.combo_masks[idx % len(self.combo_names)]
        return dict(w, imu=_mask_and_flatten(w["acc"], w["ori"], mask))

    def batches(self, batch_size: int, rng: np.random.Generator,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled fixed-shape batches with explicit lengths."""
        order = rng.permutation(len(self))
        W = max(w["acc"].shape[0] for w in self.windows)
        for b0 in range(0, len(order) - (batch_size - 1 if drop_remainder
                                         else 0), batch_size):
            yield self._assemble(order[b0:b0 + batch_size], W)

    def _build_monolith(self, W: int) -> None:
        """Stack all windows into zero-padded arrays once, so batch
        assembly is fancy indexing. The per-window dicts are then replaced
        by views into the monolith rows, which releases the per-sequence
        arrays they were cut from (`pose_local` is kept only when
        evaluating; the swap is skipped if W would truncate a window)."""
        n = len(self.windows)
        self._mono = {
            "acc": np.zeros((n, W, 5, 3), np.float32),
            "ori": np.zeros((n, W, 5, 3, 3), np.float32),
            "pose_r6d": np.zeros((n, W, 24, 6), np.float32),
            "joints": np.zeros((n, W, 72), np.float32),
            "tran": np.zeros((n, W, 3), np.float32),
            "vels": np.zeros((n, W, 72), np.float32),
            "contacts": np.zeros((n, W, 2), np.float32),
        }
        self._mono_lengths = np.zeros((n,), np.int32)
        for i, w in enumerate(self.windows):
            L = min(w["acc"].shape[0], W)
            self._mono_lengths[i] = L
            for k in self._mono:
                self._mono[k][i, :L] = w[k][:L]
        self._mono_W = W
        if all(w["acc"].shape[0] <= W for w in self.windows):
            for i, w in enumerate(self.windows):
                L = int(self._mono_lengths[i])
                slim = {k: self._mono[k][i, :L] for k in self._mono}
                if self.evaluate:
                    slim["pose_local"] = w["pose_local"]
                self.windows[i] = slim

    def _assemble(self, idxs, W: int) -> Dict[str, np.ndarray]:
        """The batch of samples `idxs` padded to W frames: imu [B, W, 60]
        (combo-masked acc | ori), the targets, and lengths [B] (int32)."""
        if getattr(self, "_mono_W", None) != W:
            self._build_monolith(W)
        idxs = np.asarray(idxs)
        win = idxs // len(self.combo_names)
        combo = idxs % len(self.combo_names)
        mask = self.combo_masks[combo]                       # [B, 5]
        acc = self._mono["acc"][win] * mask[:, None, :, None]
        ori = self._mono["ori"][win] * mask[:, None, :, None, None]
        B = len(idxs)
        imu = np.concatenate([acc.reshape(B, W, 15),
                              ori.reshape(B, W, 45)], axis=2)
        out = {k: self._mono[k][win]
               for k in ("pose_r6d", "joints", "tran", "vels", "contacts")}
        out["imu"] = imu
        out["lengths"] = self._mono_lengths[win]
        return out


def _mask_and_flatten(acc: np.ndarray, ori: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
    """Apply a 5-slot combo mask and flatten to the 60-dim IMU feature
    [acc(15) | ori(45)] (reference: data.py:69-76)."""
    T = acc.shape[0]
    a = acc * mask[None, :, None]
    o = ori * mask[None, :, None, None]
    return np.concatenate([a.reshape(T, -1), o.reshape(T, -1)], axis=1)


def make_combo_imu(acc: torch.Tensor, ori: torch.Tensor,
                   combo_mask: torch.Tensor) -> torch.Tensor:
    """The combo masking on tensors, for pipelines on the device
    (dataset.py:273-283 of the JAX package): acc [.., 5, 3], ori
    [.., 5, 3, 3], combo_mask [5] (or [.., 5]) -> [.., 60]."""
    a = acc * combo_mask[..., :, None]
    o = ori * combo_mask[..., :, None, None]
    lead = acc.shape[:-2]
    return torch.cat([a.reshape(lead + (15,)), o.reshape(lead + (45,))],
                     dim=-1)


class EvalSequence:
    """Whole-sequence eval view: (imu60 for a combo, local pose, joints,
    tran)."""

    def __init__(self, dataset: PoseDataset, combo: str = "lw_rp"):
        self.ds = dataset
        self.mask = COMBO_MASKS[COMBO_NAMES.index(combo)]

    def __len__(self):
        return len(self.ds.windows)

    def __getitem__(self, i: int):
        w = self.ds.windows[i]
        imu = _mask_and_flatten(w["acc"], w["ori"], self.mask)
        return imu, w["pose_local"], w["joints"].reshape(-1, 24, 3), w["tran"]
