"""Deterministic synthetic training data (counterpart of
`mobileposer_tpu/data/fixtures.py`).

The reference's datasets and SMPL file are not shipped, so the tests, the
card check and the training smoke path run on synthetic motions: smooth
random pose trajectories pushed through the virtual-IMU synthesis
(`data/synthesis.py`) over the synthetic SMPL body. The output uses the
reference's processed-dataset schema (`process.py:113-121`), so the
training fold reads it as it reads real data. Draws come from a numpy
`default_rng` in the JAX package's order, so both packages write the same
poses and translations from the same seed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mobileposer_tpu_torch.data.synthesis import synthesize_virtual_imu
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel


def smooth_random_pose(rng: np.random.Generator, T: int,
                       step_std: float = 0.02) -> np.ndarray:
    """[T, 24, 3, 3] local rotations from integrated small random twists."""
    increments = rng.normal(0.0, step_std, (T, 24, 3)).astype(np.float32)
    aa = np.cumsum(increments, axis=0)
    rot = R.axis_angle_to_rotation_matrix(torch.from_numpy(aa.reshape(-1, 3)))
    return rot.numpy().reshape(T, 24, 3, 3)


def synthetic_sequence(body_model: ParametricModel, rng: np.random.Generator,
                       T: int = 200, device="cpu") -> dict:
    """One synthetic processed sequence in the reference .pt schema,
    synthesized on `device`."""
    pose = smooth_random_pose(rng, T)
    tran = np.cumsum(rng.normal(0, 0.01, (T, 3)), axis=0).astype(np.float32)
    syn = synthesize_virtual_imu(body_model,
                                 torch.from_numpy(pose).to(device),
                                 tran=torch.from_numpy(tran).to(device))
    return {"pose": pose, "tran": tran,
            "joint": syn["joint"].cpu().numpy(),
            "acc": syn["vacc"].cpu().numpy(),
            "ori": syn["vrot"].cpu().numpy(),
            "contact": syn["contact"].cpu().numpy()}


def make_synthetic_processed_dataset(
        path, n_sequences: int = 3, T: int = 200, seed: int = 0,
        body_model: Optional[ParametricModel] = None, device="cpu") -> Path:
    """Write a synthetic processed dataset file (.pt, or .npz)."""
    body_model = body_model or ParametricModel.synthetic(num_vertices=240)
    rng = np.random.default_rng(seed)
    seqs = [synthetic_sequence(body_model, rng, T, device)
            for _ in range(n_sequences)]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".npz":
        np.savez(path, sequences=np.asarray(seqs, dtype=object))
        return path
    data = {key: [torch.from_numpy(np.array(s[key])) for s in seqs]
            for key in ("pose", "tran", "joint", "acc", "ori", "contact")}
    torch.save(data, path)
    return path
