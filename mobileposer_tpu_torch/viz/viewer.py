"""Offline visualization exports (counterpart of
`mobileposer_tpu/viz/viewer.py`; reference `example.py`, `viewer.py`,
`viewers/smpl_viewer.py`, `loader.py`).

The reference renders with open3d/vctoolkit/pygame; headless, the
equivalents are:

  * `MotionDump` — per-frame OBJ meshes (forward kinematics and skinning
    on the device), Unity pose/tran text, one `.npz` bundle, for any
    external viewer (Blender, Unity, open3d on a workstation);
  * `SMPLViewer.view` — the reference viewer's prediction-vs-GT semantics
    (smpl_viewer.py:23-43): the GT body offset on +x, optionally the
    prediction on the GT translation;
  * `SequenceLoader` — the viz-time model runner (reference
    loader.py:9-68): a sequence through `forward_offline` in one call or
    `forward_online` frame by frame, on the CUDA kernels #1 and #2.

Each runs on the CUDA card unless the caller names a device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel

# frames skinned per forward-kinematics call of `save_obj_sequence`
_MESH_CHUNK = 64


def _numpy(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class MotionDump:
    """Write predicted motion to viewer-consumable files."""

    def __init__(self, body_model: ParametricModel, out_dir="saved_motions",
                 device=None):
        self.body = body_model
        self.device = resolve_device(device)
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def save_npz(self, name: str, **arrays) -> Path:
        path = self.out_dir / f"{name}.npz"
        np.savez(path, **{k: _numpy(v) for k, v in arrays.items()})
        return path

    def save_unity(self, pose, tran) -> None:
        self.body.save_unity_motion(_numpy(pose), _numpy(tran),
                                    output_dir=str(self.out_dir))

    def save_obj_sequence(self, pose, tran=None, stride: int = 10,
                          prefix: str = "frame") -> int:
        """Export every `stride`-th frame as an OBJ mesh; the meshes are
        skinned on the device, a chunk of frames per call."""
        dev = self.device
        pose = torch.as_tensor(_numpy(pose), dtype=torch.float32,
                               device=dev).reshape(-1, 24, 3, 3)
        idx = list(range(0, pose.shape[0], stride))
        tran = (torch.zeros((pose.shape[0], 3), device=dev) if tran is None
                else torch.as_tensor(_numpy(tran), dtype=torch.float32,
                                     device=dev).reshape(-1, 3))
        with torch.no_grad():
            for c in range(0, len(idx), _MESH_CHUNK):
                sel = torch.tensor(idx[c:c + _MESH_CHUNK], device=dev)
                verts = self.body.forward_kinematics(
                    pose[sel], tran=tran[sel], calc_mesh=True)[2]
                for i, v in zip(idx[c:c + _MESH_CHUNK], verts.cpu().numpy()):
                    self.body.save_obj_mesh(
                        v, str(self.out_dir / f"{prefix}_{i:05d}.obj"))
        return len(idx)


class SMPLViewer:
    """Dual-body prediction-vs-GT export (reference: smpl_viewer.py:23-43).

    The GT body is offset by +x like the reference's side-by-side render;
    with `gt_tran` the prediction uses the ground-truth translation
    (the reference's GT=1/2 modes)."""

    def __init__(self, body_model: Optional[ParametricModel] = None,
                 out_dir="saved_motions", device=None):
        self.body = body_model or ParametricModel.from_file_or_synthetic(
            C.paths.smpl_file)
        self.dump = MotionDump(self.body, out_dir, device=device)

    def view(self, pose_p, tran_p, pose_t=None, tran_t=None,
             gt_tran: bool = False, offset_x: float = 1.0,
             name: str = "view") -> Path:
        pose_p = _numpy(pose_p).reshape(-1, 24, 3, 3)
        tran_p = _numpy(tran_p).reshape(-1, 3)
        if gt_tran and tran_t is not None:
            tran_p = _numpy(tran_t).reshape(-1, 3)
        arrays = {"pose_p": pose_p, "tran_p": tran_p}
        if pose_t is not None:
            arrays["pose_t"] = _numpy(pose_t).reshape(-1, 24, 3, 3)
            t = (_numpy(tran_t).reshape(-1, 3) if tran_t is not None
                 else np.zeros_like(tran_p))
            arrays["tran_t"] = t + np.array([offset_x, 0.0, 0.0])
        self.dump.save_unity(pose_p, tran_p)
        return self.dump.save_npz(name, **arrays)


class SequenceLoader:
    """Viz-time model runner (reference: loader.py:9-68). `params` are
    the port's modules on `device` (the CUDA card unless given)."""

    def __init__(self, net, params, combo: str = "lw_rp", device=None):
        self.device = resolve_device(device)
        self.net = net.on(self.device)
        self.params = params
        self.combo = combo

    def run_offline(self, imu):
        """imu [T, 60] -> numpy (pose [T,24,3,3], joints [T,24,3],
        tran [T,3], contact [T,2]) from one `forward_offline`."""
        imu = torch.as_tensor(_numpy(imu), dtype=torch.float32,
                              device=self.device)
        with torch.no_grad():
            out = self.net.forward_offline(self.params, imu)
        return tuple(o.cpu().numpy() for o in out)

    def run_online(self, imu):
        """imu [T, 60] -> numpy (pose [T,24,3,3], tran [T,3]), one
        `forward_online` a frame from a fresh streaming state."""
        imu = torch.as_tensor(_numpy(imu), dtype=torch.float32,
                              device=self.device)
        state = self.net.init_online_state()
        poses, trans = [], []
        with torch.no_grad():
            for frame in imu:
                (p, _, t, _), state = self.net.forward_online(
                    self.params, state, frame)
                poses.append(p)
                trans.append(t)
        return (torch.stack(poses).cpu().numpy(),
                torch.stack(trans).cpu().numpy())
