"""Offline skeleton renderer for MotionDump bundles (counterpart of
`mobileposer_tpu/viz/render.py`).

Behavioral parity target: the reference's live prediction-vs-GT render
(`viewers/smpl_viewer.py:23-43`, `visualizer.py:96-245`, open3d/pygame).
Headless, the equivalent is an offline renderer: it takes the `.npz`
bundle `SMPLViewer.view` writes (pose_p/tran_p and optionally
pose_t/tran_t, GT already offset on +x like the reference's side-by-side
view), runs forward kinematics on the device, and draws PNG frames or an
animated GIF of the two skeletons. The JAX package plots them with
matplotlib's 3D axes; the port draws them with PIL alone (a software
perspective projection, the live viewer's `_project`) and needs no
plotting library. As there, every frame is framed on the whole motion's
extent.

    python -m mobileposer_tpu_torch.cli.render saved_motions/view.npz \
        --out render_out [--stride 5] [--gif]
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics.smpl import SMPL_PARENTS, ParametricModel
from mobileposer_tpu_torch.viz.live_viewer import _project

_BONES = [(j, int(SMPL_PARENTS[j])) for j in range(1, 24)]


def joints_from_pose(body: ParametricModel, pose, tran=None,
                     device=None) -> np.ndarray:
    """FK a [N, 24, 3, 3] local-pose sequence (and [N, 3] translations)
    to [N, 24, 3] joints on `device` (the CUDA card unless given)."""
    device = resolve_device(device)
    pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32,
                           device=device).reshape(-1, 24, 3, 3)
    t = (torch.as_tensor(np.asarray(tran), dtype=torch.float32,
                         device=device).reshape(-1, 3) if tran is not None
         else torch.zeros((pose.shape[0], 3), device=device))
    with torch.no_grad():
        _, joints = body.forward_kinematics(pose, tran=t)
    return joints.cpu().numpy().reshape(-1, 24, 3)


_PRED_COLOR = (31, 119, 180)      # matplotlib's tab:blue
_GT_COLOR = (44, 160, 44)         # tab:green
_YAW, _PITCH = 0.35, 0.12


def _draw_skeleton(draw, joints: np.ndarray, color, size: int,
                   scale: float, mid: np.ndarray) -> None:
    pts = _project(joints - mid, (size, size), scale, _YAW, _PITCH,
                   (size / 2, size / 2))
    for j, p in _BONES:
        draw.line([pts[p], pts[j]], fill=color, width=2)
    for x, y in pts:
        draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=color)


def load_bundle_joints(bundle, body: Optional[ParametricModel] = None,
                       device=None):
    """(bundle_dict, joints_p [N,24,3], joints_t or None) from a MotionDump
    npz bundle (path or dict), forward kinematics on `device` (the CUDA
    card unless given): the one loader of the offline renderer and
    `cli/render --live`. Bundle translations already carry the viewer's
    world-space GT offset (viz/viewer.py), so callers must not offset
    again."""
    device = resolve_device(device)
    if not isinstance(bundle, dict):
        with np.load(bundle) as z:
            bundle = dict(z)
    body = body or ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    joints_p = joints_from_pose(body, bundle["pose_p"], bundle.get("tran_p"),
                                device)
    joints_t = (joints_from_pose(body, bundle["pose_t"],
                                 bundle.get("tran_t"), device)
                if "pose_t" in bundle else None)
    return bundle, joints_p, joints_t


def render_motion(bundle, out_dir, body: Optional[ParametricModel] = None,
                  stride: int = 5, gif: bool = False, dpi: int = 80,
                  device=None) -> Path:
    """Render a MotionDump npz bundle (path or dict of arrays) to PNG
    frames (and optionally an animated GIF). Returns the output dir (or
    the gif path)."""
    from PIL import Image, ImageDraw

    bundle, joints_p, joints_t = load_bundle_joints(bundle, body, device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    allj = (np.concatenate([joints_p, joints_t])
            if joints_t is not None else joints_p)
    lo, hi = allj.min(axis=(0, 1)), allj.max(axis=(0, 1))
    mid, span = (lo + hi) / 2, float((hi - lo).max() / 2 + 0.1)
    size = 6 * dpi                       # the JAX package's 6-inch figure
    scale = 0.4 * size / span

    frames = []
    for i in range(0, joints_p.shape[0], max(1, stride)):
        img = Image.new("RGB", (size, size), (255, 255, 255))
        draw = ImageDraw.Draw(img)
        _draw_skeleton(draw, joints_p[i], _PRED_COLOR, size, scale, mid)
        legend = [("prediction", _PRED_COLOR)]
        if joints_t is not None:
            _draw_skeleton(draw, joints_t[i], _GT_COLOR, size, scale, mid)
            legend.append(("ground truth", _GT_COLOR))
        draw.text((8, 8), f"frame {i}", fill=(0, 0, 0))
        for k, (label, color) in enumerate(legend):
            draw.text((8, 24 + 14 * k), label, fill=color)
        path = out_dir / f"frame_{i:05d}.png"
        img.save(path)
        frames.append(path)

    if gif:
        imgs = [Image.open(p) for p in frames]
        gif_path = out_dir / "motion.gif"
        imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                     duration=max(1, int(1000 * stride / C.datasets.fps)),
                     loop=0)
        return gif_path
    return out_dir
