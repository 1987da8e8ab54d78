"""Live on-screen viewers: skeleton window + per-device orientation cubes
(the port's copy of `mobileposer_tpu/viz/live_viewer.py`: pygame and
numpy, no device).

Behavioral parity target: the reference's two interactive viewers — the
SMPL prediction(-vs-GT) viewer (`mobileposer/viewers/smpl_viewer.py:23-43`)
and the pygame/OpenGL per-device orientation cubes
(`mobileposer/visualizer.py:96-245`), re-implemented on pygame's plain 2D
surface with a software perspective projection: they open a real window
where a display exists and run headless under ``SDL_VIDEODRIVER=dummy``
(how the tests exercise them). pygame is imported when a viewer is made,
never with this module.

Usage with the live pipeline (stream/live.py)::

    viewer = LiveSkeletonViewer(body)
    poser.run(on_frame=viewer.on_frame)       # LivePoser callback hook
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mobileposer_tpu_torch import config as C

_BONE_COLOR = (80, 200, 255)
_GT_COLOR = (255, 160, 60)
_JOINT_COLOR = (240, 240, 240)
_BG = (12, 12, 16)
_CUBE_EDGES = (
    (0, 1), (1, 3), (3, 2), (2, 0),          # back face
    (4, 5), (5, 7), (7, 6), (6, 4),          # front face
    (0, 4), (1, 5), (2, 6), (3, 7))          # connectors


def _pygame():
    """Import pygame lazily with a clear error for minimal installs."""
    try:
        import pygame
    except ImportError as e:  # pragma: no cover - env always has pygame
        raise RuntimeError(
            "live viewers need pygame (pip install pygame); the headless "
            "monitor is viz/orientation_monitor.py") from e
    return pygame


def _rotation_yaw_pitch(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return rx @ ry


def _project(points: np.ndarray, size, scale: float, yaw: float,
             pitch: float, center_xy, depth: float = 4.0) -> list:
    """Software perspective projection of [N,3] (y-up) to pixel coords
    (list of (x, y) float tuples — pygame.draw rejects numpy rows)."""
    p = points @ _rotation_yaw_pitch(yaw, pitch).T
    z = np.maximum(depth + p[:, 2], 1e-3)
    x = p[:, 0] / z * scale * depth + center_xy[0]
    y = -p[:, 1] / z * scale * depth + center_xy[1]
    return [(float(a), float(b)) for a, b in zip(x, y)]


class LiveSkeletonViewer:
    """Interactive skeleton window (reference smpl_viewer.py equivalent).

    `update(joints)` draws one posed skeleton; pass `joints_gt` to get the
    side-by-side prediction-vs-GT layout the reference shows (GT offset to
    the right, drawn in a second color). Joints are [24,3] world-frame
    positions (what MobilePoserNet already outputs every frame — no mesh
    LBS needed at 30 Hz).
    """

    def __init__(self, body=None, size=(720, 540), scale: float = 170.0,
                 yaw: float = 0.35, pitch: float = 0.12,
                 title: str = "mobileposer_tpu_torch live",
                 split_layout: bool = True):
        """split_layout=True draws pred and GT at separate screen centers
        (for root-centered joints). Pass False when joints are WORLD-space
        and already separated — e.g. the JAX package's MotionDump bundles
        bake a +1 m GT offset into tran_t; a second screen offset would
        push GT off-window."""
        pg = _pygame()
        if not pg.get_init():
            pg.init()
        self._pg = pg
        self.size = size
        self.scale = scale
        self.yaw = yaw
        self.pitch = pitch
        if body is not None:
            self.parent = tuple(body.parent)
        else:
            from mobileposer_tpu_torch.kinematics.smpl import SMPL_PARENTS
            self.parent = SMPL_PARENTS
        self.split_layout = split_layout
        self.screen = pg.display.set_mode(size)
        pg.display.set_caption(title)
        self.frames_drawn = 0

    def _draw_skeleton(self, joints: np.ndarray, color, center_xy) -> None:
        pts = _project(np.asarray(joints, np.float32), self.size, self.scale,
                       self.yaw, self.pitch, center_xy)
        for j, p in enumerate(self.parent):
            if p < 0:
                continue
            self._pg.draw.line(self.screen, color, pts[p], pts[j], 2)
        for x, y in pts:
            self._pg.draw.circle(self.screen, _JOINT_COLOR,
                                 (int(x), int(y)), 3)

    def update(self, joints: np.ndarray,
               joints_gt: Optional[np.ndarray] = None) -> None:
        """Draw one frame; processes window events (close -> StopIteration
        like the reference viewer's quit path)."""
        pg = self._pg
        for event in pg.event.get():
            if event.type == pg.QUIT:
                raise StopIteration("viewer window closed")
        self.screen.fill(_BG)
        w, h = self.size
        if joints_gt is None:
            self._draw_skeleton(joints, _BONE_COLOR, (w / 2, h * 0.55))
        elif self.split_layout:
            self._draw_skeleton(joints, _BONE_COLOR, (w * 0.3, h * 0.55))
            self._draw_skeleton(joints_gt, _GT_COLOR, (w * 0.7, h * 0.55))
        else:                       # world-space: one shared camera center
            self._draw_skeleton(joints, _BONE_COLOR, (w / 2, h * 0.55))
            self._draw_skeleton(joints_gt, _GT_COLOR, (w / 2, h * 0.55))
        pg.display.flip()
        self.frames_drawn += 1

    def on_frame(self, pose, joints, tran, contact) -> None:
        """LivePoser.run(on_frame=...) adapter (stream/live.py)."""
        j = np.asarray(joints, np.float32).reshape(24, 3)
        self.update(j - j[:1])          # root-centered, like the reference

    def play(self, joints_seq: np.ndarray, fps: int = 30,
             joints_gt_seq: Optional[np.ndarray] = None) -> int:
        """Play a whole motion ([T,24,3] joint positions, optional GT) at
        `fps` — the reference's view-a-dataset-sequence use case
        (example.py -> Viewer -> SMPLViewer). Returns frames shown
        (stops early if the window is closed)."""
        clock = self._pg.time.Clock()
        shown = 0
        for t in range(len(joints_seq)):
            try:
                self.update(joints_seq[t],
                            None if joints_gt_seq is None
                            else joints_gt_seq[t])
            except StopIteration:
                break
            shown += 1
            clock.tick(fps)
        return shown

    def pixels(self) -> np.ndarray:
        """[W,H,3] snapshot (test hook; works under the dummy driver)."""
        return self._pg.surfarray.array3d(self.screen)

    def close(self) -> None:
        self._pg.display.quit()


class OrientationCubeViewer:
    """Per-device wireframe cubes (reference visualizer.py:96-245).

    `update(rotations)` with [n,3,3] global rotation matrices draws one
    rotated cube per device cell, labelled; optional accelerations are
    shown as a vertical bar next to each cube. The textual fallback for
    truly headless use stays `viz/orientation_monitor.py`.
    """

    def __init__(self, n_devices: int = 5,
                 names: Optional[Sequence[str]] = None,
                 size=(900, 220), title: str = "device orientations"):
        pg = _pygame()
        if not pg.get_init():
            pg.init()
        self._pg = pg
        self.n = n_devices
        self.size = size
        self.names = list(names) if names else [
            f"dev{i}" for i in range(n_devices)]
        self.screen = pg.display.set_mode(size)
        pg.display.set_caption(title)
        self._font = pg.font.Font(None, 20) if pg.font else None
        corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                            for z in (-1, 1)], np.float32) * 0.5
        self._corners = corners
        self.frames_drawn = 0

    def update(self, rotations: np.ndarray,
               accelerations: Optional[np.ndarray] = None) -> None:
        pg = self._pg
        for event in pg.event.get():
            if event.type == pg.QUIT:
                raise StopIteration("viewer window closed")
        self.screen.fill(_BG)
        rotations = np.asarray(rotations, np.float32).reshape(-1, 3, 3)
        w, h = self.size
        cell = w / max(self.n, 1)
        for i in range(min(self.n, rotations.shape[0])):
            pts3 = self._corners @ rotations[i].T
            center = (cell * (i + 0.5), h * 0.55)
            pts = _project(pts3, self.size, scale=min(cell, h) * 0.16,
                           yaw=0.0, pitch=0.0, center_xy=center)
            for a, b in _CUBE_EDGES:
                pg.draw.line(self.screen, _BONE_COLOR, pts[a], pts[b], 2)
            # the x-axis corner pair gets a second color so roll is visible
            pg.draw.line(self.screen, _GT_COLOR, pts[0], pts[4], 3)
            if accelerations is not None:
                mag = float(np.linalg.norm(accelerations[i]))
                bar = min(mag / 20.0, 1.0) * h * 0.6
                pg.draw.rect(self.screen, _GT_COLOR,
                             (cell * (i + 0.92), h * 0.8 - bar, 6, bar))
            if self._font is not None:
                img = self._font.render(self.names[i], True, _JOINT_COLOR)
                self.screen.blit(img, (cell * i + 8, 8))
        pg.display.flip()
        self.frames_drawn += 1

    def render_sensor_data(self, sensor_data) -> None:
        """Adapter for the frontend's SensorData (same virtual_ori /
        virtual_acc source the textual OrientationMonitor reads,
        viz/orientation_monitor.py:36-44)."""
        from mobileposer_tpu_torch.stream import quat_np as Q
        rots, accs = [], []
        for slot in sorted(C.sensor.id_map.values())[:self.n]:
            q = np.asarray(sensor_data.virtual_ori[slot],
                           np.float32).reshape(-1)
            if q.shape[0] == 4:
                rots.append(Q.quat_to_matrix(q))
            else:
                rots.append(np.eye(3, dtype=np.float32))
            accs.append(np.asarray(sensor_data.virtual_acc[slot],
                                   np.float32).reshape(-1)[:3])
        self.update(np.stack(rots), np.stack(accs))

    def pixels(self) -> np.ndarray:
        return self._pg.surfarray.array3d(self.screen)

    def close(self) -> None:
        self._pg.display.quit()
