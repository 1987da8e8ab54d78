"""Headless per-device orientation monitor (the port's copy of
`mobileposer_tpu/viz/orientation_monitor.py`).

Replaces the reference's pygame/OpenGL cube visualizer
(mobileposer/visualizer.py:96-245) for calibration debugging on machines
without a display: prints each device's euler angles + acceleration at an
interval, driven by the same SensorData the frontend maintains.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.stream import quat_np as Q


class OrientationMonitor:
    """Textual stand-in for the per-device orientation cubes."""

    def __init__(self, interval: float = 1.0):
        self.interval = interval
        self._last = 0.0
        self._names = {v: k for k, v in C.sensor.id_map.items()}

    def render(self, sensor_data) -> Optional[str]:
        """One status block per device, or None between intervals."""
        now = time.time()
        if now - self._last < self.interval:
            return None
        self._last = now
        lines = []
        for slot in sorted(self._names):
            q = np.asarray(sensor_data.virtual_ori[slot]).reshape(-1)
            if q.shape[0] != 4:
                continue
            e = np.degrees(Q.euler_xyz_from_quat(q))
            a = np.asarray(sensor_data.virtual_acc[slot]).reshape(-1)
            lines.append(
                f"{self._names[slot]:16s} euler(deg) "
                f"[{e[0]:7.1f} {e[1]:7.1f} {e[2]:7.1f}]  "
                f"acc [{a[0]:6.2f} {a[1]:6.2f} {a[2]:6.2f}]")
        out = "\n".join(lines)
        print(out)
        return out
