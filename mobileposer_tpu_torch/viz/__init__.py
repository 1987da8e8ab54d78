"""Visualization of the port: the live half only (the counterpart of the
live viewers in `mobileposer_tpu/viz/`). `LiveSkeletonViewer` and
`OrientationCubeViewer` draw with pygame, imported when a viewer is made;
`OrientationMonitor` prints. The offline exports (`render.py`,
`viewer.py`) and `cli/render.py` are not ported (ROADMAP.md queue A item
18b)."""

from mobileposer_tpu_torch.viz.live_viewer import (  # noqa: F401
    LiveSkeletonViewer,
    OrientationCubeViewer,
)
from mobileposer_tpu_torch.viz.orientation_monitor import \
    OrientationMonitor  # noqa: F401
