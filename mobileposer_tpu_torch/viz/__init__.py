"""Visualization of the port (counterpart of `mobileposer_tpu/viz/`).

Offline: `MotionDump`, `SMPLViewer` and `SequenceLoader` (`viewer.py`)
write OBJ meshes, Unity text and `.npz` bundles and run the model over a
sequence; `render_motion` (`render.py`, and `cli/render.py`) draws a
bundle's skeletons to PNG frames and a GIF with PIL. Live:
`LiveSkeletonViewer` and `OrientationCubeViewer` draw with pygame,
imported when a viewer is made; `OrientationMonitor` prints. Forward
kinematics and the model run on the CUDA card unless a device is named.
"""

from mobileposer_tpu_torch.viz.live_viewer import (  # noqa: F401
    LiveSkeletonViewer,
    OrientationCubeViewer,
)
from mobileposer_tpu_torch.viz.orientation_monitor import \
    OrientationMonitor  # noqa: F401
from mobileposer_tpu_torch.viz.render import render_motion  # noqa: F401
from mobileposer_tpu_torch.viz.viewer import (  # noqa: F401
    MotionDump,
    SMPLViewer,
    SequenceLoader,
)
