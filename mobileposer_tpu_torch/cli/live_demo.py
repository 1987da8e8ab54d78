"""Live pose estimation from streamed IMUs on the card (counterpart of
`mobileposer_tpu/cli/live_demo.py`; reference CLI:
mobileposer/live_demo.py:146-290).

    python -m mobileposer_tpu_torch.cli.live_demo --model weights.npz
        [--vis] [--local-vis] [--save] [--combo lw_rp]
        [--calibration cal.npz] [--duration S] [--debug] [--device cpu]

Weights are the JAX package's `.npz` archives or the reference's torch
checkpoints (`.pth`, `models.utils.load_model`). The step runs on the
CUDA card unless `--device` names another device (`cpu` runs the
kernels' plain versions). Frames arrive on UDP :7777 from the sensor
frontend (`cli.calibration`) or a replayer (`stream.FrameReplayer`).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.stream import (
    Calibration, IMUSet, LivePoser, UnityExporter, save_session)
from mobileposer_tpu_torch.stream.live import stack_recording


def main(argv=None) -> Optional[Path]:
    """Run the live loop; returns the saved session's path under
    `--save`, else None."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True,
                        help="combined weights (.npz from the JAX package, "
                             "or the reference's .pth)")
    parser.add_argument("--vis", action="store_true",
                        help="stream pose to a Unity viewer on TCP :8889")
    parser.add_argument("--local-vis", action="store_true",
                        help="open a local pygame skeleton window "
                             "(viz/live_viewer.py — reference "
                             "smpl_viewer.py equivalent, no GL needed)")
    parser.add_argument("--save", action="store_true",
                        help="record the session to dev data")
    parser.add_argument("--combo", default="lw_rp",
                        choices=list(C.COMBOS.keys()))
    parser.add_argument("--calibration", default=None,
                        help="load a saved calibration .npz instead of the "
                             "interactive procedure")
    parser.add_argument("--duration", type=float, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    net = MobilePoserNet(device=resolve_device(args.device))
    params = params_from_jax(load_model(args.model), device=net.device)
    poser = LivePoser(net, params, imu_set=IMUSet(buffer_len=1),
                      combo=args.combo)

    if args.calibration:
        poser.set_calibration(Calibration.load(args.calibration))
    else:
        input("Put IMU 1 aligned with your body reference frame "
              "(x = Left, y = Up, z = Forward) and press Enter.")
        print("Keep for 3 seconds ...", end="", flush=True)
        poser.calibrate_body_frame()
        input("\tDone.\nWear all IMUs correctly and press Enter.")
        for i in range(3, 0, -1):
            print(f"\rStand in T-pose. Calibration begins in {i} s.",
                  end="", flush=True)
            time.sleep(1)
        print("\nHold the T-pose for 3 seconds ...", end="", flush=True)
        cal = poser.calibrate_tpose()
        cal.save("calibration.npz")
        print("\tDone (saved to calibration.npz).")

    unity = None
    if args.vis:
        unity = UnityExporter()
        print("Waiting for Unity viewer to connect on :8889 ...")
        unity.accept()
    viewer = None
    if args.local_vis:
        from mobileposer_tpu_torch.viz.live_viewer import LiveSkeletonViewer
        viewer = LiveSkeletonViewer(net.body_model)

    print(f"Estimating poses on {net.device}. Ctrl-C to stop.", flush=True)
    try:
        recorded = poser.run(duration=args.duration, unity=unity,
                             on_frame=viewer.on_frame if viewer else None,
                             record=args.save, debug=args.debug)
    except KeyboardInterrupt:
        # interrupt escaped run() (rare window): salvage the live buffers
        live = getattr(poser, "last_recording", None)
        recorded = stack_recording(live) if live else None
    finally:
        if unity is not None:
            unity.close()
        if viewer is not None:
            viewer.close()
    if args.save and recorded:
        path = save_session(recorded, poser.calibration)
        print(f"Session saved to {path}", flush=True)
        return path
    return None


if __name__ == "__main__":
    main()
