"""Sensor frontend app: ingest phone/watch/earbud UDP packets, calibrate,
rebroadcast aligned frames (counterpart of
`mobileposer_tpu/cli/calibration.py`; reference CLI:
mobileposer/calibration.py). Host code: no device runs here.

    python -m mobileposer_tpu_torch.cli.calibration [--log] [--native]
        [--duration 60] [--calibrate-after S] [--cubes]
"""

from __future__ import annotations

import argparse

from mobileposer_tpu_torch.stream import SensorFrontend


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log", action="store_true",
                        help="print per-device Hz / delay once per second")
    parser.add_argument("--duration", type=float, default=None,
                        help="run for N seconds (default: forever)")
    parser.add_argument("--calibrate-after", type=float, default=None,
                        help="run device mean-orientation calibration after "
                             "N seconds of ingest")
    parser.add_argument("--native", action="store_true",
                        help="use the C++ UDP ingest (GIL-free ring buffers)")
    parser.add_argument("--cubes", action="store_true",
                        help="open the pygame orientation-cube window "
                             "(reference visualizer.py equivalent; the "
                             "textual monitor stays available headless)")
    args = parser.parse_args(argv)

    frontend = SensorFrontend(log=args.log, native=args.native)
    print("Sensor frontend listening on UDP 8001-8005, "
          "rebroadcasting to :7777. Ctrl-C to stop.")
    if args.calibrate_after:
        import threading

        def _cal():
            import time
            time.sleep(args.calibrate_after)
            frontend.calibrate()
            print("calibrated device inertial frames")

        threading.Thread(target=_cal, daemon=True).start()
    viewer = None
    if args.cubes:
        from mobileposer_tpu_torch import config as C
        from mobileposer_tpu_torch.viz.live_viewer import \
            OrientationCubeViewer
        names = [n for n, _ in sorted(C.sensor.id_map.items(),
                                      key=lambda kv: kv[1])]
        viewer = OrientationCubeViewer(n_devices=len(names), names=names)
    try:
        frontend.run(duration=args.duration,
                     on_tick=viewer.render_sensor_data if viewer else None)
    except KeyboardInterrupt:
        frontend.stop()
    finally:
        if viewer is not None:
            viewer.close()


if __name__ == "__main__":
    main()
