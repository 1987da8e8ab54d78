"""Render a MotionDump npz bundle to PNG frames / GIF, or play it in a
live pygame window (counterpart of `mobileposer_tpu/cli/render.py`;
reference viewer, smpl_viewer.py:23-43).

    python -m mobileposer_tpu_torch.cli.render saved_motions/view.npz \
        --out render_out [--stride 5] [--gif] [--live [--fps 30]] \
        [--device cpu]

Forward kinematics runs on the CUDA card unless `--device` names another
device; the frames are drawn on the host (PIL).
"""

from __future__ import annotations

import argparse

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.viz.render import load_bundle_joints, render_motion


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("bundle", help="npz written by SMPLViewer.view / "
                                       "MotionDump.save_npz")
    parser.add_argument("--out", default="render_out")
    parser.add_argument("--stride", type=int, default=5,
                        help="render every Nth frame")
    parser.add_argument("--gif", action="store_true",
                        help="also assemble an animated GIF")
    parser.add_argument("--live", action="store_true",
                        help="play in a pygame window instead of writing "
                             "files (pred-vs-GT side by side when the "
                             "bundle has ground truth)")
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--device", default=None,
                        help="torch device of the forward kinematics "
                             "(default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    if args.live:
        from mobileposer_tpu_torch.viz.live_viewer import LiveSkeletonViewer
        _, joints_p, joints_t = load_bundle_joints(args.bundle, body, device)
        # world-space joints: the bundle bakes the GT +x offset, so use the
        # shared-camera layout (a second screen offset pushes GT off-window)
        viewer = LiveSkeletonViewer(body, split_layout=False)
        try:
            shown = viewer.play(joints_p, fps=args.fps,
                                joints_gt_seq=joints_t)
        finally:
            viewer.close()
        print(f"played {shown} frames")
        return
    out = render_motion(args.bundle, args.out, body=body,
                        stride=args.stride, gif=args.gif, device=device)
    print(f"rendered to {out}")


if __name__ == "__main__":
    main()
