"""Run the model over one evaluation sequence on the card and export the
motion (counterpart of `mobileposer_tpu/cli/example.py`; reference CLI:
mobileposer/example.py and its viewers).

    python -m mobileposer_tpu_torch.cli.example --model weights.npz|model.pth
        [--dataset dip] [--seq-num 0] [--combo lw_rp] [--online]
        [--out saved_motions/] [--device cpu]

Offline, the whole sequence goes through `forward_offline` in one call;
`--online` runs the single-stream `forward_online` frame by frame. In
place of an OpenGL viewer the motion is written as `pose.txt` /
`tran.txt` (Unity's format, reference model.py:41-75) and
`example_<dataset>_<seq>.npz` with the predicted and the true pose and
translation. Runs on the CUDA card unless `--device` names another
device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import params_from_jax


def main(argv=None) -> Path:
    """Export the motion; returns the `.npz` path."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True,
                        help="combined weights (.npz from the JAX package, "
                             "or the reference's .pth)")
    parser.add_argument("--dataset", default="dip")
    parser.add_argument("--seq-num", type=int, default=0)
    parser.add_argument("--combo", default="lw_rp",
                        choices=list(C.COMBOS.keys()))
    parser.add_argument("--online", action="store_true")
    parser.add_argument("--out", default="saved_motions")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    net = MobilePoserNet(body, device=device)
    params = params_from_jax(load_model(args.model), device=device)
    ds = PoseDataset(fold="test", evaluate=args.dataset, body_model=body,
                     device=device)
    imu, pose_t, joints_t, tran_t = EvalSequence(ds, combo=args.combo)[
        args.seq_num]
    imu = torch.as_tensor(imu, device=device)

    with torch.no_grad():
        if args.online:
            state = net.init_online_state()
            poses, trans = [], []
            for frame in imu:
                (p, _, t, _), state = net.forward_online(params, state, frame)
                poses.append(p)
                trans.append(t)
            pose_p, tran_p = torch.stack(poses), torch.stack(trans)
        else:
            pose_p, _, tran_p, _ = net.forward_offline(params, imu)
    pose_p, tran_p = pose_p.cpu().numpy(), tran_p.cpu().numpy()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    body.save_unity_motion(pose_p, tran_p, output_dir=str(out))
    path = out / f"example_{args.dataset}_{args.seq_num}.npz"
    np.savez(path, pose_p=pose_p, tran_p=tran_p, pose_t=pose_t,
             tran_t=tran_t)
    print(f"Motion exported to {out}/")
    return path


if __name__ == "__main__":
    main()
