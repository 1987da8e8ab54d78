"""Checkpoint-parity harness against the reference implementation
(counterpart of `mobileposer_tpu/cli/parity.py`).

Given the released PyTorch checkpoint, the official SMPL file, and a
processed DIP-IMU test set (none of which ship in the repository), this
loads the weights, runs the evaluation protocol on the card, and checks
the BASELINE.md targets: SIP error within 0.1 deg and joint position error
within 0.1 cm of the reference's own numbers.

    python -m mobileposer_tpu_torch.cli.parity \\
        --torch-checkpoint base_model.pth \\
        --reference-metrics ref_metrics.json \\
        [--dataset dip] [--combo lw_rp] [--online] [--compat] [--device cpu]

`ref_metrics.json` holds the reference evaluate.py printout as
{"sip_deg": ..., "pos_cm": ...} (produce it once by running the
reference's evaluate.py with the same checkpoint). Without it, this prints
the port's metrics for manual comparison and exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.evaluation import evaluate_pose
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import params_from_jax

SIP_TOL_DEG = 0.1
POS_TOL_CM = 0.1


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--torch-checkpoint", required=True)
    parser.add_argument("--reference-metrics", default=None,
                        help="json with the reference's sip_deg / pos_cm")
    parser.add_argument("--dataset", default="dip")
    parser.add_argument("--combo", default="lw_rp")
    parser.add_argument("--online", action="store_true")
    parser.add_argument("--compat", action="store_true",
                        help="bit-for-bit reference behavior (raw-logit "
                             "online fusion weight)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    if not os.path.exists(str(C.paths.smpl_file)):
        print("WARNING: official SMPL file not found — running on the "
              "synthetic fixture body; metrics are NOT comparable to the "
              "reference (set MP_SMPL_FILE)")
        if args.reference_metrics:
            raise SystemExit("refusing to compare against reference metrics "
                             "without the official SMPL body")
    net = MobilePoserNet(body, online_sigmoid=not args.compat,
                         device=args.device)
    params = params_from_jax(load_model(args.torch_checkpoint),
                             device=net.device)
    ds = PoseDataset(fold="test", evaluate=args.dataset, body_model=body,
                     device=net.device)
    view = EvalSequence(ds, combo=args.combo)
    res = evaluate_pose(net, params, view, online=args.online, verbose=True)

    ours = {"sip_deg": float(res["offline"][0, 0]),
            "pos_cm": float(res["offline"][3, 0])}
    print(json.dumps({"ours": ours}))

    if args.reference_metrics:
        with open(args.reference_metrics) as f:
            ref = json.load(f)
        d_sip = abs(ours["sip_deg"] - ref["sip_deg"])
        d_pos = abs(ours["pos_cm"] - ref["pos_cm"])
        ok = d_sip <= SIP_TOL_DEG and d_pos <= POS_TOL_CM
        print(json.dumps({"reference": ref,
                          "delta": {"sip_deg": d_sip, "pos_cm": d_pos},
                          "within_tolerance": ok}))
        sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
