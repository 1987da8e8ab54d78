"""Export an AOT serving bundle (counterpart of
`mobileposer_tpu/cli/export_serving.py`).

    python -m mobileposer_tpu_torch.cli.export_serving --out bundle/
        [--model weights.npz|model.pth] [--streams 256]
        [--mode carry|exact|offline] [--seq-len 512]
        [--bf16] [--int8] [--device cpu] [--smoke-test]

The bundle (step.pt2 + weights.npz + state.npz + meta.json) runs on a
serving host without the model code (`mobileposer_tpu_torch/serving.py`).
It is exported for the CUDA card unless `--device` names another device
(the JAX CLI's `--platforms`); a bundle runs only on the kind of device
it was exported for. Without `--model`, random weights from seed 0 are
exported (pipeline smoke tests).
"""

from __future__ import annotations

import argparse

import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import cast_params, params_from_jax
from mobileposer_tpu_torch.serving import load_bundle, save_bundle


def main(argv=None):
    """Export (and with --smoke-test reload and run one step); returns the
    bundle directory."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="bundle directory")
    parser.add_argument("--model", default=None,
                        help="weights .npz or reference .pth (default: "
                             "random init from seed 0)")
    parser.add_argument("--streams", type=int, default=256)
    parser.add_argument("--mode", choices=["carry", "exact", "offline"],
                        default="carry",
                        help="streaming step (carry/exact) or the "
                             "stateless batched offline forward")
    parser.add_argument("--seq-len", type=int, default=512,
                        help="padded sequence length (offline mode)")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="quantize the LSTM matmuls to W8A8 before "
                             "export (int8 weights in the archive, about "
                             "4x smaller; exact/offline programs call the "
                             "int8 kernels)")
    parser.add_argument("--device", default=None,
                        help="torch device the bundle is for (default: "
                             "the CUDA card)")
    parser.add_argument("--smoke-test", action="store_true",
                        help="reload the bundle and run one step")
    args = parser.parse_args(argv)

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    net = MobilePoserNet(body, device=args.device)
    params = (params_from_jax(load_model(args.model), device=net.device)
              if args.model else
              init_all_modules(torch.Generator().manual_seed(0),
                               device=net.device))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.bf16:
        params = cast_params(params, dtype)

    out = save_bundle(args.out, net, params, n_streams=args.streams,
                      mode=args.mode, dtype=dtype, seq_len=args.seq_len,
                      quantize="int8" if args.int8 else None)
    print(f"exported {args.mode} step (S={args.streams}, "
          f"{str(dtype).removeprefix('torch.')}"
          + (", int8 LSTM kernels" if args.int8 else "") + f") -> {out}")

    if args.smoke_test:
        step, p, st, meta = load_bundle(out)
        if args.mode == "offline":
            imu = torch.zeros((args.streams, args.seq_len, 60), dtype=dtype,
                              device=net.device)
            pose, joints, tran, contact = step(
                p, imu, [args.seq_len] * args.streams)
        else:
            frames = torch.zeros((args.streams, 60), dtype=dtype,
                                 device=net.device)
            (pose, joints, tran, contact), _ = step(p, st, frames)
        if not bool(torch.isfinite(pose.float()).all()):
            raise SystemExit("smoke test failed: non-finite pose")
        print(f"smoke test ok: pose {tuple(pose.shape)}, tran "
              f"{tuple(tran.shape)} on {net.device.type}")
    return out


if __name__ == "__main__":
    main()
