"""Evaluate a trained model on the card (counterpart of
`mobileposer_tpu/cli/evaluate.py`; reference CLI: mobileposer/evaluate.py:110-126).

    python -m mobileposer_tpu_torch.cli.evaluate --model weights.npz \\
        --dataset {dip,totalcapture,imuposer,synthetic} [--combo lw_rp] \\
        [--online] [--tran] [--int8 | --bf16] [--device cpu]

Weights are the JAX package's `.npz` archives or the reference's torch
checkpoints (`.pth`, `models.utils.load_model`). Runs on the CUDA card
unless `--device` names another device (`cpu` runs the kernels' plain
versions). `--int8` quantizes the LSTM matmuls to W8A8 after loading, as
the JAX CLI does (`ops.quant.quantize_params_int8`; every LSTM layer on
the int8 kernels #4 to #6). `--online-mode carry` runs the ONLINE
protocol through carry-mode streaming (`models/streaming.py`), with or
without `--int8`. `--bf16` evaluates on bf16-cast params, both
protocols in bf16 (`evaluate_pose(bf16=True)`; the metrics in float32 on
the cast-back outputs). `--int8 --bf16` does what the JAX CLI does:
casts to bf16, then quantizes, then evaluates in bf16 (the int8 kernels'
bf16-I/O entries). `--data-parallel` evaluates on the one device when
one is visible (the card, or `--device cpu`), as the JAX CLI does with
one device; over more than one CUDA device it is accepted as the JAX
CLI accepts it and raises NotImplementedError naming the ROADMAP row
that adds it.
"""

from __future__ import annotations

import argparse
import os

import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.evaluation import evaluate_pose
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.nn.lstm import cast_params
from mobileposer_tpu_torch.ops.quant import quantize_params_int8


def _env_flag(name: str) -> bool:
    """An environment switch as the JAX CLI reads it: unset or empty is
    off, an integer is its truth value, any other text is on."""
    v = os.environ.get(name)
    if not v:
        return False
    try:
        return bool(int(v))
    except ValueError:
        return True


def main(argv=None) -> dict:
    """Run the evaluation, print the tables and return `evaluate_pose`'s
    result dict."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True,
                        help="combined weights (.npz from the JAX package, "
                             "or the reference's .pth)")
    parser.add_argument("--dataset", default="dip",
                        choices=list(C.datasets.test_datasets.keys())
                        + ["synthetic"],
                        help="'synthetic' evaluates against "
                             "$MP_PROCESSED/synthetic.pt")
    parser.add_argument("--combo", default="lw_rp",
                        choices=list(C.COMBOS.keys()))
    parser.add_argument("--online", action="store_true",
                        help="also run the frame-by-frame streaming "
                             "protocol (or set ONLINE=1)")
    parser.add_argument("--tran", action="store_true",
                        help="report translation drift at 1-7 m")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="evaluates on the one device; over more "
                             "than one CUDA device not ported (ROADMAP.md "
                             "queue A item 16)")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 inference dtype (weights, state, "
                             "frames); metrics computed in float32 on the "
                             "cast-back outputs; with --int8 the bf16 "
                             "cast is quantized")
    parser.add_argument("--online-mode", default="exact",
                        choices=["exact", "carry"],
                        help="ONLINE protocol semantics: 'exact' "
                             "windows, or the carry-mode approximation "
                             "(models/streaming.py)")
    parser.add_argument("--int8", action="store_true",
                        help="evaluate on W8A8-quantized LSTM matmuls "
                             "(ops/quant.py): scores what an int8 "
                             "deployment would serve; composes with "
                             "--bf16 and both --online-mode values")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    # the JAX CLI builds a mesh only over more than one device
    if (args.data_parallel and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "--data-parallel over more than one CUDA device is not ported "
            "(ROADMAP.md queue A item 16)")
    net = MobilePoserNet(ParametricModel.from_file_or_synthetic(
        C.paths.smpl_file), device=device)
    params = params_from_jax(load_model(args.model), device=net.device)
    if args.int8:
        if args.bf16:
            # the JAX CLI's order: cast first, so the scales stay float32
            # and the linears and the state run in bf16
            params = cast_params(params, torch.bfloat16)
        params = quantize_params_int8(params)
    if args.dataset == "synthetic":
        fixture = C.paths.processed_datasets / "synthetic.pt"
        if not fixture.exists():
            raise SystemExit(f"{fixture} not found")
        ds = PoseDataset(fold="test", evaluate="dip", body_model=net.body_model,
                         data_files=[fixture], device=net.device)
    else:
        ds = PoseDataset(fold="test", evaluate=args.dataset,
                         body_model=net.body_model, device=net.device)
    return evaluate_pose(net, params, EvalSequence(ds, combo=args.combo),
                         online=args.online or _env_flag("ONLINE"),
                         evaluate_tran=args.tran,
                         online_mode=args.online_mode, bf16=args.bf16)


if __name__ == "__main__":
    main()
