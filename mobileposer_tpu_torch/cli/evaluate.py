"""Evaluate a trained model on the card (counterpart of
`mobileposer_tpu/cli/evaluate.py`; reference CLI: mobileposer/evaluate.py:110-126).

    python -m mobileposer_tpu_torch.cli.evaluate --model weights.npz \\
        --dataset {dip,totalcapture,imuposer,synthetic} [--combo lw_rp] \\
        [--online] [--tran] [--int8] [--device cpu]

Weights are the JAX package's `.npz` archives. Runs on the CUDA card
unless `--device` names another device (`cpu` runs the kernels' plain
versions). `--int8` quantizes the LSTM matmuls to W8A8 after loading, as
the JAX CLI does (`ops.quant.quantize_params_int8`; every LSTM layer on
the int8 kernels #4 to #6). `--data-parallel` evaluates on the one device
when one is visible (the card, or `--device cpu`), as the JAX CLI does
with one device. `--bf16`, `--online-mode carry` (with or without
`--int8`) and `--data-parallel` over more than one CUDA device are
accepted as the JAX CLI accepts them and raise NotImplementedError naming
the ROADMAP row that adds them.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.evaluation import evaluate_pose
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
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
                        help="combined weights (.npz from the JAX package)")
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
                        help="not ported (ROADMAP.md queue A item 14)")
    parser.add_argument("--online-mode", default="exact",
                        choices=["exact", "carry"],
                        help="'carry' is not ported (ROADMAP.md queue A "
                             "item 13)")
    parser.add_argument("--int8", action="store_true",
                        help="evaluate on W8A8-quantized LSTM matmuls "
                             "(ops/quant.py): scores what an int8 "
                             "deployment would serve")
    args = parser.parse_args(argv)

    if args.int8 and args.bf16:
        raise NotImplementedError(
            "--int8 --bf16 (int8 on bf16 params) is not ported (bf16, "
            "ROADMAP.md queue A item 14)")
    if args.int8 and args.online_mode == "carry":
        raise NotImplementedError(
            "--int8 --online-mode carry needs the int8 cell step "
            "lstm_cell_step_int8, which is not ported (carry mode, "
            "ROADMAP.md queue A item 13)")
    if Path(args.model).suffix != ".npz":
        raise NotImplementedError(
            f"{args.model}: only the JAX package's .npz archives load; a "
            "torch checkpoint loader is not ported (ROADMAP.md queue A "
            "item 17)")
    device = resolve_device(args.device)
    # the JAX CLI builds a mesh only over more than one device
    if (args.data_parallel and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "--data-parallel over more than one CUDA device is not ported "
            "(ROADMAP.md queue A item 16)")
    net = MobilePoserNet(ParametricModel.from_file_or_synthetic(
        C.paths.smpl_file), device=device)
    params = params_from_jax(load_npz(args.model), device=net.device)
    if args.int8:
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
