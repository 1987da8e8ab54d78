"""Overfit-one-batch sanity harness on the card (counterpart of
`mobileposer_tpu/cli/overfit.py`; reference CLI: mobileposer/overfit.py).

    python -m mobileposer_tpu_torch.cli.overfit --module joints
        [--steps 100] [--batch-size 8] [--synthetic] [--device cpu]

Prints the module's parameter count and the loss trajectory on one
repeated batch, the reference's module sanity check (overfit.py:44-56),
in the JAX CLI's format. The batch comes from the processed data under
$MP_PROCESSED, or with `--synthetic` (or when that folder does not
exist) from a temporary one-sequence fixture of 150 frames. Weights are
drawn from a seed-0 generator, the per-step draws from a seed-1 one on
the device. Runs on the CUDA card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import PoseDataset
from mobileposer_tpu_torch.data.fixtures import make_synthetic_processed_dataset
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.train import (MODULE_NAMES, init_train_state,
                                         make_train_step)
from mobileposer_tpu_torch.train.trainer import to_device


def count_params(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def main(argv=None) -> list:
    """Run the steps; returns every step's loss."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--module", default="joints", choices=MODULE_NAMES)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic fixture dataset")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    with contextlib.ExitStack() as stack:
        if args.synthetic or not C.paths.processed_datasets.exists():
            d = stack.enter_context(tempfile.TemporaryDirectory())
            path = f"{d}/overfit.pt"
            make_synthetic_processed_dataset(path, n_sequences=1, T=150,
                                             body_model=body, device=device)
            dataset = PoseDataset(fold="train", body_model=body,
                                  data_files=[path], device=device)
        else:
            dataset = PoseDataset(fold="train", body_model=body,
                                  device=device)

    state = init_train_state(args.module, torch.Generator().manual_seed(0),
                             lr=C.train_hypers.lr, device=device)
    print(f"module {args.module}: {count_params(state.params):,} parameters")
    step = make_train_step(args.module,
                           body_model=body if args.module == "poser" else None)
    batch = to_device(dataset._assemble(
        np.arange(min(args.batch_size, len(dataset))),
        C.datasets.window_length), device)
    gen = torch.Generator(device=device).manual_seed(1)
    losses = []
    for i in range(args.steps):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}")
    return losses


if __name__ == "__main__":
    main()
