"""Preprocess the raw datasets on the card (counterpart of
`mobileposer_tpu/cli/process.py`; reference CLI: mobileposer/process.py:349-369).

    python -m mobileposer_tpu_torch.cli.process --dataset amass
    python -m mobileposer_tpu_torch.cli.process --dataset dip [--split test]
    python -m mobileposer_tpu_torch.cli.process --dataset totalcapture
    python -m mobileposer_tpu_torch.cli.process --dataset imuposer
    python -m mobileposer_tpu_torch.cli.process --dataset synthetic
        [--device cpu]

Reads the raw files under `C.paths.raw_*` (the `MP_RAW_*` and
`MP_CALIB_TC` overrides) and writes `$MP_PROCESSED` (AMASS, synthetic)
or `$MP_PROCESSED/eval` (the rest). Runs on the CUDA card unless
`--device` names another device.
"""

from __future__ import annotations

import argparse

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data.process import (
    process_amass, process_dipimu, process_imuposer, process_totalcapture)
from mobileposer_tpu_torch.device import resolve_device


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", default="amass",
                        choices=["amass", "dip", "totalcapture", "imuposer",
                                 "synthetic"])
    parser.add_argument("--split", default=None,
                        help="train/test split for dip & imuposer")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    C.paths.processed_datasets.mkdir(parents=True, exist_ok=True)
    C.paths.eval_dir.mkdir(parents=True, exist_ok=True)

    if args.dataset == "amass":
        process_amass(device=device)
    elif args.dataset == "dip":
        for split in ([args.split] if args.split else ["train", "test"]):
            process_dipimu(split=split, device=device)
    elif args.dataset == "totalcapture":
        process_totalcapture(device=device)
    elif args.dataset == "imuposer":
        for split in ([args.split] if args.split else ["train", "test"]):
            process_imuposer(split=split, device=device)
    elif args.dataset == "synthetic":
        from mobileposer_tpu_torch.data.fixtures import \
            make_synthetic_processed_dataset
        out = C.paths.processed_datasets / "synthetic.pt"
        make_synthetic_processed_dataset(out, n_sequences=8, T=400,
                                         device=device)
        print(f"Synthetic dataset saved: {out}")


if __name__ == "__main__":
    main()
