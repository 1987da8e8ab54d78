"""Merge best per-module checkpoints into one weights file (counterpart
of `mobileposer_tpu/cli/combine_weights.py`; reference CLI:
mobileposer/combine_weights.py).

    python -m mobileposer_tpu_torch.cli.combine_weights --checkpoint-dir D
        [--export-torch model.pth]

Reads and writes the JAX package's `.npz` layout; `--export-torch` also
writes the combined weights as a reference-format torch state_dict
(`nn.torch_convert.save_torch_checkpoint`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mobileposer_tpu_torch.nn.convert import load_npz
from mobileposer_tpu_torch.nn.torch_convert import save_torch_checkpoint
from mobileposer_tpu_torch.train import combine_weights


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--finetune", default=None,
                        help="take joints/poser from finetuned_<dataset>")
    parser.add_argument("--export-torch", default=None, metavar="PATH",
                        help="also write the combined weights as a "
                             "reference-format torch state_dict "
                             "(combine_weights.py:41-56 layout) so the "
                             "reference implementation can evaluate a "
                             "checkpoint trained here")
    args = parser.parse_args(argv)
    out = combine_weights(args.checkpoint_dir, args.out,
                          finetune=args.finetune)
    print(f"Model written to {out}.")
    if args.export_torch:
        save_torch_checkpoint(load_npz(out), args.export_torch)
        print(f"Reference-format torch checkpoint written to "
              f"{args.export_torch}.")
    return out


if __name__ == "__main__":
    main()
