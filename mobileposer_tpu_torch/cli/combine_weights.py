"""Merge best per-module checkpoints into one weights file (counterpart
of `mobileposer_tpu/cli/combine_weights.py`; reference CLI:
mobileposer/combine_weights.py).

    python -m mobileposer_tpu_torch.cli.combine_weights --checkpoint-dir D

Reads and writes the JAX package's `.npz` layout. `--export-torch` (a
reference-format `.pth`) raises NotImplementedError naming its ROADMAP
row.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mobileposer_tpu_torch.train import combine_weights


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--finetune", default=None,
                        help="take joints/poser from finetuned_<dataset>")
    parser.add_argument("--export-torch", default=None, metavar="PATH",
                        help="not ported (ROADMAP.md queue A item 17)")
    args = parser.parse_args(argv)
    if args.export_torch:
        raise NotImplementedError(
            "--export-torch (reference-format .pth) is not ported "
            "(ROADMAP.md queue A item 17)")
    out = combine_weights(args.checkpoint_dir, args.out,
                          finetune=args.finetune)
    print(f"Model written to {out}.")
    return out


if __name__ == "__main__":
    main()
