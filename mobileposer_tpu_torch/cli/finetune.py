"""Finetune recipe (counterpart of `mobileposer_tpu/cli/finetune.py`):
not ported. `main` raises NotImplementedError naming its ROADMAP row."""

from __future__ import annotations


def main(argv=None) -> None:
    raise NotImplementedError(
        "the finetune recipe is not ported (ROADMAP.md queue A item 24)")


if __name__ == "__main__":
    main()
