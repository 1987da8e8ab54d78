"""Overfit-one-batch recipe (counterpart of `mobileposer_tpu/cli/overfit.py`):
not ported. `main` raises NotImplementedError naming its ROADMAP row."""

from __future__ import annotations


def main(argv=None) -> None:
    raise NotImplementedError(
        "the overfit recipe is not ported (ROADMAP.md queue A item 24)")


if __name__ == "__main__":
    main()
