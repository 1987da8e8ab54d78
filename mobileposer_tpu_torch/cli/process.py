"""Raw-dataset processing (counterpart of `mobileposer_tpu/cli/process.py`
and `mobileposer_tpu/data/process.py`): not ported. `main` raises
NotImplementedError naming its ROADMAP row; synthetic processed data
comes from `data.fixtures.make_synthetic_processed_dataset`."""

from __future__ import annotations


def main(argv=None) -> None:
    raise NotImplementedError(
        "raw-data processing (data/process.py) is not ported (ROADMAP.md "
        "queue A item 23)")


if __name__ == "__main__":
    main()
