"""Experiment-metric sinks (counterpart of `mobileposer_tpu/utils/metrics.py`).

Sinks receive flat dict records ({"module": ..., "epoch": ...,
"train_loss": ..., ...}). Spec strings (CLI `--metrics`, comma-separated):
`jsonl:<path>` and `csv:<path>`. The JAX package's `tensorboard:<logdir>`
and `wandb:<project>` sinks raise NotImplementedError naming their ROADMAP
row.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional

_SINK_ROW = "ROADMAP.md queue A item 21"


class MetricsSink:
    def log(self, record: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONLSink(MetricsSink):
    """One JSON object per line."""

    def __init__(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._f = open(path, "a")

    def log(self, record: Dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CSVSink(MetricsSink):
    """CSV with a header from the first record (later keys are dropped:
    the records of one training run share a schema). Appending to an
    existing file requires its header to match the record keys."""

    def __init__(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._path = path
        self._writer = None
        self._f = None

    def log(self, record: Dict) -> None:
        if self._writer is None:
            fieldnames = list(record)
            existing = None
            if Path(self._path).exists() and Path(self._path).stat().st_size:
                with open(self._path, newline="") as f:
                    existing = next(csv.reader(f), None)
            if existing is not None and existing != fieldnames:
                raise ValueError(
                    f"{self._path} has header {existing}, new records have "
                    f"keys {fieldnames}; appending would misalign columns "
                    "(use a fresh path or delete the old file)")
            self._f = open(self._path, "a", newline="")
            self._writer = csv.DictWriter(self._f, fieldnames=fieldnames)
            if existing is None:
                self._writer.writeheader()
        self._writer.writerow({k: record.get(k)
                               for k in self._writer.fieldnames})
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()


class MultiSink(MetricsSink):
    def __init__(self, sinks: List[MetricsSink]):
        self.sinks = list(sinks)

    def log(self, record: Dict) -> None:
        for s in self.sinks:
            s.log(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def make_sinks(spec: Optional[str]) -> MetricsSink:
    """Parse 'kind:arg,kind:arg' into a MultiSink. None/'' -> no-op sink."""
    sinks: List[MetricsSink] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, arg = part.partition(":")
        if kind == "jsonl":
            sinks.append(JSONLSink(arg))
        elif kind == "csv":
            sinks.append(CSVSink(arg))
        elif kind in ("tensorboard", "wandb"):
            raise NotImplementedError(
                f"the {kind} metrics sink is not ported ({_SINK_ROW})")
        else:
            raise ValueError(f"unknown metrics sink {kind!r} "
                             "(expected jsonl|csv|tensorboard|wandb)")
    return MultiSink(sinks)
