"""Experiment-metric sinks (counterpart of `mobileposer_tpu/utils/metrics.py`).

The reference logs training to wandb through Lightning's WandbLogger
(reference train.py:40-46). Sinks receive flat dict records ({"module":
..., "epoch": ..., "train_loss": ..., ...}); numeric values go to the
structured backends, whole records to the stream ones. Spec strings (CLI
`--metrics`, comma-separated):
    jsonl:<path>  csv:<path>  tensorboard:<logdir>  wandb:<project>
"""

from __future__ import annotations

import csv
import json
import numbers
from pathlib import Path
from typing import Dict, List, Optional


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


class TensorBoardSink(MetricsSink):
    """Scalar curves through `torch.utils.tensorboard`: each numeric value
    as `<module>/<key>` at step `epoch` (a running count without one)."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(str(logdir))
        self._step = 0

    def log(self, record: Dict) -> None:
        step = record.get("epoch", self._step)
        prefix = record.get("module", "train")
        for k, v in record.items():
            if k in ("epoch", "module"):
                continue
            if isinstance(v, numbers.Number):
                self._w.add_scalar(f"{prefix}/{k}", float(v), int(step))
        self._step += 1

    def close(self) -> None:
        self._w.close()


class WandbSink(MetricsSink):
    """wandb, when the package is importable (reference train.py:40-46).
    Raises ImportError at construction otherwise: the caller chose this
    sink, so a silent no-op would hide a misconfiguration."""

    def __init__(self, project: str, run_name: Optional[str] = None):
        import wandb
        self._run = wandb.init(project=project, name=run_name)

    def log(self, record: Dict) -> None:
        self._run.log({k: v for k, v in record.items()
                       if isinstance(v, numbers.Number)},
                      step=record.get("epoch"))

    def close(self) -> None:
        self._run.finish()


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
        elif kind == "tensorboard":
            sinks.append(TensorBoardSink(arg))
        elif kind == "wandb":
            sinks.append(WandbSink(arg or "mobileposer_tpu"))
        else:
            raise ValueError(f"unknown metrics sink {kind!r} "
                             "(expected jsonl|csv|tensorboard|wandb)")
    return MultiSink(sinks)
