"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` holds it) and a traffic mix (`traffic/<name>.json`, whose `kind`
names the code that runs it, `kinds/<kind>.py`); its limits are
`limits/<cell>.json`; a per-layer metric is read by
`metrics/<name>.py`. Adding a cell, a mix or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: Path = HERE.parent, bench: Path = HERE):
        self.root, self.bench = Path(root), Path(bench)
        self.data = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration named {name!r}")

    def traffic(self, name: str) -> dict:
        return _json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _json(self.bench / "limits" / f"{cell}.json")

    def metrics(self, section: str, cell: str) -> list:
        """The `section` ("end_to_end" or "per_layer") metrics that `cell`
        reports."""
        return [m for m in self.data[section]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return _module(self.bench / "metrics" / f"{metric}.py")

    def runner(self, kind: str):
        return _module(self.bench / "kinds" / f"{kind}.py")


def _module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "portbench._found." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
