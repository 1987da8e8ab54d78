"""BENCHMARK.json against the form it must have: names, units, keys, the
files each entry names, and the metrics each cell reports."""

import json
import re

import pytest

from portbench import manifest

MAN = manifest.Manifest()
B = MAN.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    raw = (MAN.root / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        extra = set(e) - KEYS[section] - {"workloads"}
        assert not extra and KEYS[section] <= set(e), e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[key]), (e["name"], key)


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in B[s]]
    assert len(names) == len(set(names))


def test_cells_and_their_files():
    configs = {c["name"] for c in B["configs"]}
    used = set()
    for w in B["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        used.add(w["config"])
        tr = MAN.traffic(w["traffic"])
        assert (MAN.bench / "kinds" / f"{tr['kind']}.py").is_file()
        limits = MAN.limits(w["name"])
        assert limits and all(v > 0 for v in limits.values())
        MAN.config(w["config"])
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert c["file"].startswith("portbench/")
        assert json.loads((MAN.root / c["file"]).read_text())["name"] == \
            c["name"]


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in B["workloads"]]
    for cell in cells:
        mine = {m["name"] for m in MAN.metrics("end_to_end", cell)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = MAN.metrics("per_layer", cell)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (MAN.bench / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_four_chip_cells_are_few():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)
