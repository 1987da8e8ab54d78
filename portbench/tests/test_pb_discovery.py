"""The harness finds a cell, a traffic mix, limits and a per-layer metric
by name: in a temporary copy, a new metric file, a new mix file, a new
limits file and new entries of BENCHMARK.json are picked up with no other
edit."""

import json
import shutil

from portbench import manifest, run

MAN = manifest.Manifest()


def test_new_files_and_entries_are_picked_up(tmp_path):
    shutil.copy(MAN.root / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "portbench"
    shutil.copytree(MAN.bench, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (bench / "metrics" / "dummy_share.py").write_text(
        '"""A dummy reader."""\n\n\ndef read(rec):\n'
        '    return 42.0 + len(rec["trace"]["calls"])\n')
    tr = MAN.traffic("stream512")
    tr.update(streams=3, period_ticks=8, warmup_ticks=1, trace_calls=2,
              check_streams=3)
    (bench / "traffic" / "stream3.json").write_text(json.dumps(tr))
    (bench / "limits" / "f32.stream3.json").write_text(
        (bench / "limits" / "f32.stream512.json").read_text())
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "f32.stream3",
                              "config": "mobileposer-f32",
                              "traffic": "stream3", "chips": 1,
                              "why": "a dummy cell"})
    data["per_layer"].append({"name": "dummy_share", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "frames_per_s",
                              "workloads": ["f32.stream3"]})
    for m in data["end_to_end"]:
        if m["name"] in ("frames_per_s", "tick_ms_p95"):
            m["workloads"].append("f32.stream3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    man = manifest.Manifest(tmp_path, bench)
    r = run.run_cell("f32.stream3", 9, 0.2, True, "cpu", manifest=man)
    assert r["correct"], r["checks"]
    assert r["metrics"]["dummy_share"] == {"value": 44.0, "unit": "%"}
    r = run.run_cell("f32.stream3", 9, 0.2, False, "cpu", manifest=man)
    assert set(r["metrics"]) == {"frames_per_s", "tick_ms_p95", "setup_s"}
