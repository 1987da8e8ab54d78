"""What a run loads: no module whose top-level name, compared whole, is
JAX's or the JAX package's; the reference loads nothing of the program;
without a card, or without the program beside it, a run prints no
result and exits with another code than 0."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.tests.helpers import small_traffic

MAN = manifest.Manifest()
ROOT = str(MAN.root)
FORBIDDEN = {"jax", "jaxlib", "flax", "mobileposer_tpu"}


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN.data["workloads"]])
def test_a_run_loads_no_jax(cell):
    tr = json.dumps(small_traffic(MAN, cell))
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from portbench import run
r = run.run_cell({cell!r}, 5, 0.2, True, "cpu", traffic=json.loads({tr!r}))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "mobileposer_tpu_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys
import portbench.reference.model, portbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "mobileposer_tpu_torch" not in top and not top & FORBIDDEN


def test_the_forbidden_names_are_compared_whole():
    from portbench import run
    sys.modules.setdefault("mobileposer_tpu_torchish", sys)
    try:
        assert "mobileposer_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["mobileposer_tpu_torchish"]


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "f32.stream512", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(MAN.root / "BENCHMARK.json", tmp_path)
    shutil.copytree(MAN.bench, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    tr = json.dumps(small_traffic(MAN, "f32.stream512"))
    code = f"""
import json, sys
from portbench import run
r = run.run_cell("f32.stream512", 5, 0.2, False, "cpu",
                 traffic=json.loads({tr!r}))
print(json.dumps(r))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _python(code, cwd=str(tmp_path), env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "mobileposer_tpu_torch" in p.stderr
