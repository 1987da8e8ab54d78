"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the CUDA card unless the caller names a device."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mobileposer_tpu"}
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "mobileposer_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax(rel):
    bad = sorted(set(_imported_roots(ROOT / rel)) & FORBIDDEN)
    assert not bad, f"{rel} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import chip_smoke\n"
            "import mobileposer_tpu_torch.bench\n"
            "import mobileposer_tpu_torch.bench_turns\n"
            "import mobileposer_tpu_torch.cli.evaluate\n"
            "import mobileposer_tpu_torch.cli.train\n"
            "import mobileposer_tpu_torch.cli.combine_weights\n"
            "import mobileposer_tpu_torch.data.fixtures\n"
            "import mobileposer_tpu_torch.models\n"
            "import mobileposer_tpu_torch.nn.convert\n"
            "import mobileposer_tpu_torch.ops.lstm_cuda\n"
            "import mobileposer_tpu_torch.ops.lstm_train_cuda\n"
            "import mobileposer_tpu_torch.ops.multicell_cuda\n"
            "import mobileposer_tpu_torch.models.fused\n"
            "import mobileposer_tpu_torch.ops.quant\n"
            "import mobileposer_tpu_torch.train\n"
            f"bad = {sorted(FORBIDDEN)!r}\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_a_device_when_no_gpu(monkeypatch):
    from mobileposer_tpu_torch import bench
    from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixture = ROOT / "tests" / "fixtures" / "demo_checkpoint_f16.npz"
    for call in (MobilePoserNet, init_all_modules,
                 lambda: params_from_jax(load_npz(fixture)), bench.run,
                 lambda: bench.run(int8=True),
                 lambda: bench.run_forward(backend="fused")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for int8 in (False, True):
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench.run(device="cpu", int8=int8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.run_forward(device="cpu", backend="fused")
    net = MobilePoserNet(device="cpu")
    st = net.init_online_state_batched(2)
    assert st.vel_h.device.type == "cpu" and st.vel_h.shape == (2, 2, 256)


def test_bench_turns_needs_a_card(monkeypatch, tmp_path):
    """The two-tree cell timing refuses to run without a card; it never
    measures on the CPU."""
    from mobileposer_tpu_torch import bench_turns
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_turns.main(["--other", str(tmp_path)])


def test_eval_entry_points_need_a_device_when_no_gpu(monkeypatch):
    """RNNBlock, the evaluator, the dataset and the eval CLI resolve their
    device like every entry point: the card, or RuntimeError without one
    unless the caller names a device."""
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.data import PoseDataset
    from mobileposer_tpu_torch.evaluation import FullMotionEvaluator
    from mobileposer_tpu_torch.models import MODULE_CONFIGS
    from mobileposer_tpu_torch.nn import RNNBlock

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixture = ROOT / "tests" / "fixtures" / "demo_checkpoint_f16.npz"
    cfg = MODULE_CONFIGS["footcontact"]
    for call in (lambda: RNNBlock(cfg), FullMotionEvaluator,
                 lambda: PoseDataset(data_files=[]),
                 lambda: eval_cli.main(["--model", str(fixture)]),
                 lambda: eval_cli.main(["--model", str(fixture), "--int8"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    block = RNNBlock(cfg, device="cpu")
    assert block.linear1.weight.device.type == "cpu"
    assert block.lstm[0]["fwd"].w_hh.device.type == "cpu"
    # quantizing keeps the modules where they are
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    qblock = quantize_params_int8(block)
    assert qblock.lstm[0]["fwd"].w_hh.device.type == "cpu"
    assert qblock.lstm[0]["fwd"].w_hh.dtype == torch.int8


def test_train_entry_points_need_a_device_when_no_gpu(monkeypatch):
    """The trainer, the train CLI and the training bench resolve their
    device like every entry point."""
    from mobileposer_tpu_torch import bench
    from mobileposer_tpu_torch.cli import train as train_cli
    from mobileposer_tpu_torch.train import TrainingManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (TrainingManager, lambda: train_cli.main(["--fast-dev-run"]),
                 bench.run_train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert TrainingManager(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_checkout(alone, tmp_path):
    """No CUDA device here: the script must exit non-zero and print no
    result, in the checkout and copied into an empty directory."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
