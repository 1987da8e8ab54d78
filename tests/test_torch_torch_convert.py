"""The reference's torch checkpoints in the port (`nn/torch_convert.py`,
`models.utils.load_model`) against the JAX package, on the CPU, and the
CLIs that take them: `cli.evaluate`, `cli.serve`, `cli.train --init-from`,
`combine_weights --export-torch` and the parity harness's dry run.

Checkpoints are written inside the tests by the JAX package's
`save_torch_checkpoint` (the reference's combined `state_dict` layout)
from its random `init_all_modules(PRNGKey(0))` and from the trained
fixture. Every weight check is bit for bit: conversion is a transpose.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mobileposer_tpu.cli import combine_weights as jax_combine_cli
from mobileposer_tpu.data.fixtures import \
    make_synthetic_processed_dataset as jax_make_dataset
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.models.modules import MODULE_CONFIGS as JAX_CONFIGS
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.nn import torch_convert as jtc
from mobileposer_tpu_torch.cli import combine_weights as combine_cli
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.cli import parity as parity_cli
from mobileposer_tpu_torch.cli import serve as serve_cli
from mobileposer_tpu_torch.cli import train as train_cli
from mobileposer_tpu_torch.data import fixtures
from mobileposer_tpu_torch.evaluation import pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn import torch_convert as tc
from mobileposer_tpu_torch.nn.convert import (export_npz, params_from_jax,
                                              params_to_jax)
from mobileposer_tpu_torch.stream import PoseServer
from mobileposer_tpu_torch.train import trainer

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees():
    """{name: the JAX params tree as float32 numpy}: random and trained."""
    random = jax.tree_util.tree_map(
        np.asarray, jax_init_all_modules(jax.random.PRNGKey(0)))
    trained = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                     load_from_npz(_FIXTURE))
    return {"random": random, "trained": trained}


@pytest.fixture(scope="module")
def pth(trees, tmp_path_factory):
    """{name: a reference-format .pth the JAX package wrote}."""
    d = tmp_path_factory.mktemp("pth")
    out = {}
    for name, tree in trees.items():
        out[name] = d / f"{name}.pth"
        jtc.save_torch_checkpoint(tree, str(out[name]))
    return out


@pytest.fixture(scope="module")
def body():
    return ParametricModel.synthetic(num_vertices=240)


def _assert_trees_equal(got, want):
    g, w = (jax.tree_util.tree_leaves(t) for t in (got, want))
    assert len(g) == len(w)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(g, w):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("which", ["random", "trained"])
def test_pth_loads_as_jax_converts_it(pth, which):
    """A .pth written by the JAX package's `save_torch_checkpoint` loads
    through the port's `load_model` into the tree the JAX package's
    `convert_mobileposer_checkpoint` gives, bit for bit; so does the
    state_dict loaded by hand and `convert_rnn_state_dict` per block."""
    want = jtc.convert_mobileposer_checkpoint(str(pth[which]), JAX_CONFIGS)
    want = jax.tree_util.tree_map(np.asarray, want)
    _assert_trees_equal(load_model(pth[which]), want)
    sd = tc.load_torch_state_dict(pth[which])
    for name, prefix in tc.COMBINED_PREFIXES.items():
        _assert_trees_equal(
            tc.convert_rnn_state_dict(sd, prefix, MODULE_CONFIGS[name]),
            want[name])
    # a Lightning checkpoint's state_dict, as the reference saves them
    lightning = pth[which].with_suffix(".ckpt")
    torch.save({"state_dict": torch.load(pth[which], weights_only=True),
                "epoch": 3}, lightning)
    _assert_trees_equal(tc.convert_mobileposer_checkpoint(
        lightning, MODULE_CONFIGS), want)


@pytest.mark.parametrize("which", ["random", "trained"])
def test_export_to_torch_state_dict_equals_jax(trees, tmp_path, which):
    """`export_to_torch_state_dict` of the port equals the JAX package's,
    key for key and bit for bit, from the tree and from the port's
    modules (`params_to_jax`); `save_torch_checkpoint` writes what the JAX
    package's writes and round-trips through `load_model`."""
    tree = trees[which]
    want = jtc.export_to_torch_state_dict(tree)
    for got in (tc.export_to_torch_state_dict(tree),
                tc.export_to_torch_state_dict(params_to_jax(
                    params_from_jax(tree, device="cpu")))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tc.save_torch_checkpoint(tree, tmp_path / "port.pth")
    jtc.save_torch_checkpoint(tree, str(tmp_path / "jax.pth"))
    mine = torch.load(tmp_path / "port.pth", weights_only=True)
    theirs = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert torch.equal(mine[k], theirs[k]), k
    _assert_trees_equal(load_model(tmp_path / "port.pth"), tree)


def test_combine_weights_export_torch_equals_jax(trees, tmp_path, capsys):
    """`combine_weights --export-torch` writes the .pth the JAX package's
    CLI writes from the same checkpoint dir, and the combined .npz."""
    ckpt = tmp_path / "ckpt"
    for name, block in trees["trained"].items():
        (ckpt / name).mkdir(parents=True)
        export_npz(block, ckpt / name / "epoch=0-valloss=1.0000.npz")
    out = combine_cli.main(["--checkpoint-dir", str(ckpt), "--out",
                            str(tmp_path / "port.npz"), "--export-torch",
                            str(tmp_path / "port.pth")])
    assert "Reference-format torch checkpoint written" in \
        capsys.readouterr().out
    jax_combine_cli.main(["--checkpoint-dir", str(ckpt), "--out",
                          str(tmp_path / "jax.npz"), "--export-torch",
                          str(tmp_path / "jax.pth")])
    mine = torch.load(tmp_path / "port.pth", weights_only=True)
    theirs = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert torch.equal(mine[k], theirs[k]), k
    _assert_trees_equal(load_model(out), trees["trained"])


class _NotATensor:
    """An arbitrary object in a checkpoint."""


def test_load_model_refuses_pickled_objects(tmp_path):
    """`torch.load(weights_only=True)`: a checkpoint that needs arbitrary
    unpickling is refused, not executed."""
    torch.save({"joints.joints.linear1.weight": _NotATensor()},
               tmp_path / "evil.pth")
    with pytest.raises(Exception, match="[Ww]eights only load failed"):
        load_model(tmp_path / "evil.pth")


# ---------------------------------------------------------------------------
# The CLIs take a .pth
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory, body):
    """$MP_PROCESSED with a 2 x 60-frame training file (the port's
    fixture), `synthetic.pt` and `eval/dip_test.pt` (the JAX package's,
    as tests/test_cli.py writes them); the 512-frame bucket shrunk to 128
    and the CLIs kept on the small synthetic body."""
    ws = tmp_path_factory.mktemp("pth_cli")
    jbody = JaxBody.synthetic(num_vertices=240)
    fixtures.make_synthetic_processed_dataset(
        ws / "train" / "t.pt", n_sequences=2, T=60, seed=1, body_model=body)
    jax_make_dataset(ws / "eval_root" / "synthetic.pt", n_sequences=2, T=60,
                     seed=40, body_model=jbody)
    jax_make_dataset(ws / "eval_root" / "eval" / "dip_test.pt",
                     n_sequences=1, T=60, seed=1, body_model=jbody)
    mp = pytest.MonkeyPatch()
    mp.setattr(pose_eval, "_BUCKET", 128)
    mp.setattr(ParametricModel, "from_file_or_synthetic",
               classmethod(lambda cls, *a, **k: body))
    yield ws
    mp.undo()


def test_cli_evaluate_takes_pth(workspace, pth, trees, monkeypatch, capsys):
    """`cli.evaluate --model model.pth --device cpu` evaluates the weights
    the .pth holds."""
    monkeypatch.setenv("MP_PROCESSED", str(workspace / "eval_root"))
    seen = []

    def spy(net, params, *args, **kwargs):
        seen.append(params)
        return pose_eval.evaluate_pose(net, params, *args, **kwargs)

    monkeypatch.setattr(eval_cli, "evaluate_pose", spy)
    res = eval_cli.main(["--model", str(pth["trained"]), "--dataset",
                         "synthetic", "--device", "cpu"])
    assert res["offline"].shape == (8, 2)
    assert np.all(np.isfinite(res["offline"]))
    _assert_modules_equal(seen[0], params_from_jax(trees["trained"],
                                                   device="cpu"))
    assert "SIP Error" in capsys.readouterr().out


def test_cli_serve_takes_pth(pth, trees, monkeypatch, body):
    """`cli.serve`'s `build_server` loads a .pth into the server."""
    monkeypatch.setattr(ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, *a, **k: body))
    built = []

    class Recorded(PoseServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self.params)

    monkeypatch.setattr(serve_cli, "PoseServer", Recorded)
    stats = serve_cli.main(["--model", str(pth["random"]), "--port", "0",
                            "--duration", "0.1", "--device", "cpu"])
    assert stats["frames_served"] == 0
    _assert_modules_equal(built[0], params_from_jax(trees["random"],
                                                    device="cpu"))


def test_cli_train_init_from_pth(workspace, pth, trees, monkeypatch,
                                 tmp_path):
    """`cli.train --init-from model.pth` starts each module from the
    weights the .pth holds (one fast-dev-run module on the CPU)."""
    monkeypatch.setenv("MP_PROCESSED", str(workspace / "train"))
    starts = []
    train_module = trainer.TrainingManager.train_module

    def spy(self, name, *args, init_params=None, **kwargs):
        starts.append((name, init_params))
        return train_module(self, name, *args, init_params=init_params,
                            **kwargs)

    monkeypatch.setattr(trainer.TrainingManager, "train_module", spy)
    ckpt = train_cli.main(["--module", "footcontact", "--fast-dev-run",
                           "--checkpoint-dir", str(tmp_path / "ckpt"),
                           "--init-from", str(pth["trained"]),
                           "--device", "cpu"])
    assert [n for n, _ in starts] == ["footcontact"]
    _assert_trees_equal(starts[0][1], trees["trained"]["footcontact"])
    assert trainer.get_best_checkpoint(Path(ckpt) / "footcontact")


def test_cli_export_serving_takes_pth(pth, trees, tmp_path, monkeypatch,
                                      body):
    """`cli.export_serving --model model.pth` ships the .pth's weights."""
    from mobileposer_tpu_torch.cli import export_serving as export_cli
    monkeypatch.setattr(ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, *a, **k: body))
    out = export_cli.main(["--out", str(tmp_path / "b"), "--model",
                           str(pth["random"]), "--mode", "carry",
                           "--streams", "2", "--device", "cpu"])
    _assert_trees_equal(load_from_npz(str(Path(out) / "weights.npz")),
                        trees["random"])


def test_parity_cli_dry_run(workspace, pth, monkeypatch, capsys):
    """The parity harness on the synthetic fixture (tests/test_cli.py's
    dry run): the .pth loads, the evaluation runs, the port's metrics
    print (no reference metrics: informational, exit 0), and it refuses
    to gate against reference numbers on a non-official body."""
    monkeypatch.setenv("MP_PROCESSED", str(workspace / "eval_root"))
    parity_cli.main(["--torch-checkpoint", str(pth["random"]), "--device",
                     "cpu"])
    out = capsys.readouterr().out
    assert "official SMPL file not found" in out
    ours = json.loads([ln for ln in out.splitlines() if '"ours"' in ln][0])
    assert np.isfinite(ours["ours"]["sip_deg"])
    assert np.isfinite(ours["ours"]["pos_cm"])
    ref = workspace / "ref_metrics.json"
    ref.write_text(json.dumps(ours["ours"]))
    with pytest.raises(SystemExit):
        parity_cli.main(["--torch-checkpoint", str(pth["random"]),
                         "--reference-metrics", str(ref), "--device", "cpu"])
