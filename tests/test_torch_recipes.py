"""The port's offline recipes against the JAX package on the CPU: the
finetune windows, `cli.finetune` (sequential, `--concurrent`, IMUPoser
chained off DIP), `cli.train --finetune`, `cli.overfit`, the TensorBoard
and wandb sinks, `cli.example` (offline and `--online`) and
`cli.combiner`.

Processed files are written with the port's fixture (numpy draws from a
seed, as the JAX fixture draws them) on a 240-vertex synthetic body in
both packages; the base checkpoints are the port's seeded random init;
the example weights are the trained fixture cast to float32. The two
packages draw dropout and noise from different generators, so training
runs are held on their layout, record keys and finite losses, not on
values. Tolerances are stated at each assert.
"""

import contextlib
import json
import os
import re

import numpy as np
import pytest
import torch

import jax

from mobileposer_tpu.cli import combiner as jax_combiner_cli
from mobileposer_tpu.cli import example as jax_example_cli
from mobileposer_tpu.cli import finetune as jax_finetune_cli
from mobileposer_tpu.cli import overfit as jax_overfit_cli
from mobileposer_tpu.data import PoseDataset as JaxPoseDataset
from mobileposer_tpu.data import load_processed_file as jax_load
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.train import init_train_state as jax_init_train_state
from mobileposer_tpu.utils.metrics import TensorBoardSink as JaxTBSink
from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.cli import combiner as combiner_cli
from mobileposer_tpu_torch.cli import example as example_cli
from mobileposer_tpu_torch.cli import finetune as finetune_cli
from mobileposer_tpu_torch.cli import overfit as overfit_cli
from mobileposer_tpu_torch.cli import train as train_cli
from mobileposer_tpu_torch.data import PoseDataset, load_processed_file
from mobileposer_tpu_torch.data.fixtures import make_synthetic_processed_dataset
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MODULE_CONFIGS, init_all_modules
from mobileposer_tpu_torch.nn.convert import (export_npz, load_npz,
                                              rnn_block_from_jax)
from mobileposer_tpu_torch.train import (MODULE_NAMES, Checkpointer,
                                         combine_weights, get_best_checkpoint)
from mobileposer_tpu_torch.utils.metrics import (TensorBoardSink, WandbSink,
                                                 make_sinks)

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the CPU path is thousands of small ops, which
    torch's thread pool slows down beside other busy test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


@contextlib.contextmanager
def _workspace_env(root, bodies):
    """MP_PROCESSED at the workspace and both packages' default body the
    240-vertex one."""
    jb, tb = bodies
    old = os.environ.get("MP_PROCESSED")
    os.environ["MP_PROCESSED"] = str(root / "processed")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxBody, "from_file_or_synthetic",
                       classmethod(lambda cls, f, **kw: jb))
            mp.setattr(ParametricModel, "from_file_or_synthetic",
                       classmethod(lambda cls, f, **kw: tb))
            yield
    finally:
        if old is None:
            os.environ.pop("MP_PROCESSED")
        else:
            os.environ["MP_PROCESSED"] = old


def _write_without_contact(path, n_sequences, T, seed, body):
    """A processed file in the DIP / IMUPoser schema (no contact)."""
    tmp = path.with_suffix(".tmp.pt")
    make_synthetic_processed_dataset(tmp, n_sequences=n_sequences, T=T,
                                     seed=seed, body_model=body)
    data = torch.load(tmp, weights_only=True)
    data.pop("contact")
    torch.save(data, path)
    tmp.unlink()


@pytest.fixture(scope="module")
def ws(tmp_path_factory, bodies):
    """The workspace: dip_train / imuposer_train (2 x 150 frames: 48
    samples, one finetune batch of 32 and a validation batch of 4),
    dip_test (one 60-frame sequence), a base run's per-module
    checkpoints, and the example weights."""
    root = tmp_path_factory.mktemp("recipes")
    ev = root / "processed" / "eval"
    ev.mkdir(parents=True)
    _write_without_contact(ev / "dip_train.pt", 2, 150, 3, bodies[1])
    _write_without_contact(ev / "imuposer_train.pt", 2, 150, 4, bodies[1])
    _write_without_contact(ev / "dip_test.pt", 1, 60, 5, bodies[1])
    base = init_all_modules(torch.Generator().manual_seed(0), device="cpu")
    for name in MODULE_NAMES:
        Checkpointer(root / "base" / name).save(base[name], 0, 1.0)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  load_from_npz(_FIXTURE))
    export_npz(tree, root / "weights.npz")
    return root


def _layout(d):
    """Every file under `d` as a relative path, checkpoint names reduced
    to their epoch (the validation losses differ between packages) and
    the resume file to its stem (the port writes its own `.pt`, the JAX
    package optax's `.npz`)."""
    out = []
    for p in d.rglob("*"):
        if p.is_file():
            rel = re.sub(r"valloss=[^/]*\.npz$", "valloss=*.npz",
                         str(p.relative_to(d)))
            out.append(re.sub(r"train_state\.(pt|npz)$", "train_state.*",
                              rel))
    return sorted(out)


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("dataset", ["dip", "imuposer"])
def test_finetune_windows_match_jax(ws, bodies, dataset):
    """The finetune fold of each set (no contact, global pose targets):
    the JAX package's windows and assembled batch, FK-derived fields at
    1e-5 (float32 FK), the rest equal."""
    with _workspace_env(ws, bodies):
        jds = JaxPoseDataset(fold="train", finetune=dataset,
                             body_model=bodies[0])
        ds = PoseDataset(fold="train", finetune=dataset,
                         body_model=bodies[1], device="cpu")
    assert len(ds) == len(jds) == 4 * 12
    for jw, w in zip(jds.windows, ds.windows):
        assert jw.keys() == w.keys()
        for k in w:
            if k in ("joints", "pose_r6d", "vels"):
                np.testing.assert_allclose(w[k], jw[k], atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(w[k], jw[k], err_msg=k)
        assert not w["contacts"].any()
    idxs = np.arange(0, 48, 5)
    got, want = ds._assemble(idxs, 125), jds._assemble(idxs, 125)
    for k in want:
        atol = 1e-5 if k in ("joints", "pose_r6d", "vels") else 0
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def jax_finetuned(ws, bodies, tmp_path_factory):
    """The JAX CLI's DIP finetune (sequential and --concurrent) and its
    IMUPoser finetune chained off the sequential one, each in a copy of
    the base run."""
    import shutil
    out = {}
    with _workspace_env(ws, bodies):
        for tag, extra in (("seq", []), ("conc", ["--concurrent"])):
            d = tmp_path_factory.mktemp(f"jax_{tag}")
            shutil.copytree(ws / "base", d, dirs_exist_ok=True)
            jax_finetune_cli.main(["--dataset", "dip", "--checkpoint-dir",
                                   str(d), "--fast-dev-run", *extra])
            out[tag] = d
        jax_finetune_cli.main(["--dataset", "imuposer", "--checkpoint-dir",
                               str(out["seq"]), "--fast-dev-run"])
    return out


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_cli_finetune_matches_jax_layout(ws, bodies, jax_finetuned,
                                         tmp_path, mode):
    """`cli.finetune --dataset dip` (and, sequentially, `--dataset
    imuposer` chained off `finetuned_dip`) on the CPU: the JAX CLI's
    directory layout and `metrics.jsonl` keys, finite losses, joints and
    poser warm-started from the base checkpoints, and
    `combine_weights(finetune=...)` reading the output."""
    import shutil
    shutil.copytree(ws / "base", tmp_path, dirs_exist_ok=True)
    extra = ["--concurrent"] if mode == "concurrent" else []
    with _workspace_env(ws, bodies):
        out = finetune_cli.main(["--dataset", "dip", "--checkpoint-dir",
                                 str(tmp_path), "--fast-dev-run",
                                 "--device", "cpu", *extra])
        if mode == "sequential":
            out_imu = finetune_cli.main(["--dataset", "imuposer",
                                         "--checkpoint-dir", str(tmp_path),
                                         "--fast-dev-run", "--device",
                                         "cpu"])
            assert out_imu == tmp_path / "finetuned_imuposer"
    assert out == tmp_path / "finetuned_dip"
    theirs = jax_finetuned["seq" if mode == "sequential" else "conc"]
    assert _layout(tmp_path) == _layout(theirs)
    for sub in (["finetuned_dip", "finetuned_imuposer"]
                if mode == "sequential" else ["finetuned_dip"]):
        mine = _records(tmp_path / sub / "metrics.jsonl")
        want = _records(theirs / sub / "metrics.jsonl")
        assert [sorted(r) for r in mine] == [sorted(r) for r in want]
        assert [r["module"] for r in mine] == [r["module"] for r in want]
        assert all(np.isfinite(r["train_loss"]) for r in mine)
    # warm start: the finetuned joints moved off the base weights by about
    # a step of lr = 5e-5 (fresh Adam moments move each entry by ~lr)
    base = load_npz(get_best_checkpoint(tmp_path / "joints"))
    tuned = load_npz(get_best_checkpoint(tmp_path / "finetuned_dip" /
                                         "joints"))
    d = np.abs(tuned["linear1"]["w"] - base["linear1"]["w"]).max()
    assert 0 < d <= 2 * C.finetune_hypers.lr * 1.01
    combined = combine_weights(tmp_path, finetune="dip")
    assert combined.name == "model_finetuned.npz"
    tree = load_npz(combined)
    assert set(tree) == set(MODULE_NAMES)
    np.testing.assert_array_equal(tree["joints"]["linear1"]["w"],
                                  tuned["linear1"]["w"])
    np.testing.assert_array_equal(
        tree["velocity"]["linear1"]["w"],
        load_npz(get_best_checkpoint(tmp_path / "velocity"))["linear1"]["w"])


def test_cli_finetune_refusals(ws, bodies, tmp_path):
    """No init checkpoints, or no finetune data: SystemExit, as the JAX
    CLI; no card: RuntimeError unless given a device."""
    with _workspace_env(ws, bodies):
        with pytest.raises(SystemExit, match="no init checkpoint"):
            finetune_cli.main(["--dataset", "dip", "--checkpoint-dir",
                               str(tmp_path), "--device", "cpu"])
        with pytest.raises(SystemExit, match="no init checkpoint"):
            finetune_cli.main(["--dataset", "imuposer", "--checkpoint-dir",
                               str(ws / "base"), "--device", "cpu"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            for cli, argv in (
                    (finetune_cli, ["--dataset", "dip", "--checkpoint-dir",
                                    str(tmp_path)]),
                    (overfit_cli, ["--synthetic"]),
                    (example_cli, ["--model", str(ws / "weights.npz")])):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    cli.main(argv)


def test_cli_train_finetune_dip(ws, bodies, tmp_path):
    """`cli.train --finetune dip --concurrent --fast-dev-run` reads only
    dip_train.pt with the finetune hyperparameters (batch 32: one step
    over the 43 training samples) and trains all four modules."""
    with _workspace_env(ws, bodies):
        train_cli.main(["--finetune", "dip", "--concurrent",
                        "--fast-dev-run", "--checkpoint-dir", str(tmp_path),
                        "--device", "cpu", "--metrics",
                        f"tensorboard:{tmp_path / 'tb'}"])
    records = _records(tmp_path / "metrics.jsonl")
    assert [r["module"] for r in records] == list(MODULE_NAMES)
    assert all(np.isfinite(r["train_loss"]) for r in records)
    for n in MODULE_NAMES:
        assert get_best_checkpoint(tmp_path / n) is not None
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_cli_overfit_matches_jax(ws, bodies, capsys):
    """`cli.overfit`: every module's parameter count equals the JAX
    state's; the printed lines have the JAX CLI's format and steps; the
    assembled batch equals the JAX CLI's; the loss falls."""
    for name in MODULE_NAMES:
        jstate = jax_init_train_state(name, jax.random.PRNGKey(0), 1e-3)
        assert overfit_cli.count_params(rnn_block_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate.params),
            MODULE_CONFIGS[name], "cpu")) == jax_overfit_cli.count_params(
                jstate.params)
    argv = ["--module", "footcontact", "--steps", "12", "--synthetic",
            "--batch-size", "4"]
    with _workspace_env(ws, bodies):
        jax_overfit_cli.main(argv)
        want = capsys.readouterr().out.splitlines()
        losses = overfit_cli.main(argv + ["--device", "cpu"])
        got = capsys.readouterr().out.splitlines()
    pattern = re.compile(r"step +\d+  loss -?\d+\.\d{6}$")
    assert got[0] == want[0]            # module footcontact: N parameters
    assert len(got) == len(want) == 4   # steps 0, 10, 11
    for g, w in zip(got[1:], want[1:]):
        assert pattern.match(g) and pattern.match(w)
        assert g.split("loss")[0] == w.split("loss")[0]
    assert len(losses) == 12 and losses[-1] < losses[0]
    # the batch: the JAX fixture's one 150-frame sequence, 4 samples
    jds = JaxPoseDataset(fold="train", body_model=bodies[0], data_files=[
        _jax_fixture(ws, bodies[0])])
    ds = PoseDataset(fold="train", body_model=bodies[1], device="cpu",
                     data_files=[make_synthetic_processed_dataset(
                         ws / "overfit_port.pt", n_sequences=1, T=150,
                         body_model=bodies[1])])
    got_b, want_b = ds._assemble(np.arange(4), 125), jds._assemble(
        np.arange(4), 125)
    for k in want_b:
        # FK-derived fields at 1e-5; the IMU holds the synthesized
        # acceleration / 30, at 1e-5 of its largest magnitude
        atol = (1e-5 * float(np.abs(want_b[k]).max())
                if k == "imu" else 1e-5)
        np.testing.assert_allclose(got_b[k], want_b[k], atol=atol,
                                   err_msg=k)


def _jax_fixture(ws, body):
    from mobileposer_tpu.data.fixtures import \
        make_synthetic_processed_dataset as jax_make
    return jax_make(ws / "overfit_jax.pt", n_sequences=1, T=150,
                    body_model=body)


_RECORDS = [
    {"module": "poser", "epoch": 0, "train_loss": 0.5, "val_loss": 0.25,
     "seconds": 1.5, "concurrent": True, "note": "text"},
    {"module": "joints", "epoch": 0, "train_loss": 1.25, "val_loss": 0.75},
    {"module": "poser", "epoch": 1, "train_loss": 0.125, "val_loss": 0.0625},
    {"train_loss": 3.0},
]


def _read_scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in sorted(acc.Tags()["scalars"])}


def test_tensorboard_sink_matches_jax(tmp_path):
    """The same records through each package's TensorBoard sink: event
    files with the same tags, steps and values."""
    for name, cls in (("jax", JaxTBSink), ("port", TensorBoardSink)):
        sink = cls(tmp_path / name)
        for r in _RECORDS:
            sink.log(r)
        sink.close()
    got, want = _read_scalars(tmp_path / "port"), _read_scalars(
        tmp_path / "jax")
    assert got == want
    assert got["poser/train_loss"] == [(0, 0.5), (1, 0.125)]
    assert got["train/train_loss"] == [(3, 3.0)]
    sink = make_sinks(f"tensorboard:{tmp_path / 'spec'},jsonl:"
                      f"{tmp_path / 'm.jsonl'}")
    sink.log(_RECORDS[1])
    sink.close()
    assert _read_scalars(tmp_path / "spec") == {
        "joints/train_loss": [(0, 1.25)], "joints/val_loss": [(0, 0.75)]}


def test_wandb_sink_raises_import_error_without_wandb():
    """wandb is not installed here: the sink refuses at construction
    rather than log nowhere, as the JAX sink does."""
    try:
        import wandb  # noqa: F401
        pytest.skip("wandb is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        WandbSink("proj")
    with pytest.raises(ImportError):
        make_sinks("wandb:proj")


@pytest.mark.parametrize("online", [False, True])
def test_cli_example_matches_jax(ws, bodies, tmp_path, online):
    """`cli.example` on the trained fixture over dip_test's sequence:
    pose.txt / tran.txt parse within 2e-4 of the JAX CLI's (values
    printed to 4 and 5 decimals, a last digit may round the other way);
    the .npz within 3e-5 (the slice's pin on a root translation summed
    over the frames)."""
    argv = ["--model", str(ws / "weights.npz"), "--dataset", "dip",
            *(["--online"] if online else [])]
    with _workspace_env(ws, bodies):
        jax_example_cli.main(argv + ["--out", str(tmp_path / "jax")])
        path = example_cli.main(argv + ["--out", str(tmp_path / "port"),
                                        "--device", "cpu"])
    assert path == tmp_path / "port" / "example_dip_0.npz"
    for fname in ("pose.txt", "tran.txt"):
        g = np.loadtxt(tmp_path / "port" / fname, delimiter=",")
        w = np.loadtxt(tmp_path / "jax" / fname, delimiter=",")
        assert g.shape == w.shape == ((60, 72) if fname == "pose.txt"
                                      else (60, 3))
        np.testing.assert_allclose(g, w, atol=2e-4, err_msg=fname)
    got = np.load(path)
    want = np.load(tmp_path / "jax" / "example_dip_0.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)


def test_cli_combiner_matches_jax(tmp_path):
    """`cli.combiner` writes the JAX CLI's `sequences` file exactly (five
    slots reordered, other layouts kept), which both loaders read."""
    rng = np.random.default_rng(7)
    for i, (T, slots) in enumerate(((10, 5), (7, 5), (4, 6))):
        np.savez(tmp_path / f"dev_{i}.npz",
                 acc=rng.standard_normal((T, slots, 3)).astype(np.float32),
                 ori=rng.standard_normal((T, slots, 4)).astype(np.float32),
                 pose=rng.standard_normal((T, 24, 3, 3)).astype(np.float32),
                 tran=rng.standard_normal((T, 3)).astype(np.float32))
    pattern = [str(tmp_path / "dev_*.npz")]
    jax_combiner_cli.main(["--sessions", *pattern, "--out",
                           str(tmp_path / "jax")])
    out = combiner_cli.main(["--sessions", *pattern, "--out",
                             str(tmp_path / "port")])
    assert out == tmp_path / "port.npz"
    for a, b in ((load_processed_file(out),
                  load_processed_file(tmp_path / "jax.npz")),
                 (jax_load(out), jax_load(tmp_path / "jax.npz"))):
        assert len(a) == len(b) == 3
        for sa, sb in zip(a, b):
            assert sorted(sa) == sorted(sb)
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k])
    first = load_processed_file(out)[0]
    raw = np.load(tmp_path / "dev_0.npz")
    np.testing.assert_array_equal(first["acc"], raw["acc"][:, [1, 4, 3, 0,
                                                               2]])
    with pytest.raises(SystemExit, match="no session"):
        combiner_cli.main(["--sessions", str(tmp_path / "none_*.npz")])
