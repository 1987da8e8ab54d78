"""The port's carry-mode streaming and single-stream streaming against
the JAX package, on the CPU: the LSTM cell steps, `forward_carry_
sequence_batched` (float32 and W8A8) through warm-up and a mid-stream
reset, `forward_online_sequence`, `evaluate_pose(online_mode='carry')`,
`cli.evaluate --online-mode carry` and the stream-age drift metrics of
`evaluation/drift.py` in both modes.

Weights cross with `nn.convert.params_from_jax` (the trained fixture);
inputs are made with numpy from a seed. Tolerances: 2e-5 on outputs and
states in float32 (the pin of tests/test_torch_net.py); int8 2e-3, a few
flips' worth (tests/test_torch_quant.py explains flips); metric tables
rtol 1e-3 + atol 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import jax

import mobileposer_tpu.evaluation.evaluator as jax_ev_mod
from mobileposer_tpu.cli import evaluate as jax_eval_cli
from mobileposer_tpu.data import EvalSequence as JaxEvalSequence
from mobileposer_tpu.data import PoseDataset as JaxPoseDataset
from mobileposer_tpu.data.fixtures import make_synthetic_processed_dataset
from mobileposer_tpu.evaluation import drift as jax_drift
from mobileposer_tpu.evaluation import evaluate_pose as jax_evaluate_pose
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.kinematics import smpl as jax_smpl
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.nn.lstm import lstm_cell_step as jax_cell_step
from mobileposer_tpu.ops import quant as jq
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.evaluation import drift, evaluate_pose, pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, OnlineState
from mobileposer_tpu_torch.models import streaming
from mobileposer_tpu_torch.nn import lstm_cell_step
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.ops.quant import quantize_params_int8

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")
ATOL, ATOL_INT8 = 2e-5, 2e-3
RTOL_TABLE, ATOL_TABLE = 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: one torch thread beside other busy test
    processes, as tests/test_torch_eval.py runs them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


@pytest.fixture(scope="module")
def nets(bodies):
    return JaxNet(bodies[0]), MobilePoserNet(bodies[1], device="cpu")


@pytest.fixture(scope="module")
def weights():
    """{'float32' / 'int8': (jax tree, the port's modules)}, the trained
    fixture (f16 archive computed in f32) and each package's own W8A8
    quantization of it."""
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  load_from_npz(_FIXTURE))
    params = params_from_jax(tree, device="cpu")
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_params_int8(tree))
    return {"float32": (tree, params),
            "int8": (qtree, quantize_params_int8(params))}


def _leaves(x):
    """A (nested) state's arrays, in field order."""
    if isinstance(x, tuple):
        return [a for v in x for a in _leaves(v)]
    return [x]


def _reset_stream(state, slot, feet, xp):
    """The server's slot reset (stream/server.py of either package): the
    flag cleared and the fusion anchors restored. xp is np or torch."""
    def put(a, v):
        a = xp.asarray(a).copy() if xp is np else a.clone()
        a[slot] = v
        return a
    return state._replace(
        initialized=put(state.initialized, False),
        last_lfoot=put(state.last_lfoot, feet[0]),
        last_rfoot=put(state.last_rfoot, feet[1]),
        current_root_y=put(state.current_root_y, 0.0),
        last_root_pos=put(state.last_root_pos, 0.0))


def _assert_outputs(got, want, atol, where):
    for name, g, w in zip(("pose", "joints", "root", "contact"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (where, name)
        np.testing.assert_allclose(g.numpy(), w, atol=atol,
                                   err_msg=f"{where}: {name}")


def _assert_states(got, want, atol, where):
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (where, i)
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   w.astype(np.float32), atol=atol,
                                   err_msg=f"{where}: state leaf {i}")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_lstm_cell_step_matches_jax(dtype, weights):
    """One step of each direction of the joints' first layer: the
    float route 1e-6; the int8 route quantizes ~2k elements, 1e-6 too."""
    tree, params = weights[dtype]
    rng = np.random.RandomState(3)
    x = (rng.randn(5, 256) * 0.5).astype(np.float32)
    h = (rng.randn(5, 256) * 0.3).astype(np.float32)
    c = (rng.randn(5, 256) * 0.3).astype(np.float32)
    for d in ("fwd", "bwd"):
        want = jax_cell_step(tree["joints"]["lstm"][0][d], x, h, c)
        got = lstm_cell_step(params["joints"].lstm[0][d],
                             *map(torch.from_numpy, (x, h, c)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_forward_carry_sequence_matches_jax(dtype, nets, weights):
    """S=3 streams x N=12 frames from a fresh state (the warm-up rings):
    6 frames, a reset of stream 1 as the server makes it, 6 more; outputs
    of both calls and the states after each."""
    jnet, net = nets
    tree, params = weights[dtype]
    atol = ATOL_INT8 if dtype == "int8" else ATOL
    run = jax.jit(jnet.forward_carry_sequence_batched)
    S = 3
    rng = np.random.RandomState(21)
    jst = jnet.init_carry_state_batched(S)
    st = net.init_carry_state_batched(S)
    _assert_states(st, jst, 0.0, "init")
    feet = np.asarray(jnet.feet_pos, np.float32)
    for call in ("warm-up", "after reset"):
        frames = (rng.randn(6, S, 60) * 0.1).astype(np.float32)
        want, jst = run(tree, jst, frames)
        with torch.no_grad():
            got, st = net.forward_carry_sequence_batched(
                params, st, torch.from_numpy(frames))
        _assert_outputs(got, want, atol, call)
        _assert_states(st, jst, atol, call)
        assert type(st) is streaming.CarryState
        jst = _reset_stream(jax.tree_util.tree_map(np.asarray, jst), 1,
                            feet, np)
        st = _reset_stream(st, 1, torch.from_numpy(feet), torch)


def test_forward_online_sequence_matches_jax(nets, weights):
    """One stream, N=8 frames fresh, then 5 continued from its state."""
    jnet, net = nets
    tree, params = weights["float32"]
    run = jax.jit(jnet.forward_online_sequence)
    rng = np.random.RandomState(5)
    jst = jnet.init_online_state()
    st = net.init_online_state()
    for g, w in zip(st, jst):
        assert tuple(g.shape) == np.shape(w)
    for N in (8, 5):
        frames = (rng.randn(N, 60) * 0.1).astype(np.float32)
        want, jst = run(tree, jst, frames)
        with torch.no_grad():
            got, st = net.forward_online_sequence(params, st,
                                                  torch.from_numpy(frames))
        _assert_outputs(got, want, ATOL, f"N={N}")
        for name, g, w in zip(OnlineState._fields, st, jst):
            np.testing.assert_allclose(
                g.numpy().astype(np.float32), np.asarray(w, np.float32),
                atol=ATOL, err_msg=f"state.{name}")
    # one step of forward_online is the first output of the sequence
    frame = torch.from_numpy((rng.randn(60) * 0.1).astype(np.float32))
    with torch.no_grad():
        (pose, _, root, _), _ = net.forward_online(params, st, frame)
        (poses, _, roots, _), _ = net.forward_online_sequence(
            params, st, frame[None])
    np.testing.assert_array_equal(pose.numpy(), poses[0].numpy())
    np.testing.assert_array_equal(root.numpy(), roots[0].numpy())


@pytest.fixture(scope="module")
def eval_env(tmp_path_factory, bodies):
    """Two sequences (40 and 70 frames) written by the JAX package, the
    512-frame bucket shrunk to 128 in both packages (as
    tests/test_torch_eval.py does), the CLIs on the small bodies."""
    d = tmp_path_factory.mktemp("carry_eval")
    make_synthetic_processed_dataset(d / "synthetic.pt", n_sequences=2,
                                     T=55, seed=41, body_model=bodies[0])
    mp = pytest.MonkeyPatch()
    mp.setenv("MP_PROCESSED", str(d))
    mp.setattr(jax_ev_mod, "_BUCKET", 128)
    mp.setattr(pose_eval, "_BUCKET", 128)
    mp.setattr(jax_smpl.ParametricModel, "from_file_or_synthetic",
               classmethod(lambda cls, f: bodies[0]))
    mp.setattr(ParametricModel, "from_file_or_synthetic",
               classmethod(lambda cls, f: bodies[1]))
    yield d
    mp.undo()


def _assert_tables(got, want):
    for k in ("offline", "online"):
        assert got[k].shape == (8, 2) and np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_TABLE,
                                   atol=ATOL_TABLE, err_msg=k)


def test_evaluate_pose_carry_matches_jax(eval_env, bodies, nets, weights):
    """Offline and ONLINE carry-mode tables, trained weights."""
    jnet, net = nets
    tree, params = weights["float32"]
    files = [eval_env / "synthetic.pt"]
    jds = JaxPoseDataset(fold="test", evaluate="dip", body_model=bodies[0],
                         data_files=files)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=bodies[1],
                     data_files=files, device="cpu")
    want = jax_evaluate_pose(jnet, tree, JaxEvalSequence(jds), online=True,
                             online_mode="carry", verbose=False)
    got = evaluate_pose(net, params, EvalSequence(ds), online=True,
                        online_mode="carry", verbose=False)
    _assert_tables(got, want)
    exact = evaluate_pose(net, params, EvalSequence(ds), online=True,
                          verbose=False)
    # the two modes' ONLINE tables differ (carry keeps forward context);
    # the offline tables are the same pass
    np.testing.assert_array_equal(exact["offline"], got["offline"])
    assert not np.allclose(exact["online"], got["online"])
    with pytest.raises(ValueError, match="batch_sequences"):
        evaluate_pose(net, params, EvalSequence(ds), online=True,
                      online_mode="carry", batch_sequences=False)


def test_cli_evaluate_carry_matches_jax_cli(eval_env, monkeypatch, capsys):
    """`cli.evaluate --online --online-mode carry --device cpu` against
    the JAX CLI with the same flags (its `evaluate_pose` result
    captured)."""
    captured = {}
    real = jax_eval_cli.evaluate_pose

    def capture(*a, **k):
        captured.update(real(*a, **k))
        return captured

    monkeypatch.setattr(jax_eval_cli, "evaluate_pose", capture)
    flags = ["--model", _FIXTURE, "--dataset", "synthetic", "--online",
             "--online-mode", "carry"]
    jax_eval_cli.main(flags)
    got = eval_cli.main(flags + ["--device", "cpu"])
    assert "online" in capsys.readouterr().out
    _assert_tables(got, captured)


@pytest.mark.parametrize("mode", ["exact", "carry"])
def test_windowed_stream_metrics_matches_jax(mode, bodies, nets, weights):
    """S=2 streams of N=24 synthetic frames in 3 windows of 8, with the
    translation-drift windows: the motions bit for bit, the synthesized
    frames rtol 1e-5 + atol 1e-5, the per-window curves rtol 1e-3 + atol
    1e-4."""
    jnet, net = nets
    tree, params = weights["float32"]
    aa, tran = drift.make_stream_motion(np.random.default_rng(0), 24, 2)
    jaa, jtran = jax_drift.make_stream_motion(np.random.default_rng(0), 24, 2)
    np.testing.assert_array_equal(aa, jaa)
    np.testing.assert_array_equal(tran, jtran)
    jframes = jax_drift.synthesize_stream_frames(bodies[0], aa, tran,
                                                 chunk=16)
    frames = drift.synthesize_stream_frames(bodies[1], aa, tran, chunk=16,
                                            device="cpu")
    # accelerations are second differences of vertex positions times
    # fps^2 / acc_scale = 120: the positions' float32 rounding, so rtol
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes),
                               rtol=1e-5, atol=1e-5)
    # ground truth stretched to metres of travel a window, so that the
    # 1-7 m drift windows occur (drift reads it, the frames do not)
    tran_gt = tran * 40.0
    want = jax_drift.windowed_stream_metrics(jnet, tree, jframes, aa, mode,
                                             window=8, tran_gt=tran_gt)
    got = drift.windowed_stream_metrics(net, params, frames, aa, mode,
                                        window=8, tran_gt=tran_gt)
    assert got.keys() == want.keys()
    for k in ("sip_deg", "pos_cm", "tran_drift_m"):
        assert got[k].shape == want[k].shape == (3, 2), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_TABLE,
                                   atol=ATOL_TABLE, err_msg=k)
    for w in want["tran_drift_per_w"]:
        np.testing.assert_allclose(got["tran_drift_per_w"][w],
                                   want["tran_drift_per_w"][w],
                                   rtol=RTOL_TABLE, atol=ATOL_TABLE)
    with pytest.raises(ValueError, match="unknown mode"):
        drift.make_window_stepper(net, params, "windowed")
