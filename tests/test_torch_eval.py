"""The port's evaluation path against the JAX package, on the CPU: FK and
skinning, the rotation log map, the metric suite, offline inference over
ragged batches, the dataset views, `evaluate_pose` end to end and the CLI.

Weights cross with `nn.convert.params_from_jax` (random
`init_all_modules(PRNGKey(0))` and the trained fixture); data is made with
numpy from a seed, or written by the JAX package's
`make_synthetic_processed_dataset`. Tolerances are stated at each assert.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mobileposer_tpu.evaluation.evaluator as jax_ev_mod
from mobileposer_tpu.data import EvalSequence as JaxEvalSequence
from mobileposer_tpu.data import PoseDataset as JaxPoseDataset
from mobileposer_tpu.data.fixtures import make_synthetic_processed_dataset
from mobileposer_tpu.evaluation import FullMotionEvaluator as JaxEvaluator
from mobileposer_tpu.evaluation import evaluate_pose as jax_evaluate_pose
from mobileposer_tpu.evaluation import \
    forward_offline_batched as jax_offline_batched
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.kinematics import rotation as JR
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.evaluation import (FullMotionEvaluator,
                                              binary_classification_errors,
                                              evaluate_pose,
                                              forward_offline_batched)
from mobileposer_tpu_torch.evaluation import pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
from mobileposer_tpu_torch.nn.torch_convert import save_torch_checkpoint

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")
# the pins of tests/test_torch_net.py for per-frame outputs
ATOL = 2e-5
# Root translation is a cumulative sum over up to 20 frames here: each
# frame's velocity carries the 2e-5 output error / 15 (VEL_SCALE), so 3e-5
# holds as in tests/test_torch_net.py.
ATOL_TRAN = 3e-5
# Metric tables are means of per-frame errors in cm, degrees and m/s^3;
# the rows agree relatively (jerk rows are scaled by fps^3 = 27,000, so
# an absolute bound would be meaningless there).
RTOL_TABLE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of small ops; with torch's default
    thread pool beside other busy test processes, its threads wait on one
    another at every op (a ~10x slowdown on a shared machine). One thread
    is as fast here when the machine is idle."""
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
    """{name: (jax params as numpy, the port's modules)}."""
    random = jax.tree_util.tree_map(
        np.asarray, jax_init_all_modules(jax.random.PRNGKey(0)))
    trained = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                     load_from_npz(_FIXTURE))
    return {name: (tree, params_from_jax(tree, device="cpu"))
            for name, tree in (("random", random), ("trained", trained))}


def _random_poses(rng, n, scale=0.6):
    aa = (rng.randn(n * 24, 3) * scale).astype(np.float32)
    return np.array(JR.axis_angle_to_rotation_matrix(aa)).reshape(
        n, 24, 3, 3)


def test_forward_kinematics_and_angle_between_match_jax(bodies):
    rng = np.random.RandomState(0)
    pose = _random_poses(rng, 40)
    tran = rng.randn(40, 3).astype(np.float32)
    want = bodies[0].forward_kinematics(jnp.asarray(pose),
                                        tran=jnp.asarray(tran), calc_mesh=True)
    got = bodies[1].forward_kinematics(torch.from_numpy(pose),
                                       tran=torch.from_numpy(tran),
                                       calc_mesh=True)
    for g, w in zip(got, want):            # rotations, joints, vertices
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    got_aa = R.axis_angle_to_rotation_matrix(
        torch.from_numpy(np.full((1, 3), 0.3, np.float32)))
    np.testing.assert_allclose(
        got_aa.numpy(), np.asarray(JR.axis_angle_to_rotation_matrix(
            np.full((1, 3), 0.3, np.float32))), atol=1e-6)

    p1 = pose.reshape(-1, 3, 3)
    p2 = _random_poses(rng, 40, scale=1.5).reshape(-1, 3, 3)
    p2[:5] = p1[:5]                                    # angle 0
    axis = rng.randn(5, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    p2[5:10] = p1[5:10] @ np.asarray(JR.axis_angle_to_rotation_matrix(
        (axis * (np.pi - 1e-4)).astype(np.float32)))   # angle near pi
    want = np.asarray(JR.radian_to_degree(
        JR.angle_between(jnp.asarray(p1), jnp.asarray(p2))))
    got = R.radian_to_degree(R.angle_between(torch.from_numpy(p1),
                                             torch.from_numpy(p2))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)   # degrees
    np.testing.assert_array_equal(
        R.rotation_matrix_to_r6d(torch.from_numpy(p1)).numpy(),
        np.asarray(JR.rotation_matrix_to_r6d(jnp.asarray(p1))))


@pytest.mark.parametrize("n", [200, 530])
def test_full_motion_evaluator_matches_jax(n, bodies):
    """N below and above the JAX package's 512-frame bucket: the port
    computes on the N frames, the JAX package on the padded bucket with
    masked statistics."""
    rng = np.random.RandomState(n)
    pose_t = _random_poses(rng, n, 0.5)
    pose_p = np.array(JR.axis_angle_to_rotation_matrix(
        (rng.randn(n * 24, 3) * 0.05).astype(np.float32))).reshape(
            n, 24, 3, 3) @ pose_t
    tran_t = np.cumsum(rng.randn(n, 3) * 0.01, 0).astype(np.float32)
    tran_p = tran_t + (rng.randn(n, 3) * 0.02).astype(np.float32)
    want = JaxEvaluator(bodies[0])(pose_p, pose_t, tran_p, tran_t)
    got = FullMotionEvaluator(bodies[1], device="cpu")(pose_p, pose_t,
                                                       tran_p, tran_t)
    assert got.shape == (10, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL_TABLE, atol=1e-6)


def test_binary_metrics_match_jax():
    from mobileposer_tpu.evaluation import \
        binary_classification_errors as jax_binary
    rng = np.random.RandomState(3)
    logits = rng.randn(50).astype(np.float32)
    labels = (rng.rand(50) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        binary_classification_errors(torch.from_numpy(logits),
                                     torch.from_numpy(labels)).numpy(),
        np.asarray(jax_binary(jnp.asarray(logits), jnp.asarray(labels))),
        atol=1e-7)


@pytest.mark.parametrize("which", ["random", "trained"])
def test_forward_offline_matches_jax(which, nets, weights):
    """A ragged batch (lengths 20, 11, 3 padded to 20) through the batched
    offline path, and each sequence alone through forward_offline, held
    to the JAX package on every valid prefix."""
    jnet, net = nets
    tree, params = weights[which]
    rng = np.random.RandomState(7)
    lengths = np.array([20, 11, 3], np.int32)
    imus = (rng.randn(3, 20, 60) * 0.3).astype(np.float32)
    want = jax_offline_batched(jnet, tree, jnp.asarray(imus),
                               jnp.asarray(lengths))
    got = forward_offline_batched(net, params, torch.from_numpy(imus),
                                  torch.from_numpy(lengths))
    for i, L in enumerate(lengths):
        for name, g, w in zip(("pose", "joints", "tran", "contact"), got,
                              want):
            np.testing.assert_allclose(
                g[i, :L].numpy(), np.asarray(w)[i, :L],
                atol=ATOL_TRAN if name == "tran" else ATOL,
                err_msg=f"{which} row {i} {name}")
            assert bool(torch.isfinite(g[i]).all())    # padding included
        single = net.forward_offline(params, torch.from_numpy(imus[i]),
                                     length=int(L))
        for name, g, w in zip(("pose", "joints", "tran", "contact"), single,
                              want):
            np.testing.assert_allclose(
                g[:L].numpy(), np.asarray(w)[i, :L].reshape(g[:L].shape),
                atol=ATOL_TRAN if name == "tran" else ATOL,
                err_msg=f"{which} forward_offline row {i} {name}")


@pytest.fixture(scope="module")
def eval_files(tmp_path_factory, bodies):
    """Three sequences written by the JAX package, of lengths 40, 70 and
    150: with a 128-frame bucket, one group of two ragged sequences and
    one longer than the bucket."""
    d = tmp_path_factory.mktemp("eval_data")
    files = []
    for i, T in enumerate((40, 70, 150)):
        f = d / f"eval{i}.pt"
        make_synthetic_processed_dataset(f, n_sequences=1, T=T, seed=30 + i,
                                         body_model=bodies[0])
        files.append(f)
    return files


def test_dataset_views_match_jax(eval_files, bodies):
    jds = JaxPoseDataset(fold="test", evaluate="dip", body_model=bodies[0],
                         data_files=eval_files)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=bodies[1],
                     data_files=eval_files, device="cpu")
    assert len(ds.windows) == len(jds.windows) == 3
    for jw, w in zip(jds.windows, ds.windows):
        assert jw.keys() == w.keys()
        for k in w:
            # FK of the ground truth: 1e-5 (float32 tree products)
            np.testing.assert_allclose(w[k], jw[k], atol=1e-5, err_msg=k)
    for combo in ("lw_rp", "rp_h"):
        jv, v = JaxEvalSequence(jds, combo), EvalSequence(ds, combo)
        for i in range(len(v)):
            for a, b in zip(v[i], jv[i]):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    assert len(PoseDataset(fold="train", data_files=[], device="cpu")) == 0
    with pytest.raises(ValueError, match="fold"):
        PoseDataset(fold="valid", data_files=[], device="cpu")


@pytest.fixture(scope="module")
def small_bucket():
    """The 512-frame bucket shrunk to 128 in both packages (the JAX
    package's own tests do the same): the same grouping logic at a third
    of the CPU time."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ev_mod, "_BUCKET", 128)
    mp.setattr(pose_eval, "_BUCKET", 128)
    yield
    mp.undo()


def test_evaluate_pose_end_to_end_matches_jax(eval_files, bodies, nets,
                                              weights, small_bucket):
    """Offline, ONLINE and drift, trained weights, against the JAX
    package; then the port's per-sequence path against its batched one."""
    jnet, net = nets
    tree, params = weights["trained"]
    jds = JaxPoseDataset(fold="test", evaluate="dip", body_model=bodies[0],
                         data_files=eval_files)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=bodies[1],
                     data_files=eval_files, device="cpu")
    want = jax_evaluate_pose(jnet, tree, JaxEvalSequence(jds), online=True,
                             evaluate_tran=True, verbose=False)
    got = evaluate_pose(net, params, EvalSequence(ds), online=True,
                        evaluate_tran=True, verbose=False)
    assert got.keys() == want.keys() == {"offline", "online", "tran_errors"}
    for k in ("offline", "online"):
        assert got[k].shape == (8, 2) and np.all(np.isfinite(got[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_TABLE,
                                   atol=1e-6, err_msg=k)
    assert got["tran_errors"].keys() == want["tran_errors"].keys()
    for w in want["tran_errors"]:
        np.testing.assert_allclose(got["tran_errors"][w],
                                   want["tran_errors"][w], rtol=RTOL_TABLE)

    serial = evaluate_pose(net, params, EvalSequence(ds), online=True,
                           evaluate_tran=True, verbose=False,
                           batch_sequences=False)
    for k in ("offline", "online"):
        np.testing.assert_allclose(serial[k], got[k], rtol=RTOL_TABLE,
                                   atol=1e-6, err_msg=k)


def test_evaluate_pose_out_of_slice_options_raise(nets, weights):
    net = nets[1]
    params = weights["random"][1]
    with pytest.raises(ValueError, match="online_mode"):
        evaluate_pose(net, params, [], online_mode="carry-mode")
    # carry mode is ported (tests/test_torch_carry.py holds it to JAX)
    assert evaluate_pose(net, params, [], online=True, online_mode="carry",
                         verbose=False) == {}
    # bf16 is ported (tests/test_torch_bf16.py), batched as in the JAX
    # package
    assert evaluate_pose(net, params, [], online=True, bf16=True,
                         verbose=False) == {}
    with pytest.raises(ValueError, match="batch_sequences"):
        evaluate_pose(net, params, [], bf16=True, batch_sequences=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        evaluate_pose(net, params, [], online=True, mesh=object())


def test_cli_evaluate_runs_on_cpu(eval_files, bodies, monkeypatch, capsys,
                                  small_bucket):
    monkeypatch.setenv("MP_PROCESSED", str(eval_files[0].parent))
    shutil.copy(eval_files[0], eval_files[0].parent / "synthetic.pt")
    # the small synthetic body, as tests/test_cli.py keeps the JAX CLI on it
    monkeypatch.setattr(ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, f: bodies[1]))
    res = eval_cli.main(["--model", _FIXTURE, "--dataset", "synthetic",
                         "--tran", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in pose_eval.METRIC_NAMES:
        assert name in out
    assert res["offline"].shape == (8, 2) and "translation drift" in out
    table = res["offline"]
    # --int8 --bf16 (int8 on bf16 params) evaluates too
    # (tests/test_torch_int8_bf16.py holds it to the JAX CLI)
    res = eval_cli.main(["--model", _FIXTURE, "--dataset", "synthetic",
                         "--device", "cpu", "--int8", "--bf16"])
    assert res["offline"].shape == (8, 2)
    assert np.all(np.isfinite(res["offline"]))
    # the reference's .pth of the same weights evaluates to the same table
    # (tests/test_torch_torch_convert.py holds the loader to the JAX one)
    pth = eval_files[0].parent / "model.pth"
    save_torch_checkpoint(load_npz(_FIXTURE), pth)
    res_pth = eval_cli.main(["--model", str(pth), "--dataset", "synthetic",
                             "--tran", "--device", "cpu"])
    np.testing.assert_array_equal(res_pth["offline"], table)


def test_cli_evaluate_data_parallel_on_one_device(eval_files, bodies,
                                                  monkeypatch, capsys,
                                                  small_bucket):
    """`--data-parallel` with one device evaluates as the JAX CLI does
    there (no mesh): the same tables as the run without it. Over more
    than one CUDA device it still raises."""
    monkeypatch.setenv("MP_PROCESSED", str(eval_files[0].parent))
    shutil.copy(eval_files[0], eval_files[0].parent / "synthetic.pt")
    monkeypatch.setattr(ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, f: bodies[1]))
    args = ["--model", _FIXTURE, "--dataset", "synthetic", "--device", "cpu"]
    tables = []
    for extra in ([], ["--data-parallel"]):
        res = eval_cli.main(args + extra)
        tables.append(capsys.readouterr().out)
        assert res["offline"].shape == (8, 2)
    assert tables[0] == tables[1] and "SIP Error" in tables[0]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(eval_cli, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="queue A item 16"):
        eval_cli.main(args[:4] + ["--data-parallel"])
