"""Data-parallel evaluation and serving of the port on the CPU, over
meshes of CPU entries: `evaluate_pose(mesh=...)` against the JAX
package's over its 8-device mesh (tests/test_eval.py:206-240) and
against the port's one-device run; `PoseServer(mesh=...)` against the
unsharded server (tests/test_server.py:274-350, 466-473), exact and
carry, float32, int8 and bf16; and both CLIs' `--data-parallel` over a
forced multi-device mesh.

int8 results are held to the one-device run at the int8 pins of
tests/test_torch_quant.py, not at 1e-4: torch's CPU matmul of the float
input projection rounds differently at another batch size (1.5e-6 apart
at 2 rows against 8), and the per-row re-quantization of h can turn such
a last bit into a whole int8 level, "a flip" (up to 1e-3 apart over four
frames).

Weights: the trained fixture; evaluation sequences
written by the JAX package with the 512-frame bucket shrunk to 128 in
both packages (as tests/test_torch_eval.py does). Tolerances are stated
at each assert.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax

import mobileposer_tpu.evaluation.evaluator as jax_ev_mod
from mobileposer_tpu.data import EvalSequence as JaxEvalSequence
from mobileposer_tpu.data import PoseDataset as JaxPoseDataset
from mobileposer_tpu.data.fixtures import make_synthetic_processed_dataset
from mobileposer_tpu.evaluation import evaluate_pose as jax_evaluate_pose
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.parallel import make_mesh as jax_make_mesh
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.cli import serve as serve_cli
from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
from mobileposer_tpu_torch.evaluation import evaluate_pose, pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.nn.convert import cast_params, params_from_jax
from mobileposer_tpu_torch.parallel import Sharded, make_mesh
from mobileposer_tpu_torch.stream import PoseClient, PoseServer

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


@pytest.fixture(scope="module")
def net(bodies):
    return MobilePoserNet(bodies[1], device="cpu")


@pytest.fixture(scope="module")
def trained():
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  load_from_npz(_FIXTURE))
    return tree, params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def eval_env(tmp_path_factory, bodies):
    """Two sequences of 40 and 70 frames written by the JAX package (one
    ragged group at the 128-frame bucket), three of 50 frames as the
    synthetic set the CLIs read, and the bucket shrunk to 128 in both
    packages."""
    d = tmp_path_factory.mktemp("parallel_eval")
    files = []
    for i, T in enumerate((40, 70)):
        f = d / f"eval{i}.pt"
        make_synthetic_processed_dataset(f, n_sequences=1, T=T, seed=30 + i,
                                         body_model=bodies[0])
        files.append(f)
    make_synthetic_processed_dataset(d / "synthetic.pt", n_sequences=3,
                                     T=50, seed=33, body_model=bodies[0])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ev_mod, "_BUCKET", 128)
    mp.setattr(pose_eval, "_BUCKET", 128)
    yield files
    mp.undo()


def _tables_close(got, want, atol, what):
    assert got.keys() == want.keys(), what
    for k in ("offline", "online"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], atol=atol,
                                       err_msg=f"{what}: {k}")
    for w in want.get("tran_errors", {}):
        np.testing.assert_allclose(got["tran_errors"][w],
                                   want["tran_errors"][w], atol=atol,
                                   err_msg=f"{what}: drift {w}")


def test_evaluate_pose_sharded_matches_jax_and_one_device(eval_env, bodies,
                                                          net, trained):
    """Offline, ONLINE and drift over a mesh of 8 CPU entries (a group of
    two sequences padded to a row per shard): within the existing pins of
    the JAX package's run over its 8-device mesh (rtol 1e-4 on the
    tables, tests/test_torch_eval.py), and within 1e-4 of the port's
    one-device run."""
    tree, params = trained
    jds = JaxPoseDataset(fold="test", evaluate="dip", body_model=bodies[0],
                         data_files=eval_env)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=bodies[1],
                     data_files=eval_env, device="cpu")
    kw = dict(online=True, evaluate_tran=True, verbose=False)
    want = jax_evaluate_pose(JaxNet(bodies[0]), tree, JaxEvalSequence(jds),
                             mesh=jax_make_mesh(), **kw)
    got = evaluate_pose(net, params, EvalSequence(ds),
                        mesh=make_mesh(devices=["cpu"] * 8), **kw)
    one = evaluate_pose(net, params, EvalSequence(ds), **kw)
    for k in ("offline", "online"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _tables_close(got, one, 1e-4, "sharded vs one device")


@pytest.mark.parametrize("online_mode,int8", [("carry", False),
                                              ("exact", True)])
def test_evaluate_pose_sharded_carry_and_int8_match_one_device(
        eval_env, bodies, net, trained, online_mode, int8):
    """Carry-mode ONLINE and int8 params (the masked #5 offline, #4 and
    #6 ONLINE, per shard) over 4 CPU entries against one device: 1e-4 in
    float32; int8 at tests/test_torch_quant.py's table pins (rtol 1e-3,
    the jitter row atol 2e-2)."""
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    params = trained[1]
    if int8:
        params = quantize_params_int8(params)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=bodies[1],
                     data_files=eval_env, device="cpu")
    kw = dict(online=True, online_mode=online_mode, verbose=False)
    got = evaluate_pose(net, params, EvalSequence(ds),
                        mesh=make_mesh(devices=["cpu"] * 4), **kw)
    one = evaluate_pose(net, params, EvalSequence(ds), **kw)
    if not int8:
        _tables_close(got, one, 1e-4, online_mode)
        return
    for k in ("offline", "online"):
        rows = [r for r in range(8) if r != 6]
        np.testing.assert_allclose(got[k][rows], one[k][rows], rtol=1e-3,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k][6], one[k][6], atol=2e-2,
                                   err_msg=k)


def test_cli_evaluate_data_parallel_over_a_forced_mesh(eval_env, bodies,
                                                       monkeypatch, capsys):
    """`--data-parallel` with the mesh of every card forced to 4 CPU
    entries: the tables of the run without it, within 1e-4."""
    monkeypatch.setenv("MP_PROCESSED", str(eval_env[0].parent))
    monkeypatch.setattr(ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, f: bodies[1]))
    args = ["--model", _FIXTURE, "--dataset", "synthetic", "--online",
            "--device", "cpu"]
    one = eval_cli.main(args)
    monkeypatch.setattr(eval_cli, "data_parallel_mesh",
                        lambda d: make_mesh(devices=["cpu"] * 4))
    capsys.readouterr()
    got = eval_cli.main(args + ["--data-parallel"])
    assert "data-parallel evaluation over 4 devices" in capsys.readouterr().out
    _tables_close(got, one, 1e-4, "cli")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _lockstep(srv, clients, frames):
    """Each tick every client sends its frame; the replies [T, C, 77]."""
    out = np.zeros((len(frames), len(clients), 77), np.float32)
    for t, f in enumerate(frames):
        for k, c in enumerate(clients):
            c.send_frame(f[k])
        time.sleep(0.005)
        deadline = time.time() + 30
        while srv.has_frame.sum() < len(clients) and time.time() < deadline:
            srv._drain_requests()
        srv.tick()
        for k, c in enumerate(clients):
            r = c.recv_pose()
            assert r is not None, f"tick {t}: no reply for {c.stream_id}"
            out[t, k] = np.concatenate(r)
    return out


@pytest.mark.parametrize("mode,quantize,bf16,pipelined", [
    ("exact", None, False, False), ("exact", "int8", False, True),
    ("carry", None, False, True), ("carry", "int8", True, False),
    ("exact", None, True, True)],
    ids=["exact", "exact-int8-pipelined", "carry-pipelined",
         "carry-int8-bf16", "exact-bf16-pipelined"])
def test_sharded_server_matches_unsharded(net, trained, mode, quantize,
                                          bf16, pipelined):
    """8 slots over 4 CPU entries, three streams in slots of three
    shards, in lockstep, on the trained fixture: the replies within 1e-4
    of the unsharded server's on the same frames; int8 within 2e-3, the
    int8 slice pin (chip_smoke.INT8_SLICE_TOL, tests/test_torch_quant.py),
    a few flips' worth; bf16 within two bf16 ulps of a rotation entry,
    2^-7."""
    params = trained[1]
    if bf16:
        params = cast_params(params, torch.bfloat16)
    rng = np.random.RandomState(3)
    frames = (rng.randn(4, 3, 60) * 0.1).astype(np.float32)
    replies = {}
    for name, mesh in (("one", None), ("sharded",
                                       make_mesh(devices=["cpu"] * 4))):
        srv = PoseServer(net, params, host="127.0.0.1", port=0,
                         max_streams=8, mode=mode, quantize=quantize,
                         mesh=mesh, pipelined=pipelined)
        clients = [PoseClient(stream_id=40 + k, port=srv.port)
                   for k in range(3)]
        try:
            # claim slots 0, 3 and 6: shards 0, 1 and 3
            for k, slot in enumerate((0, 3, 6)):
                srv.slot_of[40 + k], srv.id_of[slot] = slot, 40 + k
            replies[name] = _lockstep(srv, clients, frames)
            if mesh is not None:
                assert srv.stats()["shards"] == 4
                assert isinstance(srv.states, Sharded)
                assert srv.states[1].last_root_pos.shape == (2, 3)
        finally:
            for c in clients:
                c.close()
            srv.stop()
            srv.close()
    got, want = replies["sharded"], replies["one"]
    if quantize:
        np.testing.assert_allclose(got, want, atol=2e-3)
    elif bf16:
        # the other batch size's CPU matmul may round a bf16 rotation
        # entry (magnitude up to 1, ulp 2^-8) to its neighbour, and the
        # axis-angle is taken from the bf16 matrix: two such ulps
        np.testing.assert_allclose(got, want, atol=2.0 ** -7)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_sharded_server_slot_reset_goes_to_its_shard(net, trained):
    """A reset clears the slot on the shard that owns it, out of place,
    and leaves every other shard's state as it was."""
    srv = PoseServer(net, trained[1], host="127.0.0.1", port=0, max_streams=8,
                     mesh=make_mesh(devices=["cpu"] * 4))
    try:
        srv._states = [st._replace(last_root_pos=st.last_root_pos + 1.0)
                       for st in srv._states]
        before = [st.last_root_pos for st in srv._states]
        srv._reset_slot(5)                            # shard 2, row 1
        after = [st.last_root_pos for st in srv._states]
        assert before[2].tolist() == [[1.0] * 3] * 2   # out of place
        assert after[2].tolist() == [[1.0] * 3, [0.0] * 3]
        for i in (0, 1, 3):
            assert after[i] is before[i]
    finally:
        srv.close()


def test_sharded_server_rejects_uneven_slots(net, trained):
    with pytest.raises(ValueError, match="divide"):
        PoseServer(net, trained[1], host="127.0.0.1", port=0, max_streams=5,
                   mesh=make_mesh(devices=["cpu"] * 8))


@pytest.mark.parametrize("flags", [[], ["--carry", "--int8", "--bf16"]],
                         ids=["exact", "carry-int8-bf16"])
def test_cli_serve_data_parallel_over_a_forced_mesh(monkeypatch, capsys,
                                                    flags):
    monkeypatch.setattr(serve_cli, "data_parallel_mesh",
                        lambda d: make_mesh(devices=["cpu"] * 4))
    stats = serve_cli.main(["--model", _FIXTURE, "--host", "127.0.0.1",
                            "--port", "0", "--max-streams", "8",
                            "--duration", "0.1", "--device", "cpu",
                            "--data-parallel", *flags])
    assert "4-device fleet" in capsys.readouterr().out
    assert stats["shards"] == 4 and stats["frames_served"] == 0
