"""The port's bfloat16 inference against the JAX package, on the CPU.

Kernel plain versions. Each bf16 plain version (what a kernel wrapper runs
on a CPU tensor: float32 carry and sums, h rounded to bf16 for the
recurrent product, outputs rounded once) is held to the JAX kernel run in
interpret mode on the same bf16 inputs, made with numpy from a seed: #2
`lstm_layer_pallas`, #1 `bilstm_layer_pallas`, #3
`lstm_layer_masked_pallas` (uni, and bi as two calls sharing the mask)
and #9 `multicell_lstm_pallas`, over T = 16 steps. Bound: 2 bf16 ulps of
the output's largest magnitude (2^(floor(log2 max|x|) - 7)). Both sides
compute the same float32 products (a product of two bf16 values is exact
in float32); the order of the float32 sums and torch's sigmoid/tanh
against XLA's move a float32 value by a few of its ulps, which moves a
bf16 output by one ulp where it lands on a rounding boundary, and such a
flip of h feeds the next steps' gates at a fraction of an ulp. Measured:
at most 1/8 of that ulp (one ulp of a smaller output) on every output
here.

Weights. `cast_params` and `params_from_jax(dtype=torch.bfloat16)` give
the same tensors as the JAX package's `cast_params`, bit for bit, and
bf16 `.npz` archives cross between the packages both ways bit for bit.

The slice. bf16 `forward` (the single window, 'auto' and 'fused'), the
exact streaming path (scan and unfolded) and carry mode are held to the
JAX package's bf16 path within its own bf16 bound of 0.05 on joints
(tests/test_extras.py:87-101), and also to its float32 path: the port
keeps every layer's carry in float32 (the TPU kernels' semantics) where
the JAX package's CPU path scans in XLA with a bf16 carry, and that
difference stays inside what bf16 already costs. Also: the float32 fusion
accumulators under bf16 streaming, a bf16 PoseServer round trip in both
modes, `evaluate_pose(bf16=True)` and `cli.evaluate --bf16` against the
JAX CLI's bf16 tables, and what stays unported raising with its ROADMAP
row.
"""

import math
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mobileposer_tpu.evaluation.evaluator as jax_ev_mod
from mobileposer_tpu.cli import evaluate as jax_eval_cli
from mobileposer_tpu.data.fixtures import make_synthetic_processed_dataset
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.kinematics import smpl as jax_smpl
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.models import forward as jax_forward
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.nn import cast_params as jax_cast_params
from mobileposer_tpu.nn import export_to_npz, load_from_npz
from mobileposer_tpu.ops.lstm_pallas import (bilstm_layer_pallas,
                                             lstm_layer_masked_pallas,
                                             lstm_layer_pallas)
from mobileposer_tpu.ops.multicell_pallas import multicell_lstm_pallas
from mobileposer_tpu.ops.quant import \
    quantize_params_int8 as jax_quantize_params_int8
from mobileposer_tpu_torch import nn as port_nn
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.evaluation import evaluate_pose, pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, forward
from mobileposer_tpu_torch.nn.convert import (cast_params, export_npz,
                                              load_npz, params_from_jax,
                                              params_to_jax)
from mobileposer_tpu_torch.ops import lstm_cuda, multicell_cuda
from mobileposer_tpu_torch.ops.quant import quantize_params_int8
from mobileposer_tpu_torch.stream import PoseClient, PoseServer

BF16 = torch.bfloat16
KERNEL_ULPS = 2
# the JAX package's bf16 bound on joints (tests/test_extras.py:87-101)
SLICE_TOL = 0.05
# the JAX package's own accuracy bounds for a cheaper inference dtype
# (tests/test_quant.py:391-393): rows 0 (SIP, deg), 3 (positional, cm)
# and 6 (jitter, 100 m/s^3) of the metric table
TABLE_BOUND = {0: 0.5, 3: 0.5, 6: 0.2}
_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


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
    """(JAX bf16 params, the same as numpy, the port's bf16 modules, the
    JAX float32 params): random `init_all_modules(PRNGKey(0))`."""
    p32 = jax_init_all_modules(jax.random.PRNGKey(0))
    p16 = jax_cast_params(p32, jnp.bfloat16)
    tree16 = jax.tree_util.tree_map(np.asarray, p16)
    return p16, tree16, params_from_jax(tree16, device="cpu",
                                        dtype=BF16), p32


def _bf16(a):
    """numpy float32 -> (jnp bf16, torch bf16), the same bits."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(BF16)


def _t(x):
    """A JAX bf16 array as a torch bf16 tensor, the same bits."""
    return torch.from_numpy(np.asarray(x).view(np.uint16).astype(
        np.int16)).view(BF16)


def _ulp(x: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def _assert_ulps(got, want_jax, what):
    want = _t(want_jax)
    assert got.dtype == BF16 and got.shape == want.shape, what
    err = float((got.float() - want.float()).abs().max())
    assert err <= KERNEL_ULPS * _ulp(want), \
        f"{what}: {err} > {KERNEL_ULPS} ulps of {_ulp(want)}"


def _layer_inputs(rng, T, B, H):
    bound = 1.0 / math.sqrt(H)
    return [_bf16(a) for a in (
        rng.randn(T, B, 4 * H), rng.uniform(-bound, bound, (H, 4 * H)),
        np.tanh(rng.randn(B, H)), rng.randn(B, H) * 0.5)]


def test_bf16_unidirectional_plain_matches_pallas():
    """#2: the bf16 plain version of `lstm_layer` against
    `lstm_layer_pallas(interpret=True)`, nonzero h0/c0."""
    rng = np.random.RandomState(0)
    (xj, xt), (wj, wt), (hj, ht), (cj, ct) = _layer_inputs(rng, 16, 5, 64)
    ys, (h_t, c_t) = lstm_cuda.lstm_layer(xt, wt, ht, ct)
    jys, (jh, jc) = lstm_layer_pallas(xj, wj, hj, cj, interpret=True)
    for name, g, w in (("ys", ys, jys), ("h_T", h_t, jh), ("c_T", c_t, jc)):
        _assert_ulps(g, w, name)


def test_bf16_bidirectional_plain_matches_pallas():
    """#1: the bf16 plain version of `bilstm_layer` against
    `bilstm_layer_pallas(interpret=True)`."""
    rng = np.random.RandomState(1)
    f = _layer_inputs(rng, 16, 4, 32)
    b = _layer_inputs(rng, 16, 4, 32)
    order = (f[0], b[0], f[1], b[1], f[2], f[3], b[2], b[3])
    got = lstm_cuda.bilstm_layer(*(t for _, t in order))
    want = bilstm_layer_pallas(*(j for j, _ in order), interpret=True)
    for name, g, w in (("ys_f", got[0], want[0]), ("ys_b", got[1], want[1]),
                       ("h_f", got[2][0], want[2][0]),
                       ("c_f", got[2][1], want[2][1]),
                       ("h_b", got[3][0], want[3][0]),
                       ("c_b", got[3][1], want[3][1])):
        _assert_ulps(g, w, name)


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
def test_bf16_masked_plain_matches_pallas(bi):
    """#3: the bf16 masked plain versions against
    `lstm_layer_masked_pallas(interpret=True)` (per direction for the
    bidirectional one, sharing the mask) under a ragged bf16 mask with an
    empty and a full row: masked steps hold the float32 carry and emit
    exact zeros."""
    rng = np.random.RandomState(2 + bi)
    T, B, H = 16, 5, 64
    lengths = np.array([0, T, 5, 11, 1])
    mask32 = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    mj, mt = _bf16(mask32)
    dirs = [_layer_inputs(rng, T, B, H) for _ in range(1 + bi)]
    if bi:
        (f, b) = dirs
        got = lstm_cuda.bilstm_layer_masked(
            f[0][1], b[0][1], f[1][1], b[1][1], f[2][1], f[3][1], b[2][1],
            b[3][1], mt)
        got = [(got[0], got[2]), (got[1], got[3])]
    else:
        d = dirs[0]
        got = [lstm_cuda.lstm_layer_masked(*(t for _, t in d), mt)]
    for d, (ys, (h_t, c_t)) in zip(dirs, got):
        jys, (jh, jc) = lstm_layer_masked_pallas(*(j for j, _ in d), mj,
                                                 interpret=True)
        for name, g, w in (("ys", ys, jys), ("h_T", h_t, jh),
                           ("c_T", c_t, jc)):
            _assert_ulps(g, w, name)
        assert bool((ys[torch.from_numpy(mask32) == 0] == 0).all())


def test_bf16_multicell_plain_matches_pallas():
    """#9: the bf16 plain version of `multicell_lstm` against
    `multicell_lstm_pallas(interpret=True)` on cells of the trio's three
    widths scaled down (64, 64, 32, 32, 64)."""
    rng = np.random.RandomState(4)
    hs = (64, 64, 32, 32, 64)
    T, B = 16, 3
    cells = [_layer_inputs(rng, T, B, H) for H in hs]
    x = np.concatenate([np.asarray(c[0][0], np.float32) for c in cells], -1)
    xj, xt = _bf16(x)
    got = multicell_cuda.multicell_lstm(
        xt, [c[1][1] for c in cells], [c[2][1] for c in cells],
        [c[3][1] for c in cells], hs)
    want = multicell_lstm_pallas(
        xj, tuple(c[1][0] for c in cells), tuple(c[2][0] for c in cells),
        tuple(c[3][0] for c in cells), hs, interpret=True)
    for k, name in enumerate(("ys", "h_T", "c_T")):
        for i in range(len(hs)):
            _assert_ulps(got[k][i], want[k][i], f"cell {i} {name}")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def test_cast_params_and_params_from_jax_agree_with_jax_bit_for_bit(
        weights):
    """`params_from_jax(JAX bf16 tree, dtype=bf16)`,
    `params_from_jax(float32 tree, dtype=bf16)` and
    `cast_params(params_from_jax(float32 tree), bf16)` give the same
    tensors, each the JAX package's `cast_params` bits; int8 tensors and
    the int8 dequantization scales survive a cast as the JAX package keeps
    them (int8, float32)."""
    p16, tree16, params, p32 = weights
    tree32 = jax.tree_util.tree_map(np.asarray, p32)
    a = params_from_jax(tree32, device="cpu", dtype=BF16)
    b = cast_params(params_from_jax(tree32, device="cpu"), BF16)
    assert port_nn.cast_params is cast_params
    back = params_to_jax(params)
    for mod in (a, b):
        for (n1, x), (n2, y) in zip(params.named_parameters(),
                                    mod.named_parameters()):
            assert n1 == n2 and x.dtype == y.dtype == BF16
            assert torch.equal(x, y), n1
    for jleaf, leaf in zip(jax.tree_util.tree_leaves(tree16),
                           jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(jleaf).view(np.uint16),
                                      _bits(leaf).view(np.uint16))
    q = cast_params(quantize_params_int8(params_from_jax(tree32,
                                                         device="cpu")), BF16)
    jq = jax_cast_params(jax_quantize_params_int8(p32), jnp.bfloat16)
    d, jd = q["velocity"].lstm[0]["fwd"], jq["velocity"]["lstm"][0]["fwd"]
    assert d.w_ih.dtype == torch.int8 and d.w_ih_scale.dtype == torch.float32
    assert d.b.dtype == BF16 and jd["b"].dtype == jnp.bfloat16
    assert jd["w_ih_scale"].dtype == jnp.float32
    assert q["velocity"].linear1.weight.dtype == BF16


def test_bf16_npz_round_trips_with_jax_bit_for_bit(weights, tmp_path):
    """A bf16 archive of the JAX package's `export_to_npz` loads in the
    port with its bits (leaves as torch.bfloat16, modules through
    `params_from_jax(dtype=bf16)`), and one the port's `export_npz` writes
    loads in the JAX package with its bits."""
    p16, tree16, params, _ = weights
    jpath = str(tmp_path / "jax_bf16.npz")
    export_to_npz(p16, jpath)
    tree = load_npz(jpath)
    w = tree["joints"]["lstm"][1]["bwd"]["w_hh"]
    assert isinstance(w, torch.Tensor) and w.dtype == BF16
    for jleaf, leaf in zip(jax.tree_util.tree_leaves(tree16),
                           jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(jleaf).view(np.uint16),
                                      _bits(leaf).view(np.uint16))
    loaded = params_from_jax(tree, device="cpu", dtype=BF16)
    for (n, x), (_, y) in zip(params.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(x, y), n
    ppath = str(tmp_path / "port_bf16.npz")
    export_npz(params_to_jax(params), ppath)
    back = load_from_npz(ppath)
    for jleaf, leaf in zip(jax.tree_util.tree_leaves(tree16),
                           jax.tree_util.tree_leaves(back)):
        assert leaf.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(jleaf).view(np.uint16),
                                      np.asarray(leaf).view(np.uint16))


def _joints_err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_bf16_forward_matches_jax(weights, bodies, backend):
    """The single-window forward on bf16 params and a bf16 IMU within
    0.05 on joints of the JAX package's bf16 forward and of its float32
    forward; 'fused' gives 'auto''s outputs (the plain versions run the
    same products per cell)."""
    p16, _, params, p32 = weights
    imu = (np.random.RandomState(5).randn(2, 8, 60) * 0.1).astype(np.float32)
    imu_j, imu_t = _bf16(imu)
    got = forward(params, imu_t, bodies[1], backend=backend)
    assert all(t.dtype == BF16 for t in got[:4])
    for want in (jax_forward(p16, imu_j, bodies[0]),
                 jax_forward(p32, jnp.asarray(imu), bodies[0])):
        assert _joints_err(got[1], want[1]) < SLICE_TOL
    if backend == "fused":
        auto = forward(params, imu_t, bodies[1])
        for g, a in zip(got[:4], auto[:4]):
            assert torch.equal(g, a)


@pytest.mark.parametrize("mode,S,N", [("scan", 2, 4), ("unfolded", 2, 5)])
def test_bf16_exact_streaming_matches_jax(weights, nets, mode, S, N):
    """`forward_online_sequence_batched` on bf16 params, state and frames
    within 0.05 on joints of the JAX package's bf16 path and of its float32
    path; the fusion state stays float32."""
    p16, _, params, p32 = weights
    jnet, net = nets
    frames = (np.random.RandomState(6).randn(N, S, 60) * 0.3).astype(
        np.float32)
    fj, ft = _bf16(frames)
    st = net.init_online_state_batched(S, dtype=BF16)
    (pose, joints, root, _), st = net.forward_online_sequence_batched(
        params, st, ft, mode=mode, chunk=3)
    assert pose.dtype == joints.dtype == BF16 and root.dtype == torch.float32
    assert st.vel_h.dtype == st.imu.dtype == BF16
    assert st.last_root_pos.dtype == st.last_lfoot.dtype == torch.float32
    run = jax.jit(jnet.forward_online_sequence_batched,
                  static_argnames=("mode", "chunk"))
    for p, f, dt in ((p16, fj, jnp.bfloat16), (p32, jnp.asarray(frames),
                                                jnp.float32)):
        (_, jjoints, jroot, _), _ = run(
            p, jnet.init_online_state_batched(S, dtype=dt), f, mode=mode,
            chunk=3)
        assert _joints_err(joints, jjoints) < SLICE_TOL
        assert np.all(np.isfinite(root.numpy()))


def test_bf16_carry_streaming_matches_jax(weights, nets):
    """Carry mode on bf16 params and state: every cell step in bf16, as
    the JAX package's; joints within 0.05 of its bf16 path and of its
    float32 path."""
    p16, _, params, p32 = weights
    jnet, net = nets
    S, N = 2, 7
    frames = (np.random.RandomState(7).randn(N, S, 60) * 0.3).astype(
        np.float32)
    fj, ft = _bf16(frames)
    (_, joints, root, _), st = net.forward_carry_sequence_batched(
        params, net.init_carry_state_batched(S, BF16), ft)
    assert joints.dtype == st.joints.f1_h.dtype == BF16
    assert root.dtype == torch.float32
    run = jax.jit(jnet.forward_carry_sequence_batched)
    for p, f, dt in ((p16, fj, jnp.bfloat16), (p32, jnp.asarray(frames),
                                                jnp.float32)):
        (_, jjoints, _, _), _ = run(p, jnet.init_carry_state_batched(S, dt),
                                    f)
        assert _joints_err(joints, jjoints) < SLICE_TOL


def test_bf16_streaming_keeps_f32_fusion_accumulators(weights, nets):
    """The counterpart of tests/test_streaming_carry.py:158-185: under
    bf16 streaming the fusion accumulators and foot anchors are float32
    in both state factories, and a stream parked 100 m from the origin
    moves by the same per-frame steps as near it (in a bf16 accumulator
    they would round to 0 out there)."""
    _, _, params, _ = weights
    _, net = nets
    S, N = 2, 6
    for st in (net.init_carry_state_batched(S, BF16),
               net.init_online_state_batched(S, dtype=BF16)):
        assert st.last_root_pos.dtype == torch.float32
        assert st.current_root_y.dtype == torch.float32
        assert st.last_lfoot.dtype == torch.float32
        assert st.vel_h.dtype == BF16
    frames = torch.from_numpy((np.random.RandomState(3).randn(N, S, 60)
                               * 0.3).astype(np.float32)).to(BF16)
    for init, run in ((net.init_carry_state_batched,
                       net.forward_carry_sequence_batched),
                      (net.init_online_state_batched,
                       net.forward_online_sequence_batched)):
        _, st1 = run(params, init(S, BF16), frames)
        (_, _, root_a, _), _ = run(params, st1, frames)
        far = st1._replace(last_root_pos=st1.last_root_pos + 100.0)
        (_, _, root_b, _), _ = run(params, far, frames)
        steps_near = np.diff(root_a.double().numpy(), axis=0)
        steps_far = np.diff(root_b.double().numpy(), axis=0)
        assert np.abs(steps_near).max() > 0
        # float32 at 100 m resolves ~8e-6 m
        np.testing.assert_allclose(steps_far, steps_near, atol=3e-5)


@pytest.mark.parametrize("mode", ["carry", "exact"])
def test_bf16_server_round_trip(weights, nets, mode):
    """The counterpart of tests/test_server.py:194-215: bf16 params make
    a bf16 server (state and frames in bf16, the fusion state float32);
    replies come back finite float32."""
    _, _, params, _ = weights
    _, net = nets
    srv = PoseServer(net, params, host="127.0.0.1", port=0, max_streams=2,
                     tick_hz=120.0, mode=mode)
    assert srv.dtype == BF16
    assert srv.states.vel_h.dtype == BF16
    assert srv.states.last_root_pos.dtype == torch.float32
    thread = threading.Thread(target=srv.run, daemon=True)
    thread.start()
    client = PoseClient(stream_id=3, port=srv.port, timeout=30.0)
    try:
        got = 0
        rng = np.random.RandomState(2)
        for _ in range(5):
            client.send_frame(rng.randn(60).astype(np.float32) * 0.1)
            out = client.recv_pose()
            if out is not None:
                assert all(np.all(np.isfinite(v)) for v in out)
                got += 1
        assert got >= 3
    finally:
        srv.stop()
        thread.join(timeout=30)
        srv.close()
        client.close()


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A synthetic processed file of two 60-frame sequences written by the
    JAX package, the 512-frame bucket shrunk to 128 in both packages (as
    tests/test_torch_eval.py does), and the small synthetic bodies."""
    d = tmp_path_factory.mktemp("bf16_eval")
    jbody = JaxBody.synthetic(num_vertices=240)
    body = ParametricModel.synthetic(num_vertices=240)
    make_synthetic_processed_dataset(d / "synthetic.pt", n_sequences=2,
                                     T=60, seed=41, body_model=jbody)
    mp = pytest.MonkeyPatch()
    mp.setenv("MP_PROCESSED", str(d))
    mp.setattr(jax_ev_mod, "_BUCKET", 128)
    mp.setattr(pose_eval, "_BUCKET", 128)
    mp.setattr(jax_smpl.ParametricModel, "from_file_or_synthetic",
               classmethod(lambda cls, f: jbody))
    mp.setattr(ParametricModel, "from_file_or_synthetic",
               classmethod(lambda cls, f: body))
    yield d
    mp.undo()


def test_cli_evaluate_bf16_matches_jax_cli(cli_env, monkeypatch):
    """`cli.evaluate --bf16 --online --tran --device cpu` (the trained
    fixture; offline groups through the masked bf16 plain version) against
    the JAX CLI with the same flags, its `evaluate_pose` result captured,
    within the JAX package's accuracy bounds for a cheaper dtype on rows
    0, 3 and 6; and against the port's float32 tables on rows 0 and 3.
    Not on the jitter row there: jerk is the third difference of the
    positions times fps^3 = 27,000, so bf16's rounding of the outputs
    alone raises it (2.50 against 0.51 offline in the JAX package's own
    tables on this data). `--int8 --bf16` casts, then quantizes, then
    evaluates in bf16, in the JAX CLI's order."""
    captured = {}
    jax_evaluate_pose = jax_eval_cli.evaluate_pose

    def capture(*args, **kwargs):
        captured.update(jax_evaluate_pose(*args, **kwargs))
        return captured
    monkeypatch.setattr(jax_eval_cli, "evaluate_pose", capture)
    argv = ["--model", _FIXTURE, "--dataset", "synthetic", "--online",
            "--tran", "--bf16"]
    jax_eval_cli.main(argv)
    got = eval_cli.main(argv + ["--device", "cpu"])
    f32 = eval_cli.main(argv[:-1] + ["--device", "cpu"])
    assert got.keys() == captured.keys() == {"offline", "online",
                                             "tran_errors"}
    for k in ("offline", "online"):
        assert got[k].shape == (8, 2) and np.all(np.isfinite(got[k]))
        for ref, rows in ((captured, (0, 3, 6)), (f32, (0, 3))):
            for row in rows:
                assert abs(got[k][row, 0] - ref[k][row, 0]) < \
                    TABLE_BOUND[row], (k, row)
    handed = []
    monkeypatch.setattr(eval_cli, "evaluate_pose",
                        lambda net, params, seqs, **kw: handed.append(
                            (params, kw)))
    eval_cli.main(argv + ["--int8", "--device", "cpu"])
    ((params, kw),) = handed
    d = params["joints"].lstm[0]["fwd"]
    assert kw["bf16"] is True and d.w_ih.dtype == torch.int8
    assert d.b.dtype == d.w_hh_scale.dtype == torch.float32
    assert params["joints"].linear1.weight.dtype == BF16


def test_evaluate_pose_bf16_runs_the_masked_bf16_path(cli_env, nets,
                                                      monkeypatch):
    """`evaluate_pose(bf16=True)` casts the params and feeds the offline
    groups in bf16 to the masked layers (the plain versions on the CPU),
    and computes the metrics in float32 on the cast-back outputs."""
    from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
    _, net = nets
    params = params_from_jax(load_npz(_FIXTURE), device="cpu")
    seen = []
    plain = lstm_cuda.bilstm_layer_masked_plain

    def spy(*args):
        seen.append(args[0].dtype)
        return plain(*args)
    monkeypatch.setattr(lstm_cuda, "bilstm_layer_masked_plain", spy)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=net.body_model,
                     data_files=[cli_env / "synthetic.pt"], device="cpu")
    res = evaluate_pose(net, params, EvalSequence(ds), bf16=True,
                        verbose=False)
    assert seen and set(seen) == {BF16}
    assert res["offline"].dtype == np.float64 or res["offline"].dtype == \
        np.float32
    assert np.all(np.isfinite(res["offline"]))
    # the caller's params are left float32
    assert params["joints"].linear1.weight.dtype == torch.float32


def test_unported_bf16_paths_raise_with_their_rows(weights, nets):
    """int8 on bf16 params runs (quantizing a bf16 cast, the forward and
    the carry step on a quantized tree cast to bf16, the int8 kernels'
    plain versions with bf16 I/O), in bf16; bf16 training still raises
    naming ROADMAP item 20 (the training kernels are float32)."""
    _, tree16, params, p32 = weights
    _, net = nets
    q = quantize_params_int8(params)
    assert q["joints"].lstm[0]["fwd"].w_ih.dtype == torch.int8
    assert q["joints"].lstm[0]["fwd"].b.dtype == torch.float32
    q16 = cast_params(quantize_params_int8(params_from_jax(
        jax.tree_util.tree_map(np.asarray, p32), device="cpu")), BF16)
    imu = torch.zeros(1, 4, 60, dtype=BF16)
    out = forward(q16, imu, net.body_model)
    assert out[1].dtype == BF16 and bool(torch.isfinite(out[1]).all())
    (_, joints, _, _), st = net.forward_carry_batched(
        q16, net.init_carry_state_batched(1, BF16), imu[0, :1])
    assert joints.dtype == st.joints.f1_h.dtype == BF16
    x = torch.zeros(2, 1, 256, dtype=BF16)
    ys, (h_t, c_t) = lstm_cuda.lstm_layer_int8(
        x, torch.zeros(64, 256, dtype=torch.int8), torch.ones(256),
        x[0, :, :64], x[0, :, :64])
    assert ys.dtype == h_t.dtype == c_t.dtype == BF16
    block = params["velocity"]
    with pytest.raises(NotImplementedError, match="item 20"):
        block(torch.zeros(1, 3, 132, dtype=BF16), backend="auto_train")
    with pytest.raises(NotImplementedError, match="item 20"):
        block(torch.zeros(1, 3, 132, dtype=BF16),
              backend="auto_train_bf16res")
