"""The port's int8 on bf16 params against the JAX package, on the CPU.

int8 on bf16 params is the JAX package's serving configuration: the params
cast to bf16, then the LSTM matmuls quantized to W8A8 (the scales float32,
`b` float32, the linears bf16), with bf16 frames and state.

Kernel plain versions. The int8 layer scans with bf16 I/O keep the TPU
kernels' float32 carry: `_gates_int8` (lstm_pallas.py:318-321) quantizes
the float32 scratch h, and bf16 touches only the loads (x_proj, h0, c0,
the mask, widened) and the stores (ys, h_T, c_T, rounded). The plain
versions of #4, #6 and #5 (uni, and bi as two calls sharing the mask) on
bf16 inputs made with numpy from a seed are held to the int8 Pallas
kernels in interpret mode. Bound: at most 1 bf16 ulp of the output's
largest magnitude, and at most 1% of the outputs differing. torch's and
XLA's sigmoid/tanh differ in the last float32 bits, which moves a bf16
output by an ulp only where it lands on a rounding boundary (0 of 1536
outputs did at T = 12, B = 4, H = 32). A body that quantizes h rounded
to bf16 (the float body's product, not the int8 one's) differs on ~19%.

Weights. The port's `quantize_params_int8(cast_params(p, bf16))` is the
JAX package's bit for bit, and `cast_params` of a quantized tree casts
what the JAX package's `_cast_program` casts.

The slice. `forward(backend='auto')`, exact streaming (scan and
unfolded) and carry streaming on int8 on bf16 params stay within the JAX
package's own relative bound for this configuration, 0.06
(tests/test_quant.py:178-190: max |y - y_ref| / max |y_ref|), of its
int8-on-bf16 path and of its float32 path. The two int8-on-bf16 paths
differ on purpose: the JAX package's CPU path scans in XLA with a bf16
carry (`int8_recurrent_gates(h_bf16).astype(bf16)`), the port keeps the
TPU kernels' float32 carry. Also: the carry-mode cell keeps bf16 h and
c, the bf16 server quantizes what it is given (float, or an already
quantized bf16 tree), `evaluate_pose(bf16=True)` on quantized params runs
the masked int8 layers in bf16, and `cli.evaluate --int8 --bf16` stays
within the JAX CLI's tables at the int8 bounds.
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
from mobileposer_tpu.ops.lstm_pallas import (bilstm_layer_pallas_int8,
                                             lstm_layer_masked_pallas_int8,
                                             lstm_layer_pallas_int8)
from mobileposer_tpu.ops.quant import \
    quantize_params_int8 as jax_quantize_params_int8
from mobileposer_tpu.ops.quant import quantize_weight_int8
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.evaluation import evaluate_pose, pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, forward
from mobileposer_tpu_torch.nn.convert import (cast_params, load_npz,
                                              params_from_jax, params_to_jax)
from mobileposer_tpu_torch.nn.lstm import lstm_cell_step
from mobileposer_tpu_torch.ops import lstm_cuda
from mobileposer_tpu_torch.ops.quant import quantize_params_int8
from mobileposer_tpu_torch.stream import PoseClient, PoseServer

BF16 = torch.bfloat16
# the JAX package's bound for int8 on bf16 params (tests/test_quant.py:190)
SLICE_REL = 0.06
# the int8 bounds of tests/test_torch_quant.py (tests/test_quant.py:328-361)
# on rows 0 (SIP, deg), 3 (positional, cm) and 6 (jitter, 100 m/s^3)
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


def _bf16(a):
    """numpy -> (jnp bf16, torch bf16), the same bits."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(BF16)


def _t(x):
    """A JAX bf16 array as a torch bf16 tensor, the same bits."""
    return torch.from_numpy(np.asarray(x).view(np.uint16).astype(
        np.int16)).view(BF16)


def _ulp(x: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def _assert_within_an_ulp(pairs):
    """Each (name, got, JAX want): bf16, the same shape, at most 1 bf16
    ulp of the output's largest magnitude apart; and at most 1% of all
    the outputs differing."""
    differ = total = 0
    for name, got, want_jax in pairs:
        want = _t(want_jax)
        assert got.dtype == BF16 and got.shape == want.shape, name
        diff = (got.float() - want.float()).abs()
        assert float(diff.max()) <= _ulp(want), \
            f"{name}: {float(diff.max())} > an ulp of {_ulp(want)}"
        differ += int((diff > 0).sum())
        total += diff.numel()
    assert differ <= 0.01 * total, f"{differ} of {total} outputs differ"


def _direction(rng, T, B, H):
    """One direction's bf16 inputs as (jnp, torch) pairs: x_proj, int8
    w_hh (drawn as torch.nn.LSTM draws it, quantized per column), its
    float32 scale, h0 in (-1, 1), c0."""
    bound = 1.0 / math.sqrt(H)
    w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound, (H, 4 * H)))
    return (_bf16(rng.randn(T, B, 4 * H)),
            (jnp.asarray(w_q), torch.from_numpy(w_q)),
            (jnp.asarray(w_s), torch.from_numpy(w_s)),
            _bf16(np.tanh(rng.randn(B, H))), _bf16(rng.randn(B, H) * 0.5))


def _gapped_mask(T, B):
    """A [T, B] mask with a gap in the middle of row 0, a row of length 0
    and a short row; the rest full."""
    m = np.ones((T, B), np.float32)
    m[T // 3: T // 3 + 3, 0] = 0.0
    m[:, 1] = 0.0
    m[T // 2:, 2] = 0.0
    return m


# ---------------------------------------------------------------------------
# Kernel plain versions against the interpreted int8 Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,T,B,H", [
    ("#4 uni", 12, 4, 32), ("#6 bi", 16, 8, 64), ("#5 masked uni", 14, 6, 64),
    ("#5 masked bi", 12, 5, 32)])
def test_int8_bf16_plain_matches_pallas(kernel, T, B, H):
    """The bf16 plain versions of `lstm_layer_int8`, `bilstm_layer_int8`,
    `lstm_layer_masked_int8` and `bilstm_layer_masked_int8` against the
    int8 Pallas kernels in interpret mode on the same bf16 inputs; masked
    steps emit exact zeros."""
    rng = np.random.RandomState(T + B + H)
    bi, masked = "bi" in kernel, "masked" in kernel
    dirs = [_direction(rng, T, B, H) for _ in range(1 + bi)]
    mask32 = _gapped_mask(T, B)
    mj, mt = _bf16(mask32)
    jx = [[j for j, _ in d] for d in dirs]
    tx = [[t for _, t in d] for d in dirs]
    if masked:
        want = [lstm_layer_masked_pallas_int8(*d, mj, interpret=True)
                for d in jx]
        if bi:
            (xf, wf, sf, hf, cf), (xb, wb, sb, hb, cb) = tx
            ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer_masked_int8(
                xf, xb, wf, wb, sf, sb, hf, cf, hb, cb, mt)
            got = [(ys_f, hc_f), (ys_b, hc_b)]
        else:
            got = [lstm_cuda.lstm_layer_masked_int8(*tx[0], mt)]
    elif bi:
        (xf, wf, sf, hf, cf), (xb, wb, sb, hb, cb) = jx
        jf, jb, jhc_f, jhc_b = bilstm_layer_pallas_int8(
            xf, xb, wf, wb, sf, sb, hf, cf, hb, cb, interpret=True)
        want = [(jf, jhc_f), (jb, jhc_b)]
        (xf, wf, sf, hf, cf), (xb, wb, sb, hb, cb) = tx
        ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer_int8(
            xf, xb, wf, wb, sf, sb, hf, cf, hb, cb)
        got = [(ys_f, hc_f), (ys_b, hc_b)]
    else:
        want = [lstm_layer_pallas_int8(*jx[0], interpret=True)]
        got = [lstm_cuda.lstm_layer_int8(*tx[0])]
    pairs = []
    for d, ((ys, (h, c)), (jys, (jh, jc))) in enumerate(zip(got, want)):
        pairs += [(f"dir {d} ys", ys, jys), (f"dir {d} h_T", h, jh),
                  (f"dir {d} c_T", c, jc)]
        if masked:
            assert bool((ys[torch.from_numpy(mask32) == 0] == 0).all())
    _assert_within_an_ulp(pairs)


def test_int8_bf16_layer_wrappers_take_bf16_io():
    """The int8 wrappers take bf16 I/O with int8 w_hh and float32 scales,
    return bf16, and refuse a float32 mask (the mask is in the I/O dtype),
    a bf16 scale and mixed I/O dtypes."""
    rng = np.random.RandomState(3)
    T, B, H = 3, 2, 32
    x, w, s, h0, c0 = (t for _, t in _direction(rng, T, B, H))
    mask = torch.ones(T, B, dtype=BF16)
    ys, (h, c) = lstm_cuda.lstm_layer_masked_int8(x, w, s, h0, c0, mask)
    assert ys.dtype == h.dtype == c.dtype == BF16
    with pytest.raises(ValueError, match="mask must be bfloat16"):
        lstm_cuda.lstm_layer_masked_int8(x, w, s, h0, c0, mask.float())
    with pytest.raises(ValueError, match="w_scale must be float32"):
        lstm_cuda.lstm_layer_int8(x, w, s.to(BF16), h0, c0)
    with pytest.raises(ValueError, match="h0 must be bfloat16"):
        lstm_cuda.lstm_layer_int8(x, w, s, h0.float(), c0)
    with pytest.raises(ValueError, match="forward inputs are"):
        lstm_cuda.bilstm_layer_int8(x, x.float(), w, w, s, s, h0, c0,
                                    h0.float(), c0.float())


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """Random `init_all_modules(PRNGKey(0))` params: (JAX float32, JAX int8
    on bf16 params, the port's float32 modules, the port's int8 on bf16
    params)."""
    p32 = jax_init_all_modules(jax.random.PRNGKey(0))
    jq16 = jax_quantize_params_int8(jax_cast_params(p32, jnp.bfloat16))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, p32),
                             device="cpu")
    return p32, jq16, params, quantize_params_int8(cast_params(params, BF16))


def _bits(leaf) -> np.ndarray:
    """A leaf's bytes as a comparable array: bf16 (torch or ml_dtypes) as
    its uint16 bits, anything else as it is."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == BF16:
            return leaf.contiguous().view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _assert_same_tree(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_quantized_bf16_cast_matches_jax_bit_for_bit(weights):
    """`quantize_params_int8(cast_params(p, bf16))`: int8 weights, float32
    scales, float32 `b` and bf16 linears, the JAX package's bytes; the
    bf16 input is left as it was."""
    _, jq16, params, q16 = weights
    _assert_same_tree(params_to_jax(q16), jq16)
    d = q16["joints"].lstm[1]["bwd"]
    assert d.w_hh.dtype == torch.int8 and d.w_hh_scale.dtype == torch.float32
    assert d.b.dtype == torch.float32
    assert q16["joints"].linear2.weight.dtype == BF16
    p16 = cast_params(params, BF16)
    quantize_params_int8(p16)
    assert p16["poser"].lstm[0]["fwd"].w_ih.dtype == BF16


@pytest.mark.parametrize("order", ["cast_of_quantized", "requantized_cast"])
def test_cast_of_a_quantized_tree_matches_jax(weights, order):
    """`cast_params` of a quantized tree casts `b` and the linears and
    leaves the int8 tensors and the scales alone, leaf for leaf as the JAX
    package's `_cast_program` does: on float32-quantized params, and on
    int8 on bf16 params (whose float32 `b` a re-cast makes bf16, as
    `evaluate_pose(bf16=True)` re-casts in both packages)."""
    p32, jq16, params, q16 = weights
    if order == "cast_of_quantized":
        got = cast_params(quantize_params_int8(params), BF16)
        want = jax_cast_params(jax_quantize_params_int8(p32), jnp.bfloat16)
    else:
        got = cast_params(q16, BF16)
        want = jax_cast_params(jq16, jnp.bfloat16)
    _assert_same_tree(params_to_jax(got), want)
    assert got["velocity"].lstm[0]["fwd"].b.dtype == BF16


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    return (JaxNet(JaxBody.synthetic(num_vertices=240)),
            MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                           device="cpu"))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _assert_slice(got, refs):
    """Joints within SLICE_REL of both references (the JAX package's int8
    on bf16 params and its float32 path), pose of the float32 one. Pose is
    a rotation made from a normalized 6D output: int8 and bf16 move it
    ~0.04 from float32 in each package (0.037 in the JAX package, 0.041
    in the port, measured on these inputs), in directions of their own, so
    the two int8-on-bf16 paths can lie ~0.07 apart while each is as close
    to float32 as the other."""
    (_, want_q), (_, want_f) = refs
    for ref_name, name, g, w in (
            (refs[0][0], "joints", got[1], want_q[1]),
            (refs[1][0], "joints", got[1], want_f[1]),
            (refs[1][0], "pose", got[0], want_f[0])):
        rel = _rel(g, w)
        assert rel < SLICE_REL, f"{name} vs {ref_name}: {rel:.4f}"


def test_int8_bf16_forward_matches_jax(weights, nets):
    """The single-window forward ('auto') on int8 on bf16 params and a
    bf16 IMU: bf16 outputs within 0.06 of the JAX package's int8-on-bf16
    forward and of its float32 forward."""
    p32, jq16, _, q16 = weights
    body = nets[1].body_model
    imu = (np.random.RandomState(5).randn(2, 8, 60) * 0.1).astype(np.float32)
    imu_j, imu_t = _bf16(imu)
    got = forward(q16, imu_t, body)
    assert all(t.dtype == BF16 for t in got[:4])
    run = jax.jit(lambda p, x: jax_forward(p, x, nets[0].body_model))
    _assert_slice(got, [("jax int8 bf16", run(jq16, imu_j)),
                        ("jax float32", run(p32, jnp.asarray(imu)))])


@pytest.mark.parametrize("mode,S,N", [("scan", 2, 4), ("unfolded", 2, 5)])
def test_int8_bf16_exact_streaming_matches_jax(weights, nets, mode, S, N):
    """`forward_online_sequence_batched` on int8 on bf16 params, a bf16
    state and bf16 frames within 0.06 of the JAX package's int8-on-bf16
    and float32 paths; the fusion state stays float32."""
    p32, jq16, _, q16 = weights
    jnet, net = nets
    frames = (np.random.RandomState(6).randn(N, S, 60) * 0.3).astype(
        np.float32)
    fj, ft = _bf16(frames)
    st = net.init_online_state_batched(S, dtype=BF16)
    got, st = net.forward_online_sequence_batched(q16, st, ft, mode=mode,
                                                  chunk=3)
    assert got[0].dtype == got[1].dtype == BF16 and st.vel_h.dtype == BF16
    assert st.last_root_pos.dtype == torch.float32
    run = jax.jit(jnet.forward_online_sequence_batched,
                  static_argnames=("mode", "chunk"))
    refs = [(name, run(p, jnet.init_online_state_batched(S, dtype=dt), f,
                       mode=mode, chunk=3)[0])
            for name, p, f, dt in (
                ("jax int8 bf16", jq16, fj, jnp.bfloat16),
                ("jax float32", p32, jnp.asarray(frames), jnp.float32))]
    _assert_slice(got, refs)
    assert np.all(np.isfinite(got[2].numpy()))


def test_int8_bf16_carry_streaming_matches_jax(weights, nets):
    """Carry mode on int8 on bf16 params and a bf16 state (the int8 cell
    with its gates cast to bf16): within 0.06 of the JAX package's
    int8-on-bf16 and float32 carry paths."""
    p32, jq16, _, q16 = weights
    jnet, net = nets
    S, N = 2, 7
    frames = (np.random.RandomState(7).randn(N, S, 60) * 0.3).astype(
        np.float32)
    fj, ft = _bf16(frames)
    got, st = net.forward_carry_sequence_batched(
        q16, net.init_carry_state_batched(S, BF16), ft)
    assert got[1].dtype == st.joints.f1_h.dtype == BF16
    run = jax.jit(jnet.forward_carry_sequence_batched)
    refs = [(name, run(p, jnet.init_carry_state_batched(S, dt), f)[0])
            for name, p, f, dt in (
                ("jax int8 bf16", jq16, fj, jnp.bfloat16),
                ("jax float32", p32, jnp.asarray(frames), jnp.float32))]
    _assert_slice(got, refs)


def test_int8_cell_step_keeps_bf16_carry(weights):
    """tests/test_quant.py:83-87: the int8 cell step on bf16 inputs returns
    bf16 h and c (its float32 gates cast to bf16 first), and in float32 it
    is the step it was."""
    _, _, params, q16 = weights
    d = q16["joints"].lstm[0]["fwd"]
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 256).astype(np.float32))
    h = torch.from_numpy(np.tanh(rng.randn(3, 256)).astype(np.float32))
    c = torch.from_numpy(rng.randn(3, 256).astype(np.float32))
    hb, cb = lstm_cell_step(d, x.to(BF16), h.to(BF16), c.to(BF16))
    assert hb.dtype == cb.dtype == BF16
    h1, c1 = lstm_cell_step(d, x, h, c)
    assert h1.dtype == torch.float32
    assert float((hb.float() - h1).abs().max()) < 0.02


# ---------------------------------------------------------------------------
# Serving and evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,given", [("exact", "bf16"),
                                        ("carry", "bf16"),
                                        ("exact", "quantized bf16")])
def test_int8_bf16_server_round_trip(weights, nets, mode, given):
    """`PoseServer(bf16 params, quantize='int8')` takes the bf16 dtype and
    then quantizes (the JAX server's order); an already-quantized bf16
    tree (float32 scales and `b` beside bf16 linears) serves in bf16 too.
    Replies come back finite."""
    _, _, params, q16 = weights
    _, net = nets
    if given == "bf16":
        srv = PoseServer(net, cast_params(params, BF16), host="127.0.0.1",
                         port=0, max_streams=2, tick_hz=120.0, mode=mode,
                         quantize="int8")
    else:
        srv = PoseServer(net, q16, host="127.0.0.1", port=0, max_streams=2,
                         tick_hz=120.0, mode=mode)
    assert srv.dtype == BF16 and srv.states.vel_h.dtype == BF16
    d = srv.params["velocity"].lstm[0]["fwd"]
    assert d.w_ih.dtype == torch.int8 and d.b.dtype == torch.float32
    thread = threading.Thread(target=srv.run, daemon=True)
    thread.start()
    client = PoseClient(stream_id=4, port=srv.port, timeout=30.0)
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
    d = tmp_path_factory.mktemp("int8_bf16_eval")
    jbody = JaxBody.synthetic(num_vertices=240)
    body = ParametricModel.synthetic(num_vertices=240)
    make_synthetic_processed_dataset(d / "synthetic.pt", n_sequences=2,
                                     T=60, seed=42, body_model=jbody)
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


def test_evaluate_pose_bf16_runs_the_masked_int8_bf16_path(cli_env, nets,
                                                           monkeypatch):
    """`evaluate_pose(bf16=True)` on quantized params re-casts them (`b`
    bf16, the int8 tensors and scales kept) and feeds the offline groups in
    bf16 to the masked int8 layers (the plain versions on the CPU)."""
    from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
    _, net = nets
    params = quantize_params_int8(cast_params(
        params_from_jax(load_npz(_FIXTURE), device="cpu"), BF16))
    seen = []
    plain = lstm_cuda.bilstm_layer_masked_int8_plain

    def spy(*args):
        seen.append((args[0].dtype, args[2].dtype, args[-1].dtype))
        return plain(*args)
    monkeypatch.setattr(lstm_cuda, "bilstm_layer_masked_int8_plain", spy)
    ds = PoseDataset(fold="test", evaluate="dip", body_model=net.body_model,
                     data_files=[cli_env / "synthetic.pt"], device="cpu")
    res = evaluate_pose(net, params, EvalSequence(ds), bf16=True,
                        verbose=False)
    assert seen and set(seen) == {(BF16, torch.int8, BF16)}
    assert np.all(np.isfinite(res["offline"]))
    # the caller's params are left as they were
    assert params["joints"].lstm[0]["fwd"].b.dtype == torch.float32


def test_cli_evaluate_int8_bf16_matches_jax_cli(cli_env, monkeypatch):
    """`cli.evaluate --int8 --bf16 --online --device cpu` (the
    trained fixture cast, then quantized, then evaluated in bf16) against
    the JAX CLI with the same flags, its `evaluate_pose` result captured,
    within the int8 bounds on rows 0, 3 and 6 of both tables."""
    captured = {}
    jax_evaluate_pose = jax_eval_cli.evaluate_pose

    def capture(*args, **kwargs):
        captured.update(jax_evaluate_pose(*args, **kwargs))
        return captured
    monkeypatch.setattr(jax_eval_cli, "evaluate_pose", capture)
    argv = ["--model", _FIXTURE, "--dataset", "synthetic", "--online",
            "--int8", "--bf16"]
    jax_eval_cli.main(argv)
    got = eval_cli.main(argv + ["--device", "cpu"])
    assert got.keys() == captured.keys() == {"offline", "online"}
    for k in ("offline", "online"):
        assert got[k].shape == (8, 2) and np.all(np.isfinite(got[k]))
        for row, bound in TABLE_BOUND.items():
            assert abs(got[k][row, 0] - captured[k][row, 0]) < bound, \
                (k, row, got[k][row, 0], captured[k][row, 0])
