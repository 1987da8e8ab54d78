"""The port's W8A8 int8 path against the JAX package, on the CPU.

Quantization (`ops/quant.py`) is held bit for bit; the plain versions of
the int8 CUDA kernels (what their wrappers run on a CPU tensor) are held to
the int8 Pallas kernels they replace, run in interpret mode as
tests/test_quant.py runs them; `rnn_apply`, the streaming path and the
evaluation CLI on quantized params are held to the JAX package's. Inputs
are made with numpy from a seed and handed to both packages.

Tolerances. Quantizing the same float32 input gives the same bytes in
both packages. But torch's and XLA's sigmoid/tanh differ in the last bits
(~1e-7 in h), and once in a while that moves some h/scale across a .5
rounding boundary, so one int8 value differs by one level (a "flip",
roughly 2 * 127 * 1e-7 per quantized element). A flip moves one row's
gates by at most max|w| * scale, about (1/sqrt(H)) * (1/127) = 5e-4 at
H = 256 (7e-4 at H = 128) for h in (-1, 1). So a check that quantizes
only a few thousand elements holds 1e-6 (the float kernels' pin), and a
larger one is held to a few flips' worth, stated at each assert; a wrong
scale, rounding or dequantization order moves outputs by orders of
magnitude more.
"""

import math
import os

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
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.nn import LSTMConfig as JaxLSTMConfig
from mobileposer_tpu.nn import init_rnn, load_from_npz
from mobileposer_tpu.nn import rnn_apply as jax_rnn_apply
from mobileposer_tpu.ops import quant as jq
from mobileposer_tpu.ops.lstm_pallas import (bilstm_layer_pallas_int8,
                                             lstm_layer_masked_pallas_int8,
                                             lstm_layer_pallas_int8)
from mobileposer_tpu_torch.cli import evaluate as eval_cli
from mobileposer_tpu_torch.evaluation import pose_eval
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, OnlineState
from mobileposer_tpu_torch.nn.convert import (params_from_jax, params_to_jax,
                                              rnn_block_from_jax)
from mobileposer_tpu_torch.nn.lstm import (LSTMConfig, LSTMDirectionInt8,
                                           lstm_forward, rnn_apply)
from mobileposer_tpu_torch.ops import lstm_cuda, quant
from mobileposer_tpu_torch.train.trainer import make_optimizer

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")
# the shapes of tests/test_quant.py's kernel pin
T, B, H = 12, 3, 128
LENGTHS = np.array([12, 5, 0], np.int32)      # a full row and an empty one


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: one torch thread, as tests/test_torch_eval.py
    runs them beside other busy test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def random_tree():
    return jax.tree_util.tree_map(np.asarray,
                                  jax_init_all_modules(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trained_tree():
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  load_from_npz(_FIXTURE))


def _jax_quantized(tree):
    return jax.tree_util.tree_map(np.asarray, jq.quantize_params_int8(tree))


# ---------------------------------------------------------------------------
# Quantization: bit-identical
# ---------------------------------------------------------------------------

def test_quantize_weight_and_params_bit_identical(random_tree):
    """Same float32 weights, same int8 arrays and scales (exact), a column
    of zeros included; linears untouched; the input left as it was."""
    w = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    w[:, 5] = 0.0
    for got, want in zip(quant.quantize_weight_int8(w),
                         jq.quantize_weight_int8(w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert quant.quantize_weight_int8(w)[1][5] == np.float32(1e-12)

    tree = jax.tree_util.tree_map(np.copy, random_tree)
    tree["velocity"]["lstm"][1]["fwd"]["w_hh"][:, 7] = 0.0
    params = params_from_jax(tree, device="cpu")
    qparams = quant.quantize_params_int8(params)
    _assert_trees_equal(params_to_jax(qparams), _jax_quantized(tree))
    # the float modules are left as they were
    _assert_trees_equal(params_to_jax(params), tree)
    d = qparams["joints"].lstm[0]["fwd"]
    assert isinstance(d, LSTMDirectionInt8) and quant.is_quantized(d)
    assert not list(d.parameters())     # buffers: no gradient to ask for
    # one RNN block alone; nothing to quantize raises, as the JAX one does
    block = quant.quantize_params_int8(params["footcontact"])
    assert quant.is_quantized(block.lstm[1]["bwd"])
    with pytest.raises(ValueError, match="no LSTM stack"):
        quant.quantize_params_int8(torch.nn.ModuleDict(
            {"lin": torch.nn.Linear(2, 2)}))
    with pytest.raises(ValueError, match="quantized already"):
        quant.quantize_params_int8(qparams)


def test_dynamic_quantize_bit_identical():
    """q and scale equal the JAX package's bit for bit (exact): values on
    .5 boundaries round half to even, a zero row gets scale 1e-12 and
    zeros, and random rows take the reciprocal-multiply scale that XLA
    compiles `amax / 127` into (a true division differs in ~5% of rows)."""
    edge = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    rows = np.zeros((2003, 8), np.float32)
    rows[0] = edge
    rows[2] = np.random.RandomState(1).randn(8)
    rows[3:] = (np.random.RandomState(2).randn(2000, 8)
                * np.random.RandomState(3).rand(2000, 1) * 5)
    q, s = quant.dynamic_quantize(torch.from_numpy(rows))
    # the boundary row: scale exactly 1, so x / scale sits on the .5s
    assert float(s[0, 0]) == 1.0
    np.testing.assert_array_equal(q[0].numpy(),
                                  [127, 0, 2, 2, 0, -2, 4, -126])
    assert float(s[1, 0]) == np.float32(1e-12) and not q[1].any()
    jq_q, jq_s = jax.jit(jq.dynamic_quantize)(rows)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq_s))
    true_div = torch.clamp_min(
        torch.from_numpy(rows).abs().amax(-1, keepdim=True) / 127.0, 1e-12)
    assert (true_div.numpy() != np.asarray(jq_s)).any()


def test_int8_matmul_matches_jax():
    """Exact: the int8 x int8 sums are exact on both sides (float32 holds
    them below 2^24) and the dequantization is the same three roundings
    in the same order."""
    rng = np.random.RandomState(4)
    x = (rng.randn(300, 512) * rng.rand(300, 1)).astype(np.float32)
    w_q, w_s = jq.quantize_weight_int8(rng.randn(512, 1024))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                            torch.from_numpy(w_s))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(jq.int8_matmul)(x, w_q, w_s)))
    h = np.tanh(x[:, :128])
    wh_q, wh_s = jq.quantize_weight_int8(rng.randn(128, 512))
    np.testing.assert_array_equal(
        quant.int8_recurrent_gates(*map(torch.from_numpy,
                                        (h, wh_q, wh_s))).numpy(),
        np.asarray(jax.jit(jq.int8_recurrent_gates)(h, wh_q, wh_s)))
    with pytest.raises(ValueError, match="exact"):
        quant._int8_dot(torch.zeros(2, 1041, dtype=torch.int8),
                        torch.zeros(1041, 4, dtype=torch.int8))


def test_pack_w_hh_layout():
    """Word (k4, col) holds w_hh[4*k4 .. 4*k4+3, col] in bytes 0..3."""
    w = torch.from_numpy(np.random.RandomState(5).randint(
        -127, 128, (64, 256)).astype(np.int8))
    packed = quant.pack_w_hh(w)
    assert packed.dtype == torch.int32 and packed.shape == (16, 256)
    b = packed.numpy().view(np.uint8).reshape(16, 256, 4).view(np.int8)
    np.testing.assert_array_equal(b.transpose(0, 2, 1).reshape(64, 256),
                                  w.numpy())


# ---------------------------------------------------------------------------
# The four plain layer functions against the interpreted int8 kernels
# ---------------------------------------------------------------------------

def _direction(rng):
    """x_proj [T,B,4H], quantized w_hh [H,4H] + scale, nonzero h0/c0."""
    bound = 1.0 / math.sqrt(H)
    w_q, w_s = jq.quantize_weight_int8(rng.uniform(-bound, bound,
                                                   (H, 4 * H)))
    return (rng.randn(T, B, 4 * H).astype(np.float32), w_q, w_s,
            np.tanh(rng.randn(B, H)).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32))


def _flat(out):
    return [np.asarray(x) for o in out
            for x in (o if isinstance(o, tuple) else (o,))]


def _close(got, want, atol=1e-6):
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g, w, atol=atol)


@pytest.fixture(scope="module")
def layer_inputs():
    rng = np.random.RandomState(6)
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    return _direction(rng), _direction(rng), mask


def test_int8_layers_match_interpreted_pallas(layer_inputs):
    """#4, #5 (one direction and two) and #6, plain versions through their
    wrappers on CPU tensors, against the int8 Pallas kernels in interpret
    mode. 1e-6: both sides quantize the same h at every step at this size
    and seed (no flip), so only the float32 nonlinearities differ."""
    (xf, wf, sf, h0f, c0f), (xb, wb, sb, h0b, c0b), mask = layer_inputs
    t = lambda *a: tuple(map(torch.from_numpy, a))  # noqa: E731
    j = lambda *a: tuple(map(jnp.asarray, a))        # noqa: E731

    _close(lstm_cuda.lstm_layer_int8(*t(xf, wf, sf, h0f, c0f)),
           lstm_layer_pallas_int8(*j(xf, wf, sf, h0f, c0f), interpret=True))
    got = lstm_cuda.lstm_layer_masked_int8(*t(xf, wf, sf, h0f, c0f, mask))
    _close(got, lstm_layer_masked_pallas_int8(*j(xf, wf, sf, h0f, c0f, mask),
                                              interpret=True))
    ys, (h_t, c_t) = got
    assert np.all(ys.numpy()[mask == 0] == 0.0)      # exact zeros
    np.testing.assert_array_equal(h_t[2].numpy(), h0f[2])  # empty row
    np.testing.assert_array_equal(c_t[2].numpy(), c0f[2])

    ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer_int8(
        *t(xf, xb, wf, wb, sf, sb, h0f, c0f, h0b, c0b))
    want = bilstm_layer_pallas_int8(*j(xf, xb, wf, wb, sf, sb, h0f, c0f,
                                       h0b, c0b), interpret=True)
    _close((ys_f, ys_b, hc_f, hc_b), want)

    ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer_masked_int8(
        *t(xf, xb, wf, wb, sf, sb, h0f, c0f, h0b, c0b, mask))
    for got, want in (
            ((ys_f, hc_f), lstm_layer_masked_pallas_int8(
                *j(xf, wf, sf, h0f, c0f, mask), interpret=True)),
            ((ys_b, hc_b), lstm_layer_masked_pallas_int8(
                *j(xb, wb, sb, h0b, c0b, mask), interpret=True))):
        _close(got, want)
    assert all(n == 0 for n in lstm_cuda.launches.values())


def test_int8_wrappers_reject_what_the_kernels_do_not_take(layer_inputs):
    (xf, wf, sf, h0f, c0f), _, mask = layer_inputs
    x, w, s, h0, c0 = map(torch.from_numpy, (xf, wf, sf, h0f, c0f))
    with pytest.raises(ValueError, match="w_hh must be int8"):
        lstm_cuda.lstm_layer_int8(x, w.float(), s, h0, c0)
    with pytest.raises(ValueError, match="w_scale must be float32"):
        lstm_cuda.lstm_layer_int8(x, w, s.double(), h0, c0)
    with pytest.raises(ValueError, match="w_scale must be"):
        lstm_cuda.bilstm_layer_int8(x, x, w, w, s[:-1], s, h0, c0, h0, c0)
    with pytest.raises(ValueError, match="mask must be"):
        lstm_cuda.lstm_layer_masked_int8(x, w, s, h0, c0,
                                         torch.from_numpy(mask)[:-1])
    with pytest.raises(ValueError, match="w_hh must be float32"):
        lstm_cuda.lstm_layer(x, w, h0, c0)


# ---------------------------------------------------------------------------
# The RNN block, the refusals and the weight round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False])
def test_rnn_apply_quantized_matches_jax(bidirectional):
    """Full-length and with lengths, on the JAX package's quantized tree
    loaded through `params_from_jax`. 1e-3: about 10^4 elements are
    quantized here, so a flip or two may occur, each worth <= 7e-4 on one
    gate (and carried on through the row's later steps and layer 2)."""
    jcfg = JaxLSTMConfig(60, 72, H, bidirectional=bidirectional)
    cfg = LSTMConfig(60, 72, H, bidirectional=bidirectional)
    qtree = _jax_quantized(jax.tree_util.tree_map(
        np.asarray, init_rnn(jax.random.PRNGKey(1), jcfg)))
    block = rnn_block_from_jax(qtree, cfg, "cpu")
    x = (np.random.RandomState(7).randn(4, 20, 60) * 0.5).astype(np.float32)
    lengths = np.array([20, 13, 7, 0], np.int32)
    for kw in ({}, {"lengths": lengths}):
        y_j, (h_j, c_j) = jax.jit(lambda p, x: jax_rnn_apply(
            p, jcfg, x, **{k: jnp.asarray(v) for k, v in kw.items()}))(
                qtree, x)
        y_t, (h_t, c_t) = rnn_apply(block, cfg, torch.from_numpy(x),
                                    **{k: torch.from_numpy(v)
                                       for k, v in kw.items()})
        for g, w in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


def test_quantized_params_refuse_training(random_tree):
    """Training backends, train=True and the trainer's optimizer refuse
    W8A8 params, as the JAX package's lstm_forward and rnn_apply do."""
    qparams = quant.quantize_params_int8(
        params_from_jax(random_tree, device="cpu"))
    block = qparams["footcontact"]
    cfg = LSTMConfig(132, 2, 64)
    x = torch.zeros(2, 5, 132)
    with pytest.raises(ValueError, match="inference-only"):
        lstm_forward(block.lstm, torch.zeros(2, 5, 64),
                     backend="auto_train")
    with pytest.raises(ValueError, match="inference-only"):
        lstm_forward(block.lstm, torch.zeros(2, 5, 64),
                     backend="pallas_train")
    with pytest.raises(ValueError, match="inference-only"):
        rnn_apply(block, cfg, x, train=True,
                  dropout_keep=torch.ones(2, 5, 64, dtype=torch.bool))
    with pytest.raises(ValueError, match="inference-only"):
        make_optimizer("footcontact", 1e-3, block)
    # inference under autograd is fine: int8 buffers need no gradient
    y, _ = rnn_apply(block, cfg, x)
    assert y.shape == (2, 5, 2) and y.grad_fn is None


def test_quantized_tree_round_trip(trained_tree, tmp_path):
    """The JAX package's quantized tree -> the port's modules -> back:
    every array bit-identical, dtypes included; through the port's `.npz`
    writer and reader too."""
    from mobileposer_tpu_torch.nn.convert import export_npz, load_npz
    qtree = _jax_quantized(trained_tree)
    params = params_from_jax(qtree, device="cpu")
    assert isinstance(params["velocity"].lstm[1]["fwd"], LSTMDirectionInt8)
    _assert_trees_equal(params_to_jax(params), qtree)
    export_npz(params_to_jax(params), tmp_path / "q.npz")
    _assert_trees_equal(load_npz(tmp_path / "q.npz"), qtree)
    qtree["poser"]["lstm"][0]["bwd"]["w_hh_scale"] = (
        qtree["poser"]["lstm"][0]["bwd"]["w_hh_scale"][:-1])
    with pytest.raises(ValueError, match="lstm/0/bwd/w_hh_scale"):
        params_from_jax(qtree, device="cpu")


# ---------------------------------------------------------------------------
# The slice: streaming and the evaluation CLI on quantized params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["scan", "unfolded"])
def test_sequence_batched_int8_matches_jax(mode, trained_tree):
    """S=3 streams x N=7 frames on the trained fixture quantized by each
    package, a fresh call and one continued from its final state. About
    10^6 elements are quantized per call (8 layers x 45 steps x 3 streams
    x 256 units x 7 frames), so tens of flips are expected; outputs and
    state within 2e-3, a few flips' worth after the linears and the
    r6d normalization."""
    jb = JaxBody.synthetic(num_vertices=240)
    jnet = JaxNet(jb)
    net = MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                         device="cpu")
    qtree = _jax_quantized(trained_tree)
    params = quant.quantize_params_int8(
        params_from_jax(trained_tree, device="cpu"))
    run = jax.jit(lambda p, st, f: jnet.forward_online_sequence_batched(
        p, st, f, mode=mode, chunk=3))
    S, N = 3, 7
    rng = np.random.RandomState(21)
    jst = jnet.init_online_state_batched(S)
    st = OnlineState(*(torch.from_numpy(np.asarray(x)) for x in jst))
    for call in ("fresh", "continued"):
        frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
        want = run(qtree, jst, frames)
        got = net.forward_online_sequence_batched(
            params, st, torch.from_numpy(frames), mode=mode, chunk=3)
        for name, g, w in zip(("pose", "joints", "root", "contact"),
                              got[0], want[0]):
            assert tuple(g.shape) == np.shape(w), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3,
                                       err_msg=f"{call}: {name}")
        for name, g, w in zip(OnlineState._fields, got[1], want[1]):
            np.testing.assert_allclose(
                g.numpy().astype(np.float32), np.asarray(w, np.float32),
                atol=2e-3, err_msg=f"{call}: state.{name}")
        st, jst = got[1], want[1]


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A synthetic processed file of two 60-frame sequences written by the
    JAX package, the 512-frame bucket shrunk to 128 in both packages (as
    tests/test_torch_eval.py does), and the small synthetic bodies."""
    d = tmp_path_factory.mktemp("int8_eval")
    jbody = JaxBody.synthetic(num_vertices=240)
    body = ParametricModel.synthetic(num_vertices=240)
    make_synthetic_processed_dataset(d / "synthetic.pt", n_sequences=2,
                                     T=60, seed=40, body_model=jbody)
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


def test_cli_evaluate_int8_matches_jax_cli(cli_env, monkeypatch):
    """`cli.evaluate --int8 --online --tran --device cpu` against the JAX
    CLI with the same flags (its `evaluate_pose` result captured): offline
    and ONLINE exact tables and drift. rtol 1e-3: the tables are means of
    per-frame errors, each moved by a flip's few 1e-4 at most. The jitter
    row (6) is a mean of jerks, per-frame positions times fps^3 = 27,000:
    a flip's ~1e-4 m in one frame moves that frame's jerk by ~0.03 (in its
    units of 100 m/s^3), so it is held to an absolute 2e-2."""
    captured = {}
    jax_evaluate_pose = jax_eval_cli.evaluate_pose

    def capture(*args, **kwargs):
        captured.update(jax_evaluate_pose(*args, **kwargs))
        return captured
    monkeypatch.setattr(jax_eval_cli, "evaluate_pose", capture)
    argv = ["--model", _FIXTURE, "--dataset", "synthetic", "--online",
            "--tran", "--int8"]
    jax_eval_cli.main(argv)
    got = eval_cli.main(argv + ["--device", "cpu"])
    assert got.keys() == captured.keys() == {"offline", "online",
                                             "tran_errors"}
    for k in ("offline", "online"):
        assert got[k].shape == (8, 2) and np.all(np.isfinite(got[k]))
        rows = np.arange(8) != 6
        np.testing.assert_allclose(got[k][rows], captured[k][rows],
                                   rtol=1e-3, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k][6], captured[k][6], atol=2e-2,
                                   err_msg=f"{k}: jitter")
    assert got["tran_errors"].keys() == captured["tran_errors"].keys()
    for w in captured["tran_errors"]:
        np.testing.assert_allclose(got["tran_errors"][w],
                                   captured["tran_errors"][w], rtol=1e-3)


@pytest.mark.parametrize("flags", [["--bf16"], ["--online-mode", "carry"]])
def test_cli_evaluate_int8_out_of_slice_raises(cli_env, flags):
    with pytest.raises(NotImplementedError,
                       match="item 14" if "--bf16" in flags else "item 13"):
        eval_cli.main(["--model", _FIXTURE, "--dataset", "synthetic",
                       "--device", "cpu", "--int8", *flags])


def test_cli_evaluate_int8_moves_metrics_little(cli_env):
    """int8 against float32 through the port's CLI, within the JAX
    package's own accuracy bounds (tests/test_quant.py:391-393)."""
    argv = ["--model", _FIXTURE, "--dataset", "synthetic", "--online",
            "--device", "cpu"]
    delta = eval_cli.main(argv + ["--int8"])["online"] - eval_cli.main(
        argv)["online"]
    assert abs(delta[0, 0]) < 0.5 and abs(delta[3, 0]) < 0.5
    assert abs(delta[6, 0]) < 0.2

