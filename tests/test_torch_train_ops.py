"""The training kernels #7 and #8 and the multicell kernel #9 as
`torch.library` custom ops (`mobileposer_tpu_torch::lstm_layer_train`,
`::lstm_layer_train_bwd`, `::multicell_lstm`), on the CPU.

`opcheck` (schema, fake implementation, autograd registration, AOT
dispatch) on each op in float32 and bf16; `torch.compile(fullgraph=True,
backend="aot_eager")` of each module's loss (the draws passed in) and of
its backward, which must compile with no graph break and equal the eager
loss and gradients at 0.0 (both run the kernels' plain versions through
the same aten ops); and `torch.export.export` of
`forward(backend='fused')` with the weights as inputs (`serving._export`),
whose graph holds two `multicell_lstm` and two `bilstm_layer` nodes and
equals the eager forward at 0.0. Full-width modules on a 2 x 8 batch.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch import serving
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models import modules as M
from mobileposer_tpu_torch.models.modules import init_all_modules
from mobileposer_tpu_torch.models.net import forward
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda
from mobileposer_tpu_torch.ops import multicell_cuda
from mobileposer_tpu_torch.train import trainer

BF16, F32 = torch.bfloat16, torch.float32
OP = "mobileposer_tpu_torch."


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def body():
    return ParametricModel.synthetic(num_vertices=240)


def _layer_args(io, w_dtype, rdt, grad=False, seed=0, T=5, B=3, H=32):
    rng = np.random.RandomState(seed)

    def t(*shape, dtype=io, scale=0.5):
        a = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
        return a.to(dtype).requires_grad_(grad)

    mask = (torch.arange(T)[:, None] < torch.tensor([T, 3, 1])[None]).to(io)
    return (t(T, B, 4 * H), t(H, 4 * H, dtype=w_dtype, scale=0.15),
            t(B, H), t(B, H), mask, rdt)


@pytest.mark.parametrize("io,w_dtype,rdt", [
    (F32, F32, F32), (F32, F32, BF16), (BF16, BF16, F32), (F32, BF16, BF16)],
    ids=["f32", "bf16res", "bf16", "wbf16_bf16res"])
def test_opcheck_training_ops(io, w_dtype, rdt):
    """Both ops pass `opcheck`; the forward op's outputs are the wrapper's
    (ys, h_T, c_T, then the residuals), the backward op's the wrapper's,
    dW in w_hh's dtype."""
    args = _layer_args(io, w_dtype, rdt, grad=True)
    torch.library.opcheck(train_cuda.lstm_layer_train_op, args)
    out = train_cuda.lstm_layer_train_op(*args)
    plain = train_cuda.lstm_train_fwd(*(a.detach() if isinstance(
        a, torch.Tensor) else a for a in args))
    for o, p in zip(out, (plain[0], plain[4], plain[5], *plain[1:4])):
        assert torch.equal(o, p) and o.dtype == p.dtype
    ys, h_t, c_t, acts, hseq, cseq = (o.detach() for o in out)
    x, w, h0, c0, mask, _ = (a.detach() if isinstance(a, torch.Tensor)
                             else a for a in args)
    rng = np.random.RandomState(1)
    dy = torch.from_numpy(rng.randn(*ys.shape).astype(np.float32)).to(io)
    h_prev = torch.cat([h0.to(rdt)[None], hseq[:-1]])
    c_prev = torch.cat([c0.to(rdt)[None], cseq[:-1]])
    bargs = (dy, h_t, c_t, acts, cseq, h_prev, c_prev, w, mask)
    torch.library.opcheck(train_cuda.lstm_layer_train_bwd_op, bargs)
    got = train_cuda.lstm_layer_train_bwd_op(*bargs)
    want = train_cuda.lstm_train_bwd(*bargs, residual_dtype=rdt)
    for g, v in zip(got, want):
        assert torch.equal(g, v) and g.dtype == v.dtype
    assert got[1].dtype == w_dtype and got[0].dtype == io


def test_op_autograd_equals_the_autograd_function():
    """Gradients through the forward op's registered autograd (the
    backward op) equal `LSTMLayerTrain`'s at 0.0, on bf16 params with a
    float32 input and on a bf16 input."""
    for io in (F32, BF16):
        grads = []
        for fn in (train_cuda._layer_train_via_op,
                   train_cuda.LSTMLayerTrain.apply):
            args = _layer_args(io, BF16, F32, grad=True, seed=3)
            ys, h_t, c_t = fn(*args)
            (ys.float().sum() + (h_t.float() ** 2).sum()
             + c_t.float().sum()).backward()
            grads.append([a.grad for a in args[:4]])
        for a, b in zip(*grads):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_opcheck_multicell(dtype):
    """`opcheck` on the multicell op at three cells; its flat outputs are
    the wrapper's."""
    rng = np.random.RandomState(2)
    hs = [32, 64, 32]
    T, B = 4, 3

    def t(*shape, scale=0.5):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dtype)

    args = (t(T, B, 4 * sum(hs)), [t(h, 4 * h, scale=0.1) for h in hs],
            [t(B, h) for h in hs], [t(B, h) for h in hs], hs)
    torch.library.opcheck(multicell_cuda.multicell_lstm_op, args)
    ys, h_ts, c_ts = multicell_cuda.multicell_lstm(*args)
    out = multicell_cuda.multicell_lstm_op(*args)
    for a, b in zip(out, (*ys, *h_ts, *c_ts)):
        assert torch.equal(a, b) and a.dtype == dtype


def _batch(B=2, T=8, seed=4):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return trainer.to_device({
        "imu": (rng.randn(B, T, 60) * 0.3).astype(f32),
        "joints": (rng.randn(B, T, 72) * 0.3).astype(f32),
        "pose_r6d": rng.randn(B, T, 24, 6).astype(f32),
        "vels": rng.randn(B, T, 72).astype(f32),
        "contacts": (rng.rand(B, T, 2) > 0.5).astype(f32),
        "lengths": np.asarray([T, T - 3], np.int32)}, "cpu")


@pytest.mark.parametrize("name,dtype", [
    ("joints", F32), ("poser", F32), ("footcontact", F32),
    ("velocity", BF16)])
def test_compiled_loss_and_backward_equal_eager(name, dtype, body,
                                                monkeypatch):
    """Each module's loss on its draws, compiled whole with
    `fullgraph=True` (a graph break raises) by the AOT-autograd eager
    backend, forward and backward: the loss and every gradient equal the
    eager ones at 0.0; the captured graph calls the forward op once per
    layer-direction, and the compiled backward runs #8 once per
    layer-direction, as the eager step does. Velocity on bf16 params."""
    from torch._dynamo.backends.debugging import aot_eager

    params = init_all_modules(torch.Generator().manual_seed(5), "cpu",
                              dtype=dtype)[name].requires_grad_(True)
    batch = _batch()
    draws = M.draw(name, batch, torch.Generator().manual_seed(6))
    extra = {"body_model": body} if name == "poser" else {}
    cfg = M.MODULE_CONFIGS[name]
    n_dirs = cfg.n_layers * (2 if cfg.bidirectional else 1)
    bwd_calls = Counter()
    bwd = train_cuda.lstm_train_bwd

    def counted(*args, **kw):
        bwd_calls["bwd"] += 1
        return bwd(*args, **kw)
    monkeypatch.setattr(train_cuda, "lstm_train_bwd", counted)
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return aot_eager(gm, example_inputs)

    def loss_fn(block, batch, draws):
        return M.LOSSES[name](block, batch, draws, train=True,
                              backend="auto_train", **extra)

    runs = []
    for fn in (loss_fn, torch.compile(loss_fn, fullgraph=True,
                                      backend=backend)):
        params.zero_grad(set_to_none=True)
        bwd_calls.clear()
        loss = fn(params, batch, draws)
        loss.backward()
        assert bwd_calls["bwd"] == n_dirs
        runs.append((loss.detach(), [p.grad.clone()
                                     for p in params.parameters()]))
    (l_eager, g_eager), (l_comp, g_comp) = runs
    assert torch.equal(l_eager, l_comp)
    for a, b in zip(g_eager, g_comp):
        assert a.dtype == dtype and torch.equal(a, b)
    (gm,) = graphs
    assert sum(str(n.target) == OP + "lstm_layer_train.default"
               for n in gm.graph.nodes) == n_dirs


def test_fused_forward_exports_with_the_kernels_as_ops():
    """`forward(backend='fused')` exported with the weights as inputs
    (`serving._export`): two `multicell_lstm` nodes (the trio's two
    layer-rows) and two `bilstm_layer` nodes (joints), and the program's
    outputs equal the eager forward's at 0.0."""
    net = MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                         device="cpu")
    params = init_all_modules(torch.Generator().manual_seed(7), "cpu")
    imu = torch.from_numpy((np.random.RandomState(9).randn(2, 12, 60)
                            * 0.3).astype(np.float32))

    def fn(modules, imu):
        return forward(modules, imu, net.body_model, backend="fused")

    prog = serving._export(net, params, fn, (imu,), F32)
    nodes = Counter(str(n.target) for n in prog.graph.nodes
                    if n.op == "call_function"
                    and str(n.target).startswith(OP))
    assert nodes == {OP + "multicell_lstm.default": 2,
                     OP + "bilstm_layer.default": 2}
    with torch.no_grad():
        want = fn(params, imu)
        got = prog.module()(serving._weights(params), imu)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
