"""The training kernels' plain versions (#7 forward, #8 backward) and the
port's differentiable LSTM against the JAX package's Pallas training
kernels, run in interpret mode on the CPU as `tests/test_train_pallas.py`
runs them, at its size: T = 11, B = 4, D = 6, H = 8.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are stated at each assert.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.ops.lstm_train_pallas import (_bwd_call, _fwd_call,
                                                   lstm_forward_train_pallas)
from mobileposer_tpu_torch.nn.lstm import (LSTMConfig, LSTMDirection,
                                           RNNBlock, _lstm_scan, lstm_forward,
                                           rnn_apply)
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda

T, B, D, H = 11, 4, 6, 8
LENGTHS = np.array([11, 7, 1, 0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the plain loops are many small ops, which
    torch's thread pool slows down beside other busy test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layer_inputs(seed):
    """x_proj, w_hh, h0, c0 (nonzero) and the ragged mask of LENGTHS."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    x_proj = (rng.randn(T, B, 4 * H) * 0.7).astype(f32)
    w_hh = rng.uniform(-0.35, 0.35, (H, 4 * H)).astype(f32)
    h0 = (rng.randn(B, H) * 0.3).astype(f32)
    c0 = (rng.randn(B, H) * 0.3).astype(f32)
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(f32)
    return x_proj, w_hh, h0, c0, mask


@pytest.fixture(scope="module")
def forward_pair():
    """The plain forward and the interpreted Pallas forward on one input."""
    args = _layer_inputs(0)
    got = train_cuda.lstm_train_fwd(*map(torch.from_numpy, args))
    want = _fwd_call(*map(jnp.asarray, args), interpret=True)
    return args, got, want


def test_plain_forward_matches_pallas_fwd_call(forward_pair):
    """ys, acts, hseq, cseq, h_T, c_T at 1e-6 (float32 rounding of the
    same formulas); ys exactly zero at masked steps."""
    args, got, want = forward_pair
    names = ("ys", "acts", "hseq", "cseq", "h_T", "c_T")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)
    mask = args[4]
    assert np.all(got[0].numpy()[mask == 0] == 0.0)


def test_plain_backward_matches_pallas_bwd_call(forward_pair):
    """dx_proj, dw_hh, dh0, dc0 at 1e-6 on the same residuals (the JAX
    forward's), with random dy, dh_T and dc_T."""
    (x_proj, w_hh, h0, c0, mask), _, fwd = forward_pair
    _, acts, hseq, cseq, _, _ = (np.asarray(a) for a in fwd)
    rng = np.random.RandomState(1)
    dy = rng.randn(T, B, H).astype(np.float32)
    dh_t = rng.randn(B, H).astype(np.float32)
    dc_t = rng.randn(B, H).astype(np.float32)
    h_prev = np.concatenate([h0[None], hseq[:-1]])
    c_prev = np.concatenate([c0[None], cseq[:-1]])
    args = (dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w_hh, mask)
    got = train_cuda.lstm_train_bwd(*(torch.tensor(a) for a in args))
    want = _bwd_call(*map(jnp.asarray, args), interpret=True)
    for name, g, w in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)


def _jax_layers(bidirectional, seed=0):
    """Two layers of JAX-layout numpy params, input width D."""
    rng = np.random.RandomState(seed)
    n_dir = 2 if bidirectional else 1
    layers = []
    for li in range(2):
        d_in = D if li == 0 else H * n_dir
        layers.append({d: {
            "w_ih": rng.uniform(-0.35, 0.35, (d_in, 4 * H)),
            "w_hh": rng.uniform(-0.35, 0.35, (H, 4 * H)),
            "b_ih": rng.uniform(-0.35, 0.35, (4 * H,)),
            "b_hh": rng.uniform(-0.35, 0.35, (4 * H,))}
            for d in ["fwd", "bwd"][:n_dir]})
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), layers)


def _torch_layers(layers):
    """The port's LSTM stack (LSTMDirection modules) carrying `layers`,
    gradients on."""
    stack = torch.nn.ModuleList()
    for dirs in layers:
        mods = torch.nn.ModuleDict()
        for d, p in dirs.items():
            mods[d] = LSTMDirection(p["w_ih"].shape[0], H, device="cpu")
            for k, v in p.items():
                getattr(mods[d], k).data.copy_(torch.from_numpy(v))
        stack.append(mods)
    return stack


@pytest.mark.parametrize("bidirectional,ragged", [
    (True, True), (True, False), (False, True), (False, False)])
def test_lstm_forward_train_matches_jax(bidirectional, ragged):
    """`lstm_forward(backend='auto_train')` (the autograd Function over
    the plain versions) against `lstm_forward_train_pallas(interpret=True)`:
    outputs and final carries at 1e-6, and the gradients of the
    tests/test_train_pallas.py loss (outputs and both final carries) with
    respect to every parameter, x, h0 and c0 at 1e-5."""
    n_dir = 2 if bidirectional else 1
    layers = _jax_layers(bidirectional)
    rng = np.random.RandomState(2)
    x = (rng.randn(B, T, D) * 0.5).astype(np.float32)
    h0 = (rng.randn(2 * n_dir, B, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(2 * n_dir, B, H) * 0.3).astype(np.float32)
    tgt = rng.randn(B, T, H * n_dir).astype(np.float32)
    lengths = LENGTHS if ragged else None

    def jax_loss(layers, x, h0, c0):
        y, (h_t, c_t) = lstm_forward_train_pallas(
            layers, x, None if lengths is None else jnp.asarray(lengths),
            (h0, c0), bidirectional=bidirectional, interpret=True)
        loss = (jnp.mean((y - tgt) ** 2) + 0.1 * jnp.mean(h_t ** 2)
                + 0.05 * jnp.mean(c_t ** 2))
        return loss, (y, h_t, c_t)

    (want_loss, want_out), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(layers, x, h0, c0)

    stack = _torch_layers(layers)
    xt, h0t, c0t = (torch.from_numpy(a).requires_grad_(True)
                    for a in (x, h0, c0))
    y, (h_t, c_t) = lstm_forward(
        stack, xt, None if lengths is None else torch.from_numpy(lengths),
        (h0t, c0t), bidirectional=bidirectional, backend="auto_train")
    loss = (torch.mean((y - torch.from_numpy(tgt)) ** 2)
            + 0.1 * torch.mean(h_t ** 2) + 0.05 * torch.mean(c_t ** 2))
    loss.backward()

    for name, g, w in zip(("y", "h_T", "c_T"), (y, h_t, c_t), want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    wl, wx, wh, wc = want_grads
    for li, dirs in enumerate(wl):
        for d, p in dirs.items():
            for k, w in p.items():
                np.testing.assert_allclose(
                    getattr(stack[li][d], k).grad.numpy(),
                    np.asarray(w), atol=1e-5, err_msg=f"{li}/{d}/{k}")
    for name, g, w in (("x", xt, wx), ("h0", h0t, wh), ("c0", c0t, wc)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


def test_autograd_function_matches_torch_autograd_of_the_scan():
    """The kernels' hand-written backward against torch autograd through
    the port's masked `_lstm_scan`, one layer-direction with nonzero
    h0/c0 and the ragged mask, a loss on ys, h_T and c_T: gradients of
    x_proj, w_hh, h0 and c0 at 1e-5 (the two round differently)."""
    args = [torch.from_numpy(a) for a in _layer_inputs(3)]
    tgt = torch.from_numpy(
        np.random.RandomState(4).randn(T, B, H).astype(np.float32))

    def loss_of(ys, h_t, c_t):
        return ((ys - tgt) ** 2).mean() + (h_t ** 2).mean() + 0.5 * (
            c_t * h_t).sum()

    grads = []
    for run in ("kernel", "scan"):
        leaves = [a.clone().requires_grad_(True) for a in args[:4]]
        if run == "kernel":
            ys, h_t, c_t = train_cuda.LSTMLayerTrain.apply(*leaves, args[4])
        else:
            ys, (h_t, c_t) = _lstm_scan(*leaves, args[4])
        loss_of(ys, h_t, c_t).backward()
        grads.append([a.grad for a in leaves])
    for name, g, w in zip(("x_proj", "w_hh", "h0", "c0"), *grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   err_msg=name)


def test_backward_takes_cotangents_autograd_leaves_out():
    """A loss on ys alone: h_T and c_T get no cotangent, which autograd
    hands over as zeros (or None with materialization off); both give the
    gradient of the same loss through `_lstm_scan` at 1e-5."""
    args = [torch.from_numpy(a) for a in _layer_inputs(5)]
    leaves = [a.clone().requires_grad_(True) for a in args[:4]]
    ys, _, _ = train_cuda.LSTMLayerTrain.apply(*leaves, args[4])
    (ys ** 2).sum().backward()
    ref = [a.clone().requires_grad_(True) for a in args[:4]]
    ys_ref, _ = _lstm_scan(*ref, args[4])
    (ys_ref ** 2).sum().backward()
    for a, r in zip(leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-5)
    ctx = type("Ctx", (), {"saved_tensors": None})()
    fwd = train_cuda.lstm_train_fwd(*args)
    ctx.saved_tensors = (fwd[1], fwd[2], fwd[3], args[2], args[3], args[1],
                         args[4])
    dx, dw, dh0, dc0, dmask, drdt = train_cuda.LSTMLayerTrain.backward(
        ctx, 2 * fwd[0], None, None)
    assert dmask is None and drdt is None
    for a, g in zip(leaves, (dx, dw, dh0, dc0)):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), atol=1e-5)


def test_auto_backend_refuses_to_cut_the_graph():
    """The inference kernels carry no gradient: 'auto' raises when grad
    mode is on and a parameter or the input requires grad, and runs under
    no_grad or with gradients off."""
    block = RNNBlock(LSTMConfig(D, 3, H), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    cfg = block.cfg
    x = torch.zeros(2, 5, D)
    rnn_apply(block, cfg, x)                       # nothing requires grad
    with pytest.raises(RuntimeError, match="auto_train"):
        rnn_apply(block, cfg, x.clone().requires_grad_(True))
    block.requires_grad_(True)
    with pytest.raises(RuntimeError, match="auto_train"):
        rnn_apply(block, cfg, x)
    with torch.no_grad():
        rnn_apply(block, cfg, x)
    y, _ = rnn_apply(block, cfg, x, backend="auto_train")
    assert y.requires_grad
    with pytest.raises(ValueError, match="dropout_keep"):
        rnn_apply(block, cfg, x, backend="auto_train", train=True)


def test_training_wrappers_check_their_inputs():
    x_proj, w_hh, h0, c0, mask = map(torch.from_numpy, _layer_inputs(6))
    with pytest.raises(ValueError, match="float32"):
        train_cuda.lstm_train_fwd(x_proj.double(), w_hh, h0, c0, mask)
    with pytest.raises(ValueError, match="mask"):
        train_cuda.lstm_train_fwd(x_proj, w_hh, h0, c0, mask[:-1])
    _, acts, hseq, cseq, _, _ = train_cuda.lstm_train_fwd(x_proj, w_hh, h0,
                                                          c0, mask)
    dy = torch.zeros(T, B, H)
    with pytest.raises(ValueError, match="contiguous"):
        train_cuda.lstm_train_bwd(dy, h0, c0, acts, cseq, hseq, cseq,
                                  w_hh.t().contiguous().t(), mask)
    with pytest.raises(ValueError, match="acts"):
        train_cuda.lstm_train_bwd(dy, h0, c0, acts[..., :-1].contiguous(),
                                  cseq, hseq, cseq, w_hh, mask)
    # every entry's counter, none launched (CPU tensors run the plain
    # versions)
    assert set(train_cuda.launches) == {
        f"lstm_train_fwd_{s}" for s in train_cuda.FWD_ENTRY.values()} | {
        f"lstm_train_bwd_{s}" for s in train_cuda.SCAN_ENTRY.values()} | {
        "lstm_train_dw_f32", "lstm_train_dw_bf16res"}
    assert set(train_cuda.launches.values()) == {0}
    # the dW reduction's slabs depend on the shapes only
    assert train_cuda._dw_slabs(125 * 256, 256) == (16, 2000)
    assert train_cuda._dw_slabs(125 * 256, 64) == (125, 256)
    assert train_cuda._dw_slabs(100, 256) == (1, 100)


@pytest.mark.parametrize("H", range(32, 257, 32))
def test_train_geometry_fits_the_card(H):
    """The scans' cluster geometry for every H the kernels take: one CTA
    per 32 hidden units, shared memory within a Hopper CTA's 232,448
    bytes, and all ceil(B / rows) clusters resident at once wherever the
    most rows allow it (the fewest rows that do); else the most rows."""
    for B in (1, 8, 37, 256, 300):
        for max_clusters in (1, 4, 14, 16, 66):
            geo = train_cuda._train_geometry(B, H, max_clusters)
            assert geo.cluster * 32 == H and geo.cluster <= 8
            assert geo.rows >= 1 and geo.rows in train_cuda._ROWS
            assert 0 < geo.fwd_smem <= 232_448
            assert 0 < geo.bwd_smem <= 232_448
            if math.ceil(B / train_cuda._ROWS[-1]) <= max_clusters:
                assert math.ceil(B / geo.rows) <= max_clusters
                smaller = [r for r in train_cuda._ROWS if r < geo.rows]
                assert all(math.ceil(B / r) > max_clusters for r in smaller)
            else:
                assert geo.rows == train_cuda._ROWS[-1]
    # the training shape at H = 256 on 16 clusters of 8: 16 rows each; on
    # the 15 an H100 holds, 18 rows; on 11, 24
    assert train_cuda._train_geometry(256, 256, 16).rows == 16
    assert train_cuda._train_geometry(256, 256, 15).rows == 18
    assert train_cuda._train_geometry(256, 256, 11).rows == 24


def test_backward_scan_takes_w_hh_as_the_forward_does(monkeypatch):
    """#8's scan gets w_hh [H, 4H] itself, the tensor the forward got (no
    transpose and no copy), and the rows of the geometry."""
    x_proj, w_hh, h0, c0, mask = map(torch.from_numpy, _layer_inputs(7))
    _, acts, hseq, cseq, _, _ = train_cuda.lstm_train_fwd(x_proj, w_hh, h0,
                                                          c0, mask)
    calls = []
    monkeypatch.setattr(train_cuda, "_call",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(
        train_cuda, "train_geometry",
        lambda b, h, dev: train_cuda._train_geometry(b, h, 16))
    dy = torch.zeros(T, B, H)
    dx, dh0, dc0, dgates = train_cuda._bwd_scan(dy, h0, c0, acts, cseq, cseq,
                                                w_hh, mask)
    (name, args), = calls
    assert name == "lstm_train_bwd_f32"
    assert args[6] is w_hh
    assert args[-4:] == (T, B, H, train_cuda._train_geometry(B, H, 16).rows)
    assert (dx.shape, dh0.shape, dc0.shape) == ((T, B, 4 * H), (B, H), (B, H))
    assert dgates is dx      # float32 I/O: the dW reduction reads dx_proj
