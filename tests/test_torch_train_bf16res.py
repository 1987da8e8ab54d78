"""bf16 training residuals (`residual_dtype=torch.bfloat16`, backend
'auto_train_bf16res', `cli.train --bf16-residuals`) on the CPU: the
training kernels' plain versions and the port's differentiable LSTM
against the JAX package's Pallas training kernels with
`residual_dtype=jnp.bfloat16`, run in interpret mode as
`tests/test_train_pallas.py` runs them, at its size (T = 11, B = 4,
D = 6, H = 8); then the trainer and the CLI on the CPU.

The JAX package's `TrainingManager` resolves 'auto_train_bf16res' to its
float32 XLA path off the TPU (`nn/lstm.py:198-201` there); the port's CPU
path runs the kernels' plain versions with the residuals rounded to bf16,
so the CPU runs the arithmetic of the card's bf16res entries.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are stated at each assert.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.ops.lstm_train_pallas import (_bwd_call, _fwd_call,
                                                   lstm_forward_train_pallas)
from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.cli import train as train_cli
from mobileposer_tpu_torch.data import PoseDataset, fixtures
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.nn.lstm import lstm_forward
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda
from mobileposer_tpu_torch.train import trainer
from test_torch_train_kernels import (B, H, LENGTHS, T, _jax_layers,
                                      _layer_inputs, _torch_layers)

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the plain loops are many small ops, which
    torch's thread pool slows down beside other busy test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf16_ulps(got, want) -> float:
    """The largest difference in bf16 ulps of want's largest magnitude."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) / ulp


def _torch(a):
    """A JAX array (bf16 included) as a torch tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def forward_pair():
    """The plain bf16res forward and the interpreted Pallas forward with
    bf16 residuals on one input."""
    args = _layer_inputs(0)
    got = train_cuda.lstm_train_fwd(*map(torch.from_numpy, args),
                                    residual_dtype=BF16)
    want = _fwd_call(*map(jnp.asarray, args), interpret=True,
                     residual_dtype=jnp.bfloat16)
    return args, got, [_torch(w) for w in want]


def test_plain_forward_matches_pallas_fwd_call_bf16res(forward_pair):
    """ys, h_T, c_T at 1e-6 (float32 rounding of the same formulas), in
    float32; acts, hseq and cseq in bf16 within 1 bf16 ulp on at most 1%
    of them (a float32 last bit apart lands a value on the other side of
    a rounding boundary now and then; PR 13's rule), and equal bit for
    bit to the port's own float32 plain residuals rounded to bf16."""
    args, got, want = forward_pair
    f32 = train_cuda.lstm_train_fwd(*map(torch.from_numpy, args))
    for i, name in ((0, "ys"), (4, "h_T"), (5, "c_T")):
        assert got[i].dtype == torch.float32
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(),
                                   atol=1e-6, err_msg=name)
        assert torch.equal(got[i], f32[i]), name
    for i, name in ((1, "acts"), (2, "hseq"), (3, "cseq")):
        assert got[i].dtype == want[i].dtype == BF16
        assert _bf16_ulps(got[i], want[i]) <= 1, name
        assert float((got[i] != want[i]).float().mean()) <= 0.01, name
        assert torch.equal(got[i], f32[i].to(BF16)), name
    assert np.all(got[0].numpy()[args[4] == 0] == 0.0)


def test_plain_backward_on_jax_bf16_residuals_matches_pallas_bwd_call(
        forward_pair):
    """dx_proj, dh0, dc0 at 1e-6 and dw_hh at 1e-5 on the same bf16
    residuals (the JAX forward's, h0 and c0 rounded into h_prev and c_prev
    as `_train_bwd` does), with random dy, dh_T and dc_T."""
    (x_proj, w_hh, h0, c0, mask), _, fwd = forward_pair
    _, acts, hseq, cseq, _, _ = fwd
    rng = np.random.RandomState(1)
    dy = rng.randn(T, B, H).astype(np.float32)
    dh_t = rng.randn(B, H).astype(np.float32)
    dc_t = rng.randn(B, H).astype(np.float32)
    h_prev = torch.cat([torch.from_numpy(h0).to(BF16)[None], hseq[:-1]])
    c_prev = torch.cat([torch.from_numpy(c0).to(BF16)[None], cseq[:-1]])
    args = [torch.from_numpy(dy), torch.from_numpy(dh_t),
            torch.from_numpy(dc_t), acts, cseq, h_prev, c_prev,
            torch.from_numpy(w_hh), torch.from_numpy(mask)]
    got = train_cuda.lstm_train_bwd(*args, residual_dtype=BF16)
    jargs = [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == BF16 else jnp.float32) for a in args]
    want = _bwd_call(*jargs, interpret=True)
    for name, g, w, tol in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, want,
                               (1e-6, 1e-5, 1e-6, 1e-6)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   err_msg=name)


def _loss_and_grads(stack, x, h0, c0, tgt, lengths, backend):
    """The tests/test_train_pallas.py loss through the port's
    `lstm_forward`: (outputs, loss, grads of every parameter, x, h0,
    c0)."""
    xt, h0t, c0t = (torch.from_numpy(a).requires_grad_(True)
                    for a in (x, h0, c0))
    for p in stack.parameters():
        p.grad = None
    y, (h_t, c_t) = lstm_forward(stack, xt, torch.from_numpy(lengths),
                                 (h0t, c0t), bidirectional=True,
                                 backend=backend)
    loss = (torch.mean((y - torch.from_numpy(tgt)) ** 2)
            + 0.1 * torch.mean(h_t ** 2) + 0.05 * torch.mean(c_t ** 2))
    loss.backward()
    grads = [p.grad.clone() for p in stack.parameters()]
    grads += [xt.grad, h0t.grad, c0t.grad]
    return (y, h_t, c_t), loss, grads


# The port's bf16res gradients against the interpreted Pallas kernels'
# with bf16 residuals: both round float32 residuals that agree to ~1e-6
# to bf16, and where one lands on the other side of a rounding boundary
# the two stored values are one bf16 ulp (at most 2^-7 of the value)
# apart. Each gradient entry is a sum of terms that each depend on one
# step's residuals, so such a flip moves it by at most 2^-7 of the terms
# it touches: held relative to each tensor's largest entry, 2^-7, plus the
# 1e-5 of the float32 path (tests/test_torch_train_kernels.py).
JAX_GRAD_RTOL = 2.0 ** -7 + 1e-5


def test_lstm_forward_train_bf16res_matches_jax_and_f32():
    """`lstm_forward(backend='auto_train_bf16res')`, bidirectional, two
    layers, ragged, nonzero h0c0: outputs, final carries and the loss at
    1e-6 of `lstm_forward_train_pallas(interpret=True,
    residual_dtype=bf16)` and equal to the port's 'auto_train' ones (the
    residuals do not touch the forward); gradients of every parameter, x,
    h0 and c0 within JAX_GRAD_RTOL of JAX's, relative to each tensor's
    largest entry, and below the JAX test's 3e-2 relative bound
    (tests/test_train_pallas.py:98-126) of the port's float32-residual
    gradients."""
    layers = _jax_layers(True)
    rng = np.random.RandomState(2)
    x = (rng.randn(B, T, 6) * 0.5).astype(np.float32)
    h0 = (rng.randn(4, B, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(4, B, H) * 0.3).astype(np.float32)
    tgt = rng.randn(B, T, 2 * H).astype(np.float32)

    def jax_loss(layers, x, h0, c0):
        y, (h_t, c_t) = lstm_forward_train_pallas(
            layers, x, jnp.asarray(LENGTHS), (h0, c0), bidirectional=True,
            interpret=True, residual_dtype=jnp.bfloat16)
        loss = (jnp.mean((y - tgt) ** 2) + 0.1 * jnp.mean(h_t ** 2)
                + 0.05 * jnp.mean(c_t ** 2))
        return loss, (y, h_t, c_t)

    (want_loss, want_out), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(layers, x, h0, c0)
    stack = _torch_layers(layers)
    out16, loss16, g16 = _loss_and_grads(stack, x, h0, c0, tgt, LENGTHS,
                                         "auto_train_bf16res")
    out32, loss32, g32 = _loss_and_grads(stack, x, h0, c0, tgt, LENGTHS,
                                         "auto_train")

    for name, g, g_f32, w in zip(("y", "h_T", "c_T"), out16, out32,
                                 want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-6, err_msg=name)
        assert torch.equal(g, g_f32), name
    np.testing.assert_allclose(float(loss16.detach()), float(want_loss),
                               rtol=1e-6)
    assert float(loss16.detach()) == float(loss32.detach())
    # the port's parameters are in `stack.parameters()` order, the JAX
    # tree's leaves in its own: match them by layer, direction and name
    wl, wx, wh, wc = want_grads
    want = [np.array(wl[li][d][k]) for li, dirs in enumerate(stack)
            for d, mod in dirs.items() for k, _ in mod.named_parameters()]
    want += [np.array(wx), np.array(wh), np.array(wc)]
    for i, (g, g_f32, w) in enumerate(zip(g16, g32, want)):
        scale = float(np.abs(w).max())
        assert float((g - torch.from_numpy(w)).abs().max()) \
            <= JAX_GRAD_RTOL * scale, i
        denom = max(1e-3, float(g_f32.abs().max()))
        assert float((g - g_f32).abs().max()) / denom < 3e-2, i
    # and bf16 residuals do change the gradients: the rounding is there
    assert any(not torch.equal(g, g_f32) for g, g_f32 in zip(g16, g32))


def test_layer_backward_rounds_h0_and_c0_to_the_residual_dtype():
    """`LSTMLayerTrain`'s backward builds h_prev and c_prev from h0 and c0
    rounded to bf16, as `_train_bwd` does: its gradients equal, bit for
    bit, the plain backward on [h0.bf16, hseq[:-1]] and [c0.bf16,
    cseq[:-1]]; the unrounded h0 and c0 would give another dw_hh and
    dx_proj (so this test sees the difference)."""
    x_proj, w_hh, h0, c0, mask = map(torch.from_numpy, _layer_inputs(3))
    leaves = [a.clone().requires_grad_(True) for a in (x_proj, w_hh, h0, c0)]
    ys, h_t, c_t = train_cuda.LSTMLayerTrain.apply(*leaves, mask, BF16)
    dy = torch.from_numpy(np.random.RandomState(4).randn(T, B, H).astype(
        np.float32))
    ((ys * dy).sum() + (h_t * c_t).sum()).backward()

    _, acts, hseq, cseq, h_fin, c_fin = train_cuda.lstm_train_fwd(
        x_proj, w_hh, h0, c0, mask, residual_dtype=BF16)
    want = []
    for h_first, c_first in ((h0.to(BF16), c0.to(BF16)), (h0, c0)):
        h_prev = torch.cat([h_first.float()[None], hseq[:-1].float()])
        c_prev = torch.cat([c_first.float()[None], cseq[:-1].float()])
        want.append(train_cuda.lstm_train_bwd_plain(
            dy, c_fin, h_fin, acts, cseq, h_prev, c_prev, w_hh, mask))
    dx, dw, dh0, dc0 = want[0]
    for name, leaf, w in zip(("x_proj", "w_hh", "h0", "c0"), leaves,
                             (dx, dw, dh0, dc0)):
        assert torch.equal(leaf.grad, w), name
    assert not torch.equal(want[1][1], dw)
    assert not torch.equal(want[1][0], dx)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """A port-written processed dataset of 2 x 60 frames and its train
    fold on the CPU."""
    root = tmp_path_factory.mktemp("bf16res")
    body = ParametricModel.synthetic(num_vertices=240)
    fixtures.make_synthetic_processed_dataset(
        root / "data" / "t.pt", n_sequences=2, T=60, seed=1, body_model=body)
    ds = PoseDataset(fold="train", body_model=body,
                     data_files=[root / "data" / "t.pt"], device="cpu")
    return root, body, ds


@pytest.fixture
def residual_dtypes(monkeypatch):
    """The residual dtype of every training forward the code runs."""
    seen = []
    fwd = train_cuda.lstm_train_fwd

    def spy(x_proj, w_hh, h0, c0, mask, residual_dtype=torch.float32):
        seen.append(residual_dtype)
        return fwd(x_proj, w_hh, h0, c0, mask, residual_dtype)

    monkeypatch.setattr(train_cuda, "lstm_train_fwd", spy)
    return seen


def test_training_manager_trains_on_bf16_residuals(processed, tmp_path,
                                                   residual_dtypes):
    """`TrainingManager(backend='auto_train_bf16res', device='cpu')`:
    `train_module` and `train_all` with fast_dev_run run every training
    layer on bf16 residuals, end with finite losses, write their
    checkpoints and move the weights."""
    root, body, ds = processed
    hypers = dataclasses.replace(C.train_hypers, batch_size=4)
    mgr = trainer.TrainingManager(fast_dev_run=True, hypers=hypers,
                                  backend="auto_train_bf16res", device="cpu")
    one = mgr.train_module("footcontact", ds, tmp_path / "one")
    assert np.isfinite(one["history"]["train_loss"]).all()
    assert trainer.get_best_checkpoint(tmp_path / "one" / "footcontact")
    n_one = len(residual_dtypes)
    assert n_one > 0
    init = trainer.init_train_state(
        "poser", torch.Generator().manual_seed(hypers.seed), hypers.lr,
        "cpu").params
    out = mgr.train_all(ds, tmp_path / "all", body_model=body,
                        log_file=str(tmp_path / "all" / "metrics.jsonl"))
    records = [json.loads(ln) for ln in
               (tmp_path / "all" / "metrics.jsonl").read_text().splitlines()]
    assert [r["module"] for r in records] == list(trainer.MODULE_NAMES)
    assert all(np.isfinite(r["train_loss"]) for r in records)
    for n in trainer.MODULE_NAMES:
        assert trainer.get_best_checkpoint(tmp_path / "all" / n)
    assert not torch.equal(out["params"]["poser"].linear1.weight,
                           init.linear1.weight)
    assert len(residual_dtypes) > n_one
    assert set(residual_dtypes) == {BF16}


def test_cli_train_bf16_residuals_writes_checkpoints(processed, tmp_path,
                                                     monkeypatch,
                                                     residual_dtypes):
    """`cli.train --concurrent --fast-dev-run --bf16-residuals --device
    cpu` trains every module on bf16 residuals and writes each module's
    checkpoint and the metrics."""
    root, _, _ = processed
    monkeypatch.setenv("MP_PROCESSED", str(root / "data"))
    ckpt = tmp_path / "ckpt"
    train_cli.main(["--concurrent", "--fast-dev-run", "--bf16-residuals",
                    "--device", "cpu", "--checkpoint-dir", str(ckpt)])
    for n in trainer.MODULE_NAMES:
        assert trainer.get_best_checkpoint(ckpt / n) is not None
    records = [json.loads(ln) for ln in
               (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == len(trainer.MODULE_NAMES)
    assert residual_dtypes and set(residual_dtypes) == {BF16}
