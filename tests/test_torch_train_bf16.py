"""Training on bf16 params on the CPU: the training kernels' plain versions
on the dtypes bf16 params give them, the port's differentiable LSTM, the
four losses, the optimizers and the train step against the JAX package on
the same bf16 params, its Pallas training kernels run in interpret mode
as `tests/test_train_pallas.py` runs them, at its size (T = 11, B = 4,
D = 6, H = 8; the losses at full width on a 2 x 24 batch).

Two dtype pairs reach the kernels on bf16 params, as JAX promotes:
a bf16 input keeps x_proj, the state and every output bf16 (the kernels'
`*_bf16` entries), and a float32 input (a float32 batch: the trainer's
case) makes x_proj, the state and the outputs float32 beside bf16 w_hh
(`*_wbf16`). Both are held here, each with float32 and bf16 residuals.

On the CPU the JAX package resolves its training backends to XLA; for the
length of a test `mobileposer_tpu.nn.lstm.lstm_forward` is patched so
that they go to `lstm_forward_train_pallas(interpret=True)` (the TPU's
route), and nothing of the JAX package changes. bf16 params cross with
`nn.convert.params_from_jax` + `cast_params`. Every bound on a bf16 value
is in bf16 ulps of the reference's largest magnitude (`_bf16_ulps`), on a
float32 one in float32 terms, each beside the value measured.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.models import modules as JM
from mobileposer_tpu.nn import lstm as jax_lstm
from mobileposer_tpu.ops.lstm_train_pallas import (_bwd_call, _fwd_call,
                                                   lstm_forward_train_pallas)
from mobileposer_tpu_torch.models import modules as M
from mobileposer_tpu_torch.models.modules import init_all_modules
from mobileposer_tpu_torch.nn.convert import cast_params, rnn_block_from_jax
from mobileposer_tpu_torch.nn.lstm import lstm_forward
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda
from mobileposer_tpu_torch.train import trainer
from test_torch_train import _batch, _grad_tree, _jax_draws, bodies, weights  # noqa: F401
from test_torch_train_bf16res import _bf16_ulps, _torch
from test_torch_train_kernels import (B, D, H, LENGTHS, T, _jax_layers,
                                      _layer_inputs, _torch_layers)

BF16, F32 = torch.bfloat16, torch.float32
# the kernels' plain versions against the interpreted Pallas kernels: the
# same float32 products and sums in another order, outputs rounded to
# bf16 (0 ulps measured; the bound tests/test_torch_bf16.py holds the
# bf16 scans to)
KERNEL_ULPS = 2
# their float32 outputs (under float32 I/O) relatively, in L2: the same
# sums in another order (1.1e-7 measured); the backward without its
# dgates rounding (plain on the widened w_hh) is 2.3e-5 or more away on
# each of dx_proj, dh0 and dc0
F32_REL_L2 = 1e-5
# gradients of bf16 params: float32 sums cast to bf16 once, the bias
# gradients summed over T x B rows in another order (2 ulps measured)
GRAD_ULPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_train_kernels(monkeypatch):
    """The JAX package's training backends on its Pallas training kernels
    in interpret mode, for the length of one test."""
    xla = jax_lstm.lstm_forward

    def routed(params_layers, x, lengths=None, h0c0=None,
               bidirectional=True, backend="xla", time_major=False):
        if backend not in ("auto_train", "pallas_train",
                           "auto_train_bf16res", "pallas_train_bf16res"):
            return xla(params_layers, x, lengths, h0c0, bidirectional,
                       backend, time_major)
        rdt = jnp.bfloat16 if backend.endswith("bf16res") else jnp.float32
        return lstm_forward_train_pallas(
            params_layers, x, lengths, h0c0, bidirectional=bidirectional,
            interpret=True, time_major=time_major, residual_dtype=rdt)
    monkeypatch.setattr(jax_lstm, "lstm_forward", routed)


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == BF16 else jnp.float32)


def _kernel_inputs(io, T_=T, seed=0):
    """`_layer_inputs` with w_hh bf16 (bf16 params) and x_proj, h0, c0 and
    the mask in `io`."""
    x, w, h0, c0, m = map(torch.from_numpy, _layer_inputs(seed))
    if T_ != T:
        rng = np.random.RandomState(seed)
        x = torch.from_numpy((rng.randn(T_, B, 4 * H) * 0.7).astype(
            np.float32))
        m = torch.ones(T_, B)
    return x.to(io), w.to(BF16), h0.to(io), c0.to(io), m.to(io)


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "wbf16"])
@pytest.mark.parametrize("rdt", [F32, BF16], ids=["f32res", "bf16res"])
def test_plain_kernels_match_pallas_on_bf16_params(io, rdt):
    """The plain forward and backward against `_fwd_call` / `_bwd_call`
    (interpret mode) on the same inputs, the backward on the JAX
    forward's residuals: every bf16 output within KERNEL_ULPS (0
    measured), every float32 one within F32_REL_L2, in the JAX dtypes
    (ys, h_T, c_T, dx_proj, dh0, dc0 in the I/O dtype, the residuals in
    `rdt`, dw_hh bf16), ys zero at masked steps; under float32 I/O the
    backward without the dgates rounding fails F32_REL_L2."""
    args = _kernel_inputs(io)
    got = train_cuda.lstm_train_fwd(*args, residual_dtype=rdt)
    want = [_torch(a) for a in _fwd_call(
        *map(_jax, args), interpret=True,
        residual_dtype=jnp.bfloat16 if rdt == BF16 else jnp.float32)]
    for name, g, w in zip(("ys", "acts", "hseq", "cseq", "h_T", "c_T"), got,
                          want):
        assert g.dtype == w.dtype, name
        assert _kernel_close(g, w), name
    assert got[0].dtype == io and got[1].dtype == rdt
    assert bool((got[0][args[4] == 0] == 0).all())

    _, acts, hseq, cseq, _, _ = want
    rng = np.random.RandomState(1)
    dy, dh_t, dc_t = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        io) for s in ((T, B, H), (B, H), (B, H)))
    h_prev = torch.cat([args[2].to(rdt)[None], hseq[:-1]])
    c_prev = torch.cat([args[3].to(rdt)[None], cseq[:-1]])
    bargs = (dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, args[1], args[4])
    gb = train_cuda.lstm_train_bwd(*bargs, residual_dtype=rdt)
    wb = [_torch(a) for a in _bwd_call(*map(_jax, bargs), interpret=True)]
    for name, g, w in zip(("dx_proj", "dw_hh", "dh0", "dc0"), gb, wb):
        assert g.dtype == w.dtype, name
        assert _kernel_close(g, w), name
    assert gb[0].dtype == io and gb[1].dtype == BF16
    if io == F32:
        unrounded = train_cuda.lstm_train_bwd(
            *bargs[:7], args[1].float(), args[4], residual_dtype=rdt)
        for i in (0, 2, 3):
            assert _rel_l2(unrounded[i], wb[i]) > F32_REL_L2, i


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm())


def _kernel_close(got, want) -> bool:
    """A bf16 output within KERNEL_ULPS, a float32 one within F32_REL_L2."""
    if got.dtype == BF16:
        return _bf16_ulps(got, want) <= KERNEL_ULPS
    return _rel_l2(got, want) <= F32_REL_L2


def _fwd_rounding_the_carry(x, w, h0, c0):
    """The plain forward (full length) with the carry rounded to bf16
    every step: what the kernels must not do."""
    h, c = h0.float(), c0.float()
    hseq = []
    for t in range(x.shape[0]):
        gates = x[t].float() + h.to(BF16).float() @ w.float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c = (torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)).to(
            BF16).float()
        h = (torch.sigmoid(o) * torch.tanh(c)).to(BF16).float()
        hseq.append(h)
    return torch.stack(hseq)


def test_long_scan_keeps_a_float32_carry_and_dw_from_float32_dgates():
    """T = 64 in bf16 I/O with float32 residuals, where the kernels' two
    roundings that must not happen would show: hseq and cseq (the float32
    carry) within 1e-5 of the JAX kernel's (1.8e-7 measured), where a
    carry rounded to bf16 every step is 1e-4 and more away (1.8e-3
    measured); dw_hh (bf16) differing from the JAX kernel's on at most 1%
    of its entries (0 measured), where dW from dgates rounded to bf16
    differs on 39% of them."""
    x, w, h0, c0, m = _kernel_inputs(BF16, T_=64, seed=5)
    got = train_cuda.lstm_train_fwd(x, w, h0, c0, m)
    want = [_torch(a) for a in _fwd_call(*map(_jax, (x, w, h0, c0, m)),
                                         interpret=True)]
    for i, name in ((2, "hseq"), (3, "cseq")):
        assert float((got[i] - want[i]).abs().max()) <= 1e-5, name
    rounded = _fwd_rounding_the_carry(x, w, h0, c0)
    assert float((rounded - want[2]).abs().max()) > 1e-4

    _, acts, hseq, cseq, _, _ = want
    rng = np.random.RandomState(6)
    dy, dh_t, dc_t = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        BF16) for s in ((64, B, H), (B, H), (B, H)))
    h_prev = torch.cat([h0.float()[None], hseq[:-1]])
    c_prev = torch.cat([c0.float()[None], cseq[:-1]])
    bargs = (dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w, m)
    dx, dw, _, _ = train_cuda.lstm_train_bwd(*bargs)
    want_dw = _torch(_bwd_call(*map(_jax, bargs), interpret=True)[1])
    assert float((dw != want_dw).float().mean()) <= 0.01
    assert _bf16_ulps(dw, want_dw) <= 1
    from_bf16 = train_cuda.lstm_train_dw_plain(h_prev, dx.float()).to(BF16)
    assert float((from_bf16 != want_dw).float().mean()) > 0.01


@pytest.mark.parametrize("io,bidirectional", [(BF16, True), (F32, False)],
                         ids=["bf16_input_bi", "f32_input_uni"])
def test_lstm_forward_train_matches_pallas_on_bf16_params(io, bidirectional):
    """Two layers of bf16 params, ragged lengths, a given (h0, c0), on a
    bf16 input (the bf16 entries) and on a float32 one (promoted: the
    wbf16 entries): outputs within KERNEL_ULPS (0 measured) and the
    gradients to every parameter (bf16), to x and to h0c0 (in x's dtype)
    within GRAD_ULPS (2 measured, on the bias sums) of the JAX function's
    (`lstm_forward_train_pallas(interpret=True)` under `jax.grad`)."""
    layers = _jax_layers(bidirectional)
    stack = cast_params(_torch_layers(layers), BF16)
    jlayers = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), layers)
    rng = np.random.RandomState(3)
    n = 4 if bidirectional else 2
    x = torch.from_numpy(rng.randn(B, T, D).astype(np.float32)).to(io)
    h0, c0 = (torch.from_numpy((rng.randn(n, B, H) * 0.3).astype(
        np.float32)).to(io) for _ in range(2))

    def jloss(p, x, hc):
        y, (h_t, c_t) = lstm_forward_train_pallas(
            p, x, jnp.asarray(LENGTHS), hc, bidirectional=bidirectional,
            interpret=True)
        f = lambda a: a.astype(jnp.float32)  # noqa: E731
        return (jnp.sum(f(y) * 0.5) + jnp.sum(f(h_t) ** 2) + jnp.sum(f(c_t)),
                (y, h_t, c_t))
    (_, outs), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jlayers, _jax(x), (_jax(h0), _jax(c0)))

    xt, h0t, c0t = (a.clone().requires_grad_(True) for a in (x, h0, c0))
    stack.requires_grad_(True)
    y, (h_t, c_t) = lstm_forward(stack, xt, torch.from_numpy(LENGTHS),
                                 (h0t, c0t), bidirectional=bidirectional,
                                 backend="auto_train")
    ((y.float() * 0.5).sum() + (h_t.float() ** 2).sum()
     + c_t.float().sum()).backward()
    for name, g, w in zip(("y", "h_T", "c_T"), (y, h_t, c_t), outs):
        assert g.dtype == io and _bf16_ulps(g.detach(), _torch(w)) \
            <= KERNEL_ULPS, name
    for name, g, w in (("x", xt.grad, grads[1]), ("h0", h0t.grad,
                                                  grads[2][0]),
                       ("c0", c0t.grad, grads[2][1])):
        assert g.dtype == io and _bf16_ulps(g, _torch(w)) <= GRAD_ULPS, name
    for li, dirs in enumerate(stack):
        for d, mod in dirs.items():
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                g = getattr(mod, k).grad
                assert g.dtype == BF16
                assert _bf16_ulps(g, _torch(grads[0][li][d][k])) \
                    <= GRAD_ULPS, (li, d, k)


@pytest.mark.parametrize("name,backend", [
    ("joints", "auto_train"), ("poser", "auto_train"),
    ("footcontact", "auto_train_bf16res"), ("velocity", "auto_train")])
def test_losses_and_gradients_on_bf16_params_match_jax(
        name, backend, weights, bodies, jax_train_kernels):
    """Each loss on bf16 params and a float32 ragged batch (2 x 24), fed
    the JAX package's draws, against the JAX loss on the same bf16 params
    through its interpreted training kernels (float32 activations beside
    bf16 weights, as JAX promotes them): the loss at rtol 3e-5 (float32
    sums in another order; 1.0e-5 measured, footcontact) and every
    parameter's gradient (bf16) within GRAD_ULPS (2 measured, poser).
    Poser runs with the body."""
    tree16 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), weights[0][name])
    rng = np.random.RandomState(len(name))
    batch = _batch(rng, 2, 24, [24, 17])
    key = jax.random.PRNGKey(7)
    jax_loss = {"joints": JM.joints_loss, "footcontact": JM.footcontact_loss,
                "velocity": JM.velocity_loss,
                "poser": lambda p, b, r, **kw: JM.poser_loss(
                    p, b, r, body_model=bodies[0], **kw)}[name]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jb, key, train=True, backend=backend)))(tree16)

    block = cast_params(rnn_block_from_jax(
        weights[0][name], M.MODULE_CONFIGS[name], "cpu"), BF16)
    block.requires_grad_(True)
    extra = {"body_model": bodies[1]} if name == "poser" else {}
    got = M.LOSSES[name](block, trainer.to_device(batch, "cpu"),
                         _jax_draws(name, batch, key), train=True,
                         backend=backend, **extra)
    got.backward()
    assert got.dtype == F32 and want.dtype == jnp.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=3e-5)
    widened = copy.deepcopy(block).float()     # the bf16 gradients, exactly
    for p, q in zip(widened.parameters(), block.parameters()):
        p.grad = q.grad.float()
    ulps = jax.tree_util.tree_map(
        lambda g, w: _bf16_ulps(torch.from_numpy(g), _torch(w)),
        _grad_tree(widened), want_g)
    assert max(jax.tree_util.tree_leaves(ulps)) <= GRAD_ULPS, ulps


@pytest.mark.parametrize("name", ["joints", "poser"])
def test_optimizer_on_bf16_params_matches_optax(name):
    """optax's adamw(1e-3) (joints) / adam(1e-3) on bf16 params, jitted,
    against `make_optimizer`'s step on the same bf16 params and
    gradients, three steps: every parameter within 1 bf16 ulp of its own
    magnitude (0 measured: `OptaxAdam` takes optax's order and roundings)
    and the moments bf16; torch's own Adam on bf16 params was ~120 ulps
    away within three steps."""
    rng = np.random.RandomState(0)
    shape = (16, 64)
    p0 = rng.uniform(-0.0625, 0.0625, shape).astype(np.float32)
    grads = [(rng.randn(*shape) * 10.0 ** rng.uniform(-4, 0, shape)).astype(
        np.float32) for _ in range(3)]
    opt = optax.adamw(1e-3) if name == "joints" else optax.adam(1e-3)
    params = jnp.asarray(p0).astype(jnp.bfloat16)
    state = opt.init(params)

    @jax.jit
    def step(params, state, g):
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state

    module = torch.nn.ParameterDict(
        {"w": torch.nn.Parameter(torch.from_numpy(p0).to(BF16))})
    topt = trainer.make_optimizer(name, 1e-3, module)
    assert isinstance(topt, trainer.OptaxAdam)
    for g in grads:
        params, state = step(params, state, jnp.asarray(g).astype(
            jnp.bfloat16))
        module["w"].grad = torch.from_numpy(g).to(BF16)
        topt.step()
        got, want = module["w"].detach().float(), _torch(params).float()
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(
            2.0 ** -126))) - 7)
        assert float(((got - want).abs() / ulp).max()) <= 1
    moments = topt.state[module["w"]]
    assert moments["mu"].dtype == moments["nu"].dtype == BF16


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_all_reduce_step_keeps_each_gradient_in_its_params_dtype(
        dtype, monkeypatch):
    """The data-parallel reduction sums in one float32 buffer beside the
    losses and hands each gradient back in its param's dtype: a bf16
    param's as bf16 (rounded after the sum), which `OptaxAdam`'s kernel
    takes; a float32 param's as a view of the buffer, as before. One rank
    (the collective a no-op) gives the gradients back unchanged."""
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t: None)
    module = torch.nn.Linear(5, 3).to(dtype)
    grads = [torch.randn(p.shape).to(dtype) for p in module.parameters()]
    for p, g in zip(module.parameters(), grads):
        p.grad = g.clone()
    loss = torch.tensor(1.5)
    out = trainer.all_reduce_step({"m": loss}, {"m": module}, 1, False)
    assert float(out["m"]) == 1.5
    for p, g in zip(module.parameters(), grads):
        assert p.grad.dtype == dtype and p.grad.is_contiguous()
        assert torch.equal(p.grad, g)


def test_init_all_modules_in_bf16():
    """`init_all_modules(dtype=bf16)` draws what the float32 call draws
    from the same seed and casts it (bit for bit `cast_params`), every
    parameter bf16, gradients off."""
    p16 = init_all_modules(torch.Generator().manual_seed(3), "cpu",
                           dtype=BF16)
    p32 = cast_params(init_all_modules(torch.Generator().manual_seed(3),
                                       "cpu"), BF16)
    assert set(p16) == set(M.MODULE_CONFIGS)
    for (k, a), (_, b) in zip(p16.named_parameters(), p32.named_parameters()):
        assert a.dtype == BF16 and not a.requires_grad, k
        assert torch.equal(a, b), k


def test_multi_train_step_on_bf16_params(bodies):
    """Two steps of `make_multi_train_step` on bf16 params and a float32
    batch on the CPU: finite losses, every parameter and moment still
    bf16, every parameter moved, and the step's losses equal to the four
    losses run by hand on the same draws (the step adds nothing)."""
    gen = torch.Generator().manual_seed(0)
    params = init_all_modules(gen, "cpu", dtype=BF16)
    states = {n: trainer.TrainState(
        params[n].requires_grad_(True),
        trainer.make_optimizer(n, 1e-3, params[n]))
        for n in trainer.MODULE_NAMES}
    before = {n: [p.detach().clone() for p in s.params.parameters()]
              for n, s in states.items()}
    step = trainer.make_multi_train_step(bodies[1])
    batch = trainer.to_device(_batch(np.random.RandomState(2), 2, 6, [6, 4]),
                              "cpu")
    fns = {n: trainer.loss_fn_for(n, bodies[1]) for n in trainer.MODULE_NAMES}
    for i in range(2):
        gen = torch.Generator().manual_seed(10 + i)
        with torch.no_grad():
            by_hand = {n: float(fns[n](states[n].params, batch, gen))
                       for n in trainer.MODULE_NAMES}
        states, losses = step(states, batch,
                              torch.Generator().manual_seed(10 + i))
        assert {n: float(v) for n, v in losses.items()} == by_hand
        assert all(np.isfinite(v) for v in by_hand.values())
    for n, s in states.items():
        assert s.step == 2
        for p, q in zip(s.params.parameters(), before[n]):
            assert p.dtype == BF16 and not torch.equal(p.detach(), q), n
        for st in s.opt.state.values():
            assert st["mu"].dtype == st["nu"].dtype == BF16
