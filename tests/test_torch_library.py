"""The port's `RNNWithInit` (`nn/rnn_with_init.py`) and its `utils/`
(io, helpers, testing, profiling) against the JAX package's, on the CPU.

`RNNWithInit` at a small width (`LSTMConfig(6, 4, 8)`, uni- and
bidirectional, n_init = 5), its weights carried over from the JAX
initializer by `nn.convert.rnn_with_init_from_jax`: the output and
(h_T, c_T) equal `rnn_with_init_apply` at 1e-6, without and with
`lengths` (the plain versions of the scan kernels); under 'auto_train'
(the plain versions of the training kernels) the gradient of a scalar
loss for every parameter, the init MLP's included, equals `jax.grad` of
the JAX function at 1e-5 (relative to each gradient's largest entry),
with the JAX package's own dropout draw. The typed `.npz` archives are
crossed with the JAX package's `savez_typed` / `loadz_typed` bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.nn.lstm import LSTMConfig as JaxLSTMConfig
from mobileposer_tpu.nn.rnn_with_init import RNNWithInitConfig as JaxConfig
from mobileposer_tpu.nn.rnn_with_init import (init_rnn_with_init as jax_init,
                                              rnn_with_init_apply as jax_apply)
from mobileposer_tpu.utils import helpers as jhelpers
from mobileposer_tpu.utils import io as jio
from mobileposer_tpu.utils import testing as jtesting
import mobileposer_tpu_torch.utils as U
from mobileposer_tpu_torch.nn import (LSTMConfig, RNNWithInit,
                                      RNNWithInitConfig, cast_params,
                                      init_rnn_with_init, rnn_with_init_apply)
from mobileposer_tpu_torch.nn.convert import (load_npz, rnn_with_init_from_jax)
from mobileposer_tpu_torch.utils import helpers, io, profiling

FWD_TOL = 1e-6
GRAD_TOL = 1e-5
B, T, N_INIT = 3, 7, 5
LENGTHS = np.array([7, 4, 2])
_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(bi):
    return (JaxConfig(JaxLSTMConfig(6, 4, 8, bidirectional=bi), N_INIT),
            RNNWithInitConfig(LSTMConfig(6, 4, 8, bidirectional=bi), N_INIT))


@pytest.fixture(scope="module", params=[False, True], ids=["uni", "bi"])
def case(request):
    bi = request.param
    jcfg, cfg = _cfgs(bi)
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.RandomState(11)
    x = rng.randn(B, T, 6).astype(np.float32)
    init = rng.randn(B, N_INIT).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                mod=rnn_with_init_from_jax(tree, cfg, device="cpu"),
                x=x, init=init)


def test_config_n_state():
    for bi in (False, True):
        jcfg, cfg = _cfgs(bi)
        assert cfg.n_state == jcfg.n_state == 2 * 2 * (2 if bi else 1) * 8


@pytest.mark.parametrize("ragged", [False, True])
def test_forward_equals_jax(case, ragged):
    lengths = LENGTHS if ragged else None
    want_y, (want_h, want_c) = jax.jit(
        lambda p, x, i, l: jax_apply(p, case["jcfg"], x, i, l))(
            case["jparams"], case["x"], case["init"],
            None if lengths is None else jnp.asarray(lengths))
    with torch.no_grad():
        y, (h, c) = rnn_with_init_apply(
            case["mod"], case["cfg"], torch.tensor(case["x"]),
            torch.tensor(case["init"]),
            None if lengths is None else torch.tensor(lengths))
    for g, w in ((y, want_y), (h, want_h), (c, want_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL)
    # the module's forward is the same function
    with torch.no_grad():
        y2, _ = case["mod"](torch.tensor(case["x"]),
                            torch.tensor(case["init"]))
    if not ragged:
        assert torch.equal(y2, y)


def _jax_path(name: str):
    """The JAX pytree path and transpose flag of a port parameter name."""
    parts = name.split(".")
    if parts[0].startswith("init"):
        return [parts[0], "w" if parts[1] == "weight" else "b"], \
            parts[1] == "weight"
    if parts[1] in ("linear1", "linear2"):
        return ["rnn", parts[1], "w" if parts[2] == "weight" else "b"], \
            parts[2] == "weight"
    return ["rnn", "lstm", int(parts[2]), parts[3], parts[4]], False


@pytest.mark.parametrize("ragged", [False, True])
def test_auto_train_gradients_equal_jax_grad(case, ragged):
    """Every parameter's gradient, the init MLP's included (through the
    training scan's dh0 and dc0), against `jax.grad`, with dropout on
    (the JAX package's draw handed to the port as its keep mask)."""
    jcfg, cfg = case["jcfg"], case["cfg"]
    lengths = LENGTHS if ragged else None
    rng = np.random.RandomState(5)
    wy = rng.randn(B, T, 4).astype(np.float32)
    n_stack = 2 * (2 if cfg.rnn.bidirectional else 1)
    wh, wc = rng.randn(2, n_stack, B, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - jcfg.rnn.dropout,
                                           (B, T, 8)))

    def jax_loss(p):
        y, (h, c) = jax_apply(p, jcfg, case["x"], case["init"],
                              None if lengths is None else
                              jnp.asarray(lengths), train=True,
                              dropout_rng=key)
        return jnp.sum(y * wy) + jnp.sum(h * wh) + jnp.sum(c * wc)

    jgrads = jax.jit(jax.grad(jax_loss))(case["jparams"])

    mod = rnn_with_init_from_jax(
        jax.tree_util.tree_map(np.asarray, case["jparams"]), cfg,
        device="cpu")
    mod.requires_grad_(True)
    y, (h, c) = rnn_with_init_apply(
        mod, cfg, torch.tensor(case["x"]), torch.tensor(case["init"]),
        None if lengths is None else torch.tensor(lengths), train=True,
        dropout_keep=torch.tensor(keep))
    loss = ((y * torch.tensor(wy)).sum() + (h * torch.tensor(wh)).sum()
            + (c * torch.tensor(wc)).sum())
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert len(names) == len(jax.tree_util.tree_leaves(jgrads))
    for name, g in zip(names, grads):
        path, transpose = _jax_path(name)
        want = jgrads
        for k in path:
            want = want[k]
        want = np.asarray(want).T if transpose else np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(g.numpy() - want).max()) / scale
        assert err <= GRAD_TOL, f"{name}: {err} relative"
    # the init MLP really receives a gradient
    assert float(grads[names.index("init1.weight")].abs().max()) > 0


def test_dropout_from_a_generator(case):
    """train=True draws the keep mask from the caller's generator: the
    same seed gives the same output, and the draw is required."""
    x, init = torch.tensor(case["x"]), torch.tensor(case["init"])
    ys = [rnn_with_init_apply(case["mod"], case["cfg"], x, init, train=True,
                              generator=torch.Generator().manual_seed(1))[0]
          for _ in range(2)]
    assert torch.equal(ys[0], ys[1])
    with pytest.raises(ValueError, match="generator"):
        rnn_with_init_apply(case["mod"], case["cfg"], x, init, train=True)


def test_inference_backend_refuses_a_gradient(case):
    mod = init_rnn_with_init(torch.Generator().manual_seed(0), case["cfg"],
                             device="cpu")
    assert isinstance(mod, RNNWithInit)
    mod.requires_grad_(True)
    with pytest.raises(RuntimeError, match="auto_train"):
        rnn_with_init_apply(mod, case["cfg"], torch.tensor(case["x"]),
                            torch.tensor(case["init"]))


def test_bf16_params_refuse_training(case, monkeypatch):
    """Training on bf16 params runs: `RNNWithInit` cast to bf16 on a bf16
    input and init vector under 'auto_train' (the training kernels' bf16
    entries, their plain versions here; the init MLP's gradient comes
    through #8's bf16 dh0 and dc0), with lengths, against the JAX
    `rnn_with_init_apply` on the same bf16 params, its LSTM sent for the
    length of the test to `lstm_forward_train_pallas(interpret=True)`
    (the JAX function names no backend, so it would take its XLA scan):
    y, h_T, c_T (bf16) and every parameter's gradient (bf16) within
    GRAD_ULPS bf16 ulps of the JAX ones' largest magnitude (<= 2
    measured, on init2.weight and the bias sums). bf16 inference still
    runs."""
    from mobileposer_tpu.nn import lstm as jax_lstm
    from mobileposer_tpu.ops.lstm_train_pallas import \
        lstm_forward_train_pallas

    def routed(params_layers, x, lengths=None, h0c0=None,
               bidirectional=True, backend="xla", time_major=False):
        return lstm_forward_train_pallas(
            params_layers, x, lengths, h0c0, bidirectional=bidirectional,
            interpret=True, time_major=time_major)
    monkeypatch.setattr(jax_lstm, "lstm_forward", routed)
    GRAD_ULPS = 4
    bf16 = torch.bfloat16
    jcfg, cfg = case["jcfg"], case["cfg"]
    j16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                 case["jparams"])
    x16, init16 = (jnp.asarray(case[k]).astype(jnp.bfloat16)
                   for k in ("x", "init"))
    rng = np.random.RandomState(5)
    wy = rng.randn(B, T, 4).astype(np.float32)
    n_stack = 2 * (2 if cfg.rnn.bidirectional else 1)
    wh, wc = rng.randn(2, n_stack, B, 8).astype(np.float32)

    def jax_loss(p):
        y, (h, c) = jax_apply(p, jcfg, x16, init16, jnp.asarray(LENGTHS))
        f32 = jnp.float32
        return (jnp.sum(y.astype(f32) * wy) + jnp.sum(h.astype(f32) * wh)
                + jnp.sum(c.astype(f32) * wc)), (y, h, c)
    (_, outs), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(j16)

    def ulps(got, want):
        want = np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
        return float(np.abs(got.float().detach().numpy() - want).max()) / ulp

    mod = cast_params(case["mod"], bf16).requires_grad_(True)
    y, (h, c) = rnn_with_init_apply(
        mod, cfg, torch.tensor(case["x"]).to(bf16),
        torch.tensor(case["init"]).to(bf16), torch.tensor(LENGTHS),
        backend="auto_train")
    for name, got, want in zip(("y", "h_T", "c_T"), (y, h, c), outs):
        assert got.dtype == bf16 and ulps(got, want) <= GRAD_ULPS, name
    loss = ((y.float() * torch.tensor(wy)).sum()
            + (h.float() * torch.tensor(wh)).sum()
            + (c.float() * torch.tensor(wc)).sum())
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad(loss, params)
    for name, g in zip(names, grads):
        path, transpose = _jax_path(name)
        want = jgrads
        for k in path:
            want = want[k]
        want = np.asarray(want, np.float32)
        assert g.dtype == bf16
        assert ulps(g.t() if transpose else g, want) <= GRAD_ULPS, name
    assert float(grads[names.index("init1.weight")].abs().max()) > 0
    with torch.no_grad():      # bf16 inference runs
        y, _ = rnn_with_init_apply(mod, cfg, torch.tensor(case["x"]).to(bf16),
                                   torch.tensor(case["init"]).to(bf16))
    assert y.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def _typed_flat():
    bits = np.random.RandomState(2).randint(0, 1 << 16, (3, 5)).astype(
        np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80      # no NaN/inf patterns
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "bf": bits, "flag": np.asarray(True),
            "name": np.asarray("poser"), "count": np.asarray(7)}


def test_savez_typed_port_to_jax(tmp_path):
    flat = _typed_flat()
    bits = flat.pop("bf")
    flat["bf"] = io.bf16_from_bits(bits)
    io.savez_typed(tmp_path / "t.npz", flat)
    back = jio.loadz_typed(tmp_path / "t.npz")
    assert str(back["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(back["bf"].view(np.uint16), bits)
    np.testing.assert_array_equal(back["w"], flat["w"])
    assert bool(back["flag"]) and str(back["name"]) == "poser"
    assert int(back["count"]) == 7


def test_savez_typed_jax_to_port(tmp_path):
    flat = _typed_flat()
    bits = flat["bf"]
    flat["bf"] = jnp.asarray(bits.view(jnp.bfloat16.dtype))
    jio.savez_typed(tmp_path / "j.npz", flat)
    back = io.loadz_typed(tmp_path / "j.npz")
    assert back["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(io.bf16_bits(back["bf"]), bits)
    np.testing.assert_array_equal(back["w"], flat["w"])
    # the same archive, written by either package
    io.savez_typed(tmp_path / "t.npz", back)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # a legacy archive (no manifest) loads as a plain dict
    np.savez(tmp_path / "legacy.npz", w=flat["w"])
    assert set(io.loadz_typed(tmp_path / "legacy.npz")) == {"w"}


def test_weights_archive_still_loads():
    """`load_npz` (checkpoints, bundles' weights) reads through
    `utils.io.loadz_typed`."""
    tree = load_npz(_FIXTURE)
    assert tree["poser"]["lstm"][0]["fwd"]["w_hh"].shape == (256, 1024)


def test_txt_io_and_dirs(tmp_path):
    m = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    U.save_txt_mat(tmp_path / "m.txt", m)
    jio.save_txt_mat(tmp_path / "j.txt", m)
    assert (tmp_path / "m.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    np.testing.assert_array_equal(U.load_txt_mat(tmp_path / "m.txt"),
                                  jio.load_txt_mat(tmp_path / "m.txt"))
    assert U.make_dir(tmp_path / "a" / "b").is_dir()
    assert len(U.get_datestring()) == len(jio.get_datestring()) == 15


def test_helpers(monkeypatch):
    for value in ("0", "1", "", "yes", "2"):
        monkeypatch.setenv("MP_FLAG", value)
        assert U.getenv_flag("MP_FLAG") == jhelpers.getenv_flag("MP_FLAG")
    monkeypatch.delenv("MP_FLAG")
    assert U.getenv_flag("MP_FLAG", True) is True
    assert helpers.host_cache_dir("x") == jhelpers.host_cache_dir("x")
    assert helpers.host_cache_dir() == jhelpers.host_cache_dir()


def test_evaluate_helpers():
    batches = [{"x": np.full((2,), v)} for v in (1.0, 2.0, 3.0)]
    predict = lambda b: b["x"] * 2
    l1 = lambda p, b: np.mean(np.abs(p - b["x"]))
    l2 = lambda p, b: np.mean((p - b["x"]) ** 2)
    np.testing.assert_array_equal(
        U.evaluate_over_dataset(predict, [l1, l2], batches),
        jtesting.evaluate_over_dataset(predict, [l1, l2], batches))
    np.testing.assert_array_equal(
        U.evaluate_next_batch(predict, [l1], batches),
        jtesting.evaluate_next_batch(predict, [l1], batches))
    with pytest.raises(ValueError, match="no batches"):
        U.evaluate_over_dataset(predict, [l1], [])


def test_profiling_on_the_cpu(tmp_path):
    timer = U.StepTimer(window=3)
    for _ in range(5):
        dt = timer.measure(lambda a: (a @ a, {"b": [a + 1]}), torch.ones(8, 8))
        assert dt > 0
    assert len(timer.samples) == 3 and timer.mean > 0 and timer.p50 > 0
    assert profiling._devices((torch.ones(1), [torch.ones(1)])) == set()
    assert U.device_memory_stats("cpu") is None
    with U.trace(str(tmp_path / "t")):
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert U.f32_matmuls is not None


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert U.device_memory_stats() is None
