"""The port's fused multicell path against the JAX package, on the CPU.

The plain version of the multicell CUDA kernel (what its wrapper runs on a
CPU tensor) is held to `multicell_lstm_pallas` in interpret mode; the
port's `trio_apply` to the JAX `trio_apply(..., interpret=True)`; the
port's `forward(backend='fused')` to the JAX `forward(backend='auto')`
(the JAX fused forward calls the Pallas kernel without interpret mode,
which the CPU refuses; the JAX package pins its fused path to 'auto' at
2e-5 in tests/test_fused.py) and to the port's own 'auto'. Weights come
from the JAX `init_all_modules(PRNGKey(0))` through
`nn.convert.params_from_jax`; inputs are made with numpy from a seed and
handed to both packages.

Tolerances: 1e-6 for the plain kernel against the interpreted Pallas
kernel (float32 rounding of the same sums, as tests/test_torch_lstm.py
holds the layer kernels); 1e-5 for a chunked carry against one pass (the
JAX test's pin); 2e-5 for the trio and the whole forward (the pins of
tests/test_fused.py and tests/test_torch_net.py). Where the port is held
to itself ('fused' against 'auto' on the CPU) the same 2e-5 stands,
though both run the same products.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import forward as jax_forward
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.models.fused import trio_apply as jax_trio_apply
from mobileposer_tpu.ops.multicell_pallas import multicell_lstm_pallas
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, forward
from mobileposer_tpu_torch.models.fused import _ROW_H, trio_apply
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.ops import lstm_cuda, multicell_cuda
from mobileposer_tpu_torch.ops.multicell_cuda import (multicell_lstm,
                                                      multicell_lstm_plain)
from mobileposer_tpu_torch.ops.quant import quantize_params_int8
from mobileposer_tpu_torch.train import TrainingManager
from mobileposer_tpu_torch.train.trainer import (init_train_state,
                                                 make_train_step)

KERNEL_ATOL = 1e-6
CHUNK_ATOL = 1e-5
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small CPU ops: one torch thread beside other busy test
    processes (as tests/test_torch_eval.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


@pytest.fixture(scope="module")
def weights():
    """(JAX params as numpy, the port's modules on the CPU)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_all_modules(jax.random.PRNGKey(0)))
    return tree, params_from_jax(tree, device="cpu")


def _cells(rng, T, B, hs, scale=0.5):
    """Seeded multicell inputs as numpy: x_proj, w_hhs, h0s, c0s."""
    x = (rng.randn(T, B, 4 * sum(hs)) * scale).astype(np.float32)
    ws = [rng.uniform(-1 / np.sqrt(h), 1 / np.sqrt(h), (h, 4 * h))
          .astype(np.float32) for h in hs]
    h0s = [(rng.randn(B, h) * 0.3).astype(np.float32) for h in hs]
    c0s = [(rng.randn(B, h) * 0.3).astype(np.float32) for h in hs]
    return x, ws, h0s, c0s


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T, B, hs", [(5, 3, _ROW_H), (7, 2, (32, 16, 32))],
                         ids=["row", "narrow"])
def test_multicell_plain_matches_pallas(T, B, hs):
    """Nonzero h0/c0 in every cell; ys, h_T and c_T of every cell."""
    x, ws, h0s, c0s = _cells(np.random.RandomState(1), T, B, hs)
    want = multicell_lstm_pallas(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                 tuple(map(jnp.asarray, h0s)),
                                 tuple(map(jnp.asarray, c0s)), tuple(hs),
                                 interpret=True)
    got = multicell_lstm(torch.from_numpy(x), _t(ws), _t(h0s), _t(c0s), hs)
    for g_part, w_part in zip(got, want):
        assert len(g_part) == len(hs)
        for g, w, h in zip(g_part, w_part, hs):
            assert g.shape[-1] == h
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=KERNEL_ATOL)
    assert multicell_cuda.launches["multicell_scan_f32"] == 0


def test_multicell_chunked_carry():
    """Threading (h, c) through chunks of 4 steps equals one full pass."""
    hs, T, B = (64, 32), 12, 2
    x, ws, h0s, c0s = _cells(np.random.RandomState(2), T, B, hs)
    x, ws, h0s, c0s = torch.from_numpy(x), _t(ws), _t(h0s), _t(c0s)
    full_ys, full_h, full_c = multicell_lstm_plain(x, ws, h0s, c0s, hs)
    h, c, chunks = h0s, c0s, []
    for t0 in range(0, T, 4):
        ys, h, c = multicell_lstm_plain(x[t0:t0 + 4], ws, h, c, hs)
        chunks.append(ys)
    for i in range(len(hs)):
        np.testing.assert_allclose(
            torch.cat([ys[i] for ys in chunks]).numpy(), full_ys[i].numpy(),
            atol=CHUNK_ATOL)
        np.testing.assert_allclose(h[i].numpy(), full_h[i].numpy(),
                                   atol=CHUNK_ATOL)
        np.testing.assert_allclose(c[i].numpy(), full_c[i].numpy(),
                                   atol=CHUNK_ATOL)


def test_trio_apply_matches_jax(weights):
    tree, params = weights
    rng = np.random.RandomState(3)
    T, B = 13, 3
    x132 = (rng.randn(T, B, 132) * 0.1).astype(np.float32)
    # a perturbed velocity carry, so its threading is exercised
    hc = ((rng.randn(2, B, 256) * 0.01).astype(np.float32) + 0.01,
          (rng.randn(2, B, 256) * 0.01).astype(np.float32) - 0.02)
    want = jax_trio_apply(tree, jnp.asarray(x132),
                          tuple(map(jnp.asarray, hc)), interpret=True)
    got = trio_apply(params, torch.from_numpy(x132), tuple(_t(hc)))
    for name, g, w in zip(("r6d", "contact", "vel"), got[:3], want[:3]):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    for g, w in zip(got[3], want[3]):                   # velocity (h, c)
        assert tuple(g.shape) == (2, B, 256)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.fixture(scope="module")
def slice_inputs(weights, bodies):
    """imu [3, 45, 60], a velocity carry and the JAX 'auto' forward on
    them, pose at every frame."""
    tree, _ = weights
    rng = np.random.RandomState(4)
    imu = (rng.randn(3, 45, 60) * 0.1).astype(np.float32)
    hc = tuple((rng.randn(2, 3, 256) * 0.3).astype(np.float32)
               for _ in range(2))
    want = jax_forward(tree, imu, bodies[0], vel_h0c0=hc, backend="auto")
    return imu, hc, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("pose_index", [None, 40])
def test_fused_forward_matches_jax_and_auto(pose_index, weights, bodies,
                                            slice_inputs):
    """The slice as a whole: pose, joints, vel, contact and the velocity
    carry. With pose_index the JAX pose is the full assembly's frame 40
    (bit-identical to assembling that frame alone, net.py:246-252)."""
    _, params = weights
    imu, hc, want = slice_inputs
    args = (params, torch.from_numpy(imu), bodies[1])
    kw = dict(vel_h0c0=tuple(_t(hc)), pose_index=pose_index)
    got = forward(*args, backend="fused", **kw)
    auto = forward(*args, backend="auto", **kw)
    want_pose = want[0] if pose_index is None else want[0][:, pose_index]
    for name, g, a, w in zip(("pose", "joints", "vel", "contact"), got[:4],
                             auto[:4], (want_pose, *want[1:4])):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=ATOL,
                                   err_msg=name)
    for g, a, w in zip(got[4], auto[4], want[4]):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=ATOL)


def test_fused_with_lengths_runs_the_auto_path(weights, bodies):
    """With lengths 'fused' is the per-module masked path, as in JAX."""
    _, params = weights
    rng = np.random.RandomState(5)
    imu = torch.from_numpy((rng.randn(3, 20, 60) * 0.1).astype(np.float32))
    lengths = torch.tensor([20, 13, 7])
    got = forward(params, imu, bodies[1], lengths=lengths, backend="fused",
                  pose_index=6)
    want = forward(params, imu, bodies[1], lengths=lengths, backend="auto",
                   pose_index=6)
    for g, w in zip(got[:4] + got[4], want[:4] + want[4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fused_refuses_int8_params(weights, bodies):
    _, params = weights
    qparams = quantize_params_int8(params)
    imu = torch.zeros(2, 45, 60)
    with pytest.raises(ValueError, match="int8"):
        forward(qparams, imu, bodies[1], backend="fused")


@pytest.mark.parametrize("mode", ["scan", "unfolded"])
def test_streaming_fused_is_auto(mode, weights, bodies):
    """Both streaming modes compute under 'fused' exactly what they
    compute under 'auto' (the multicell kernel is `forward`'s alone)."""
    _, params = weights
    net = MobilePoserNet(bodies[1], device="cpu")
    frames = torch.from_numpy(
        (np.random.RandomState(6).randn(3, 2, 60) * 0.1).astype(np.float32))
    outs = {}
    for backend in ("auto", "fused"):
        st = net.init_online_state_batched(2)
        outs[backend] = net.forward_online_sequence_batched(
            params, st, frames, mode=mode, chunk=2, backend=backend)
    (o_a, st_a), (o_f, st_f) = outs["auto"], outs["fused"]
    for g, w in zip(list(o_f) + list(st_f), list(o_a) + list(st_a)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_training_refuses_fused():
    """The trainer takes training backends only; a train step through
    'fused' would need gradients of the inference kernels, which carry
    none."""
    with pytest.raises(ValueError, match="training backend"):
        TrainingManager(backend="fused", device="cpu")
    state = init_train_state("footcontact", torch.Generator().manual_seed(0),
                             1e-3, device="cpu")
    batch = {"imu": torch.zeros(2, 5, 60), "joints": torch.zeros(2, 5, 72),
             "contacts": torch.zeros(2, 5, 2)}
    step = make_train_step("footcontact", backend="fused")
    with pytest.raises(RuntimeError, match="carry no gradient"):
        step(state, batch, torch.Generator().manual_seed(1))


def _bad_inputs(case):
    x, ws, h0s, c0s = _cells(np.random.RandomState(7), 3, 2, (32, 64))
    x, ws, h0s, c0s = torch.from_numpy(x), _t(ws), _t(h0s), _t(c0s)
    hs = (32, 64)
    if case == "dtype":
        x = x.double()
    elif case == "width":
        hs = (32, 32)
    elif case == "contiguous":
        h0s[1] = h0s[1].t().contiguous().t()
    elif case == "device":
        c0s[0] = torch.empty((2, 32), device="meta")
    return x, ws, h0s, c0s, hs


@pytest.mark.parametrize("case, match", [
    ("dtype", "float32"), ("width", "wide"), ("contiguous", "contiguous"),
    ("device", "is on meta")])
def test_multicell_wrapper_rejects(case, match):
    with pytest.raises(ValueError, match=match):
        multicell_lstm(*_bad_inputs(case))
    assert multicell_cuda.launches["multicell_scan_f32"] == 0
    assert set(lstm_cuda.launches.values()) == {0}
