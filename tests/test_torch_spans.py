"""The port's spans (`utils.profiling.span`): none entered without a
profiler, each emitted as often as its step runs under one, the same
outputs either way, and none under `torch.compile` / `torch.export`."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models.modules import init_all_modules
from mobileposer_tpu_torch.models.net import MobilePoserNet
from mobileposer_tpu_torch.train import trainer
from mobileposer_tpu_torch.utils import profiling

TRAIN_SPANS = ("mp.train.forward", "mp.train.backward",
               "mp.train.finite_flags")
TICKS, STEPS = 3, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops beside other test processes: one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def body():
    return ParametricModel.synthetic(num_vertices=240)


def _ticks(body):
    """TICKS ticks of `forward_online_batched` at S = 2: the outputs."""
    params = init_all_modules(torch.Generator().manual_seed(0), "cpu")
    net = MobilePoserNet(body_model=body, device="cpu")
    state = net.init_online_state_batched(2)
    frames = torch.randn(TICKS, 2, 60,
                         generator=torch.Generator().manual_seed(1)) * 0.3
    outs = []
    with torch.no_grad():
        for t in range(TICKS):
            out, state = net.forward_online_batched(params, state, frames[t])
            outs += list(out)
    return outs


def _steps(body, dtype):
    """STEPS steps of `make_multi_train_step` at B = 2, T = 6: the losses
    and the updated parameters."""
    params = init_all_modules(torch.Generator().manual_seed(0), "cpu",
                              dtype=dtype)
    states = {n: trainer.TrainState(
        params[n].requires_grad_(True),
        trainer.make_optimizer(n, 1e-3, params[n]))
        for n in trainer.MODULE_NAMES}
    rng = np.random.RandomState(2)
    f32 = np.float32
    batch = trainer.to_device(
        {"imu": (rng.randn(2, 6, 60) * 0.3).astype(f32),
         "joints": (rng.randn(2, 6, 72) * 0.3).astype(f32),
         "pose_r6d": rng.randn(2, 6, 24, 6).astype(f32),
         "vels": rng.randn(2, 6, 72).astype(f32),
         "contacts": (rng.rand(2, 6, 2) > 0.5).astype(f32),
         "lengths": np.asarray([6, 4], np.int32)}, "cpu")
    step = trainer.make_multi_train_step(body)
    losses = []
    for i in range(STEPS):
        states, lo = step(states, batch,
                          torch.Generator().manual_seed(10 + i))
        losses += [lo[n] for n in trainer.MODULE_NAMES]
    return losses + [p.detach().clone() for n in trainer.MODULE_NAMES
                     for p in states[n].params.parameters()]


def _profiled(fn):
    """fn() under a CPU profiler: (its result, the count of each event
    name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, collections.Counter(ev.name for ev in prof.events())


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture
def entered(monkeypatch):
    """The names every `record_function` entered, whichever module the
    caller found it in."""
    names = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            names.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    return names


def test_no_span_without_a_profiler(body, entered):
    _ticks(body)
    _steps(body, torch.float32)
    _steps(body, torch.bfloat16)
    # torch's own optimizer ranges are entered, the port's spans are not
    assert entered
    assert not [n for n in entered if n.startswith("mp.")], set(entered)
    assert profiling.span("mp.fusion") is profiling._NO_SPAN


def test_stream_spans_once_a_tick_and_the_same_outputs(body):
    outs, names = _profiled(lambda: _ticks(body))
    assert names["mp.decode_ik"] == TICKS
    assert names["mp.fusion"] == TICKS
    _same(outs, _ticks(body))


@pytest.mark.parametrize("dtype,optimizers", [
    (torch.float32, {"Adam": 3, "AdamW": 1}),
    (torch.bfloat16, {"OptaxAdam": 4})])
def test_train_spans_once_a_step_and_the_same_updates(body, dtype,
                                                      optimizers):
    outs, names = _profiled(lambda: _steps(body, dtype))
    for n in TRAIN_SPANS:
        assert names[n] == STEPS, n
    got = {k.split("#")[1].split(".")[0]: v for k, v in names.items()
           if k.startswith("Optimizer.step#")}
    assert got == {k: v * STEPS for k, v in optimizers.items()}
    _same(outs, _steps(body, dtype))


def test_no_span_while_compiling(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("mp.fusion") is not profiling._NO_SPAN
        monkeypatch.setattr(torch.compiler, "_is_compiling_flag", True)
        assert torch.compiler.is_compiling()
        assert profiling.span("mp.fusion") is profiling._NO_SPAN
