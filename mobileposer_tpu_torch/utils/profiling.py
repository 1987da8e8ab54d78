"""Profiling helpers (counterpart of `mobileposer_tpu/utils/profiling.py`).

A context manager around `torch.profiler` that exports a Chrome trace
(open it in ui.perfetto.dev or chrome://tracing), the named spans the
port opens inside its own steps, the CUDA caching allocator's
statistics, and a step timer that waits for the device before it reads
the clock.

Spans (`span(name)`, `record_function` ranges on the profiler's clock,
the one its device activity uses):

  * `mp.decode_ik`          — `models/net.py` `reduced_global_to_full_soa`:
                              the r6d decode and IK, every entry point
  * `mp.fusion`             — `MobilePoserNet._fusion_step`: one frame of
                              the streaming translation fusion
  * `mp.train.forward`      — `make_multi_train_step`'s step: `zero_grad`,
                              the draws and the four losses
  * `mp.train.backward`     — its backward (and, data-parallel, the
                              all-reduce)
  * `mp.train.finite_flags` — `trainer._apply_updates`: the finite flags
                              and their fetch, the step's one wait for
                              the device

torch names each optimizer's step itself (`Optimizer.step#<Class>.step`).
A span opens only while a profiler records (`trace()`, or any
`torch.profiler.profile`); otherwise, and under `torch.compile` or
`torch.export`, `span` returns a shared no-op and costs two flag tests.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function(name)` while a profiler records,
    else a shared no-op context: `with span("mp.fusion"): ...`. An
    ungated `record_function` costs microseconds a call even with no
    profiler running; the gate tests the profiler's own flag. Compiled
    and exported graphs see no span."""
    if torch.compiler.is_compiling() or not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace") -> Iterator[None]:
    """Trace the host and, where there is one, the CUDA device:
    `with trace("t"): run_step()` writes `t/trace.json` (a Chrome trace)
    when the block ends. The trace shows the port's spans (`mp.decode_ik`,
    `mp.fusion`, `mp.train.forward`, `mp.train.backward`,
    `mp.train.finite_flags`, torch's `Optimizer.step#<Class>.step`)
    around the work they launched; without a profiler they cost
    nothing but two flag tests."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The CUDA caching allocator's statistics of `device` (the current
    card when None; `torch.cuda.memory_stats`, bytes and counts), or None
    for a CPU device or when no card is present."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats(device))


def _devices(out) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists and
    dicts."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_devices(o) for o in out)) if out else set()
    return set()


class StepTimer:
    """Rolling per-step wall time that includes the device's work.

    `timer.measure(fn, *args)` synchronizes the device of every tensor in
    fn's output before it reads the clock: work launched on several cards
    (or streams of one) is all finished when the step is counted.
    """

    def __init__(self, window: int = 50):
        self.window = window
        self.samples: list = []

    def measure(self, fn, *args) -> float:
        t0 = time.perf_counter()
        out = fn(*args)
        for dev in _devices(out):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.samples.append(dt)
        self.samples = self.samples[-self.window:]
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.samples)) if self.samples else 0.0
