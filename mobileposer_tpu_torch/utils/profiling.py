"""Profiling helpers (counterpart of `mobileposer_tpu/utils/profiling.py`).

A context manager around `torch.profiler` that exports a Chrome trace
(open it in ui.perfetto.dev or chrome://tracing), the CUDA caching
allocator's statistics, and a step timer that waits for the device before
it reads the clock.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace") -> Iterator[None]:
    """Trace the host and, where there is one, the CUDA device:
    `with trace("t"): run_step()` writes `t/trace.json` (a Chrome trace)
    when the block ends."""
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
