"""The `stream` traffic: S streams served in a closed loop, one frame per
stream per tick, ticks back to back with one in flight, as `cli.serve`
pipelines `PoseServer.tick`'s step.

Each tick hands the tick's [S, 60] frames (host memory, as they arrive)
to a pinned staging buffer and uploads them, calls
`MobilePoserNet.forward_online_batched`, and issues a non-blocking copy
of pose, joints, root and contact into pinned host memory with an event.
The loop issues tick t + 1 before it waits on tick t's event; a tick's
latency runs from the hand-over of its frames to that event, observed
as soon as the next tick is issued. The state threads from tick to tick.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from portbench import check, motion, weights

OUTPUTS = ("pose", "joints", "root", "contact")


class Ticks:
    """The tick loop over one program step and its state."""

    def __init__(self, step, state, table: np.ndarray, dtype, sample,
                 device):
        self.step, self.state, self.table = step, state, table
        self.dtype, self.sample, self.dev = dtype, sample, device
        self.cuda = device.type == "cuda"
        S = table.shape[1]
        self.stage = [torch.empty((S, table.shape[2]), dtype=torch.float32,
                                  pin_memory=self.cuda) for _ in range(2)]
        self.up = [torch.cuda.Event() if self.cuda else None
                   for _ in range(2)]
        self.out = [None, None]
        self.out_np = [None, None]
        self.copied = [torch.cuda.Event() if self.cuda else None
                       for _ in range(2)]
        self.n = 0
        self.start, self.done, self.issue_ms = [], [], []
        self.rec = {k: [] for k in OUTPUTS}

    def issue(self) -> None:
        """Hand over tick n's frames and issue its step and copy."""
        b = self.n % 2
        frames = self.table[self.n % self.table.shape[0]]
        t0 = time.perf_counter()
        if self.cuda:
            self.up[b].synchronize()    # tick n - 2's upload has left
        self.stage[b].numpy()[:] = frames
        x = self.stage[b].to(self.dev, non_blocking=True)
        if self.cuda:
            self.up[b].record()
        x = x.to(self.dtype)
        t1 = time.perf_counter()
        outs, self.state = self.step(self.state, x)
        t2 = time.perf_counter()
        if self.out[b] is None:
            self.out[b] = [torch.empty(o.shape, dtype=o.dtype,
                                       pin_memory=self.cuda) for o in outs]
            # numpy views of the host buffers (bf16 as its raw 16 bits)
            self.out_np[b] = [(h.view(torch.int16) if h.dtype == torch.bfloat16
                               else h).numpy() for h in self.out[b]]
        for h, o in zip(self.out[b], outs):
            h.copy_(o, non_blocking=self.cuda)
        if self.cuda:
            self.copied[b].record()
        self.start.append(t0)
        self.issue_ms.append(1e3 * (t2 - t1))
        self.n += 1

    def complete(self, t: int) -> None:
        """Wait for tick t's outputs in host memory; keep the sample's."""
        b = t % 2
        if self.cuda:
            self.copied[b].synchronize()
        self.done.append(time.perf_counter())
        for k, h in zip(OUTPUTS, self.out_np[b]):
            self.rec[k].append(h.take(self.sample, axis=0))

    def outputs(self, device) -> dict:
        """The sample's outputs at every tick so far, float32 on `device`."""
        out = {}
        for k, h in zip(OUTPUTS, self.out[0]):
            t = torch.from_numpy(np.stack(self.rec[k]))
            if h.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            out[k] = t.to(device).float()
        return out

    def run(self, n_ticks=None, until=None, span=None) -> None:
        """Issue ticks until `n_ticks` were issued or the clock passed
        `until`, then complete the last. With `span`, each iteration (an
        issue and the completion of the tick before it, the last one's
        own completion with it) runs inside `span()`: one span a tick."""
        first = self.n
        while n_ticks is None or self.n - first < n_ticks:
            if until is not None and time.perf_counter() >= until:
                break
            with span() if span else contextlib.nullcontext():
                self.issue()
                if self.n - 1 > first:
                    self.complete(self.n - 2)
                if n_ticks is not None and self.n - first == n_ticks:
                    self.complete(self.n - 1)
                    return
        if self.n > first:
            self.complete(self.n - 1)


def _program(cfg, dtype, flat, device):
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models.modules import (MODULE_CONFIGS,
                                                      init_all_modules)
    from mobileposer_tpu_torch.models.net import (NUM_PAST, NUM_TOTAL,
                                                  MobilePoserNet)
    w = cfg["window"]
    if (NUM_PAST, NUM_TOTAL) != (w["past"], w["past"] + w["future"]):
        raise ValueError("the program's window is not the configuration's")
    for name, m in cfg["modules"].items():
        if MODULE_CONFIGS[name]._asdict() != m:
            raise ValueError(f"the program's {name} is not the "
                             f"configuration's: {MODULE_CONFIGS[name]}")
    params = init_all_modules(device=device, dtype=dtype)
    weights.load_into(cfg, flat, params)
    net = MobilePoserNet(body_model=ParametricModel(weights.body_arrays(cfg)),
                         online_sigmoid=cfg["online_sigmoid"], device=device)
    return net, params


def run(ctx) -> dict:
    """One run of a stream cell; returns its part of the result."""
    cfg, tr, dev, seed = ctx["cfg"], ctx["traffic"], ctx["device"], ctx["seed"]
    dtype = weights.DTYPES[cfg["dtype"]]
    S = tr["streams"]
    t_start = time.perf_counter()
    flat = weights.make_flat(cfg, seed, dev)
    net, params = _program(cfg, dtype, flat, dev)
    t_program = time.perf_counter()
    table = motion.stream_table(tr, seed, dev).cpu().numpy()
    pick = torch.randperm(S, generator=motion.generator(seed, 5, "cpu"))
    sample = np.sort(pick[:tr["check_streams"]].numpy())

    state = net.init_online_state_batched(S, dtype)
    loop = Ticks(lambda st, x: net.forward_online_batched(params, st, x),
                 state, table, dtype, sample, dev)
    with torch.no_grad():
        loop.run(n_ticks=tr["warmup_ticks"])
        first = loop.n
        t_setup = time.perf_counter()
        trace_rec = None
        if ctx["trace"]:
            trace_rec = ctx["profile"](
                lambda span: loop.run(n_ticks=tr["trace_calls"], span=span))
        loop.run(until=t_setup + ctx["seconds"])
        w0, w1 = loop.start[first], loop.done[-1]
    peak = ctx["memory_peak"]()
    ticks = loop.n - first
    lat = [1e3 * (d - s) for s, d in zip(loop.start[first:],
                                          loop.done[first:])]
    issue_traced = loop.issue_ms[first:first + tr["trace_calls"]]
    prog = loop.outputs(dev)
    del loop, state, params, net
    ctx["free"]()

    frames = torch.from_numpy(table[np.arange(len(prog["root"]))
                                    % table.shape[0]][:, sample])
    frames = frames.to(dev).to(dtype).float()
    t_check = time.perf_counter()
    readings = check.stream(cfg, flat, frames, prog)
    t_done = time.perf_counter()
    out = {
        "setup_s": t_setup - ctx["t0"],
        "attempted": ticks, "failed": 0,
        "memory_peak_bytes": peak,
        "end_to_end": {"frames_per_s": S * ticks / (w1 - w0),
                       "tick_ms_p95": statistics.quantiles(lat, n=20)[-1]},
        "readings": readings,
        "diag": {"to_start": t_start - ctx["t0"],
                    "weights_program": t_program - t_start,
                    "inputs_warmup": t_setup - t_program,
                    "window": w1 - w0, "check": t_done - t_check,
                    "ticks_checked": len(frames),
                    "tick_ms_p50": statistics.median(lat)},
    }
    if trace_rec is not None:
        out["trace"] = {"kind": "stream", "cfg": cfg, "traffic": tr,
                        "frames_per_call": S, "trace": trace_rec,
                        "issue_ms": issue_traced}
    return out
