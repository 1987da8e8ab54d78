"""What the port's own spans say in a traced run's record.

The port opens `record_function` spans inside its steps
(`mobileposer_tpu_torch.utils.profiling.span`: `mp.decode_ik`,
`mp.fusion`, `mp.train.forward`, `mp.train.backward`,
`mp.train.finite_flags`), and torch names each optimizer's step
(`Optimizer.step#<Class>.step`). In the record (`trace.record`) they are
host operations on the profiler's one clock. A program that opens none
gives readers nothing to read, and they return None.

Pairing: the benchmark runs on one CUDA stream, so the card runs its
operations in the order they were enqueued. The n-th launch-type host
operation of the trace (a CUDA API call that enqueues a kernel or a
copy, `LAUNCH`) is taken to have enqueued the n-th kernel or copy
by start. Sets are left out on both sides: cuBLAS calls
`cudaMemsetAsync` inside a product's launch with nothing to set, which
enqueues no device operation (two a train step on the H100). Each device
operation is credited to the innermost span open at its launch, by time
and not by thread: the backward launches from autograd's thread while
the main thread sits in `mp.train.backward`. Where the two counts differ
the pairing is unknown, and the readers that need it return None.
"""

from __future__ import annotations

import bisect
import re
import statistics

from portbench import trace as T

SPAN_PREFIX = "mp."
OPTIMIZER_PREFIX = "Optimizer.step#"
# the CUDA API calls (`cuda*`, `cu*`) that enqueue one kernel or copy
# each (CUPTI may name a call with its API version, `..._v11060`)
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel"
                    r"|cuLaunchKernelEx|cudaMemcpyAsync)(_v\d+)?$")


def named(name: str):
    """A test that accepts the span `name` alone."""
    return lambda n: n == name


def is_optimizer(name: str) -> bool:
    """torch's range around an optimizer's step, any optimizer class."""
    return name.startswith(OPTIMIZER_PREFIX)


def is_span(name: str) -> bool:
    return name.startswith(SPAN_PREFIX) or is_optimizer(name)


def intervals(rec: dict, names) -> list:
    """(start_us, end_us) of every host operation whose name `names`
    accepts, by start."""
    return sorted((s, e) for n, s, e in rec["host_ops"] if names(n))


def paired_ops(rec: dict) -> list:
    """The device operations that pair with `LAUNCH` calls: every kernel
    and copy, by start."""
    return [d for d in rec["device_ops"]
            if not d[0].lower().startswith("memset")]


def owners(rec: dict):
    """(launch time, name of the innermost span open then, None where no
    span was) for each of `paired_ops(rec)`; None when the launches and
    those operations do not pair one to one."""
    launches = sorted(s for n, s, _ in rec["host_ops"] if LAUNCH.match(n))
    if len(launches) != len(paired_ops(rec)):
        return None
    own = [None] * len(launches)
    # outer spans first, so that the spans inside them overwrite them
    for n, s, e in sorted((h for h in rec["host_ops"] if is_span(h[0])),
                          key=lambda h: (h[1], -h[2])):
        lo = bisect.bisect_left(launches, s)
        hi = bisect.bisect_right(launches, e)
        own[lo:hi] = [n] * (hi - lo)
    return list(zip(launches, own))


def _by_call(rec: dict, items: list) -> list:
    """(start, ...) items grouped by traced call: an item belongs to the
    call its start falls in."""
    calls = rec["calls"]
    starts = [c[0] for c in calls]
    out = [[] for _ in calls]
    for item in items:
        i = bisect.bisect_right(starts, item[0]) - 1
        if i >= 0 and item[0] <= calls[i][1]:
            out[i].append(item)
    return out


def host_ms(rec: dict, kind: str, names):
    """Host ms inside the spans `names` accepts, summed per traced call
    of a `kind` cell: the median over the calls, or None."""
    tr = rec["trace"]
    spans = intervals(tr, names)
    if rec["kind"] != kind or not tr["calls"] or not spans:
        return None
    return statistics.median(sum(e - s for s, e in c) / 1e3
                             for c in _by_call(tr, spans))


def idle_ms(rec: dict, kind: str, names):
    """Ms per traced call of a `kind` cell in which the host was inside a
    span `names` accepts and the device ran nothing: the spans' host time
    less the device time of the operations launched inside them (the
    median over the calls), or None. Sound where the device has drained
    when the spans open, as after the train step's finite-flag sync:
    then only their own launches run while they issue. It sets no device
    time against a host time, so it holds where the profiler's device
    timestamps drift from its host clock (milliseconds over a traced
    window, seen on the H100)."""
    tr = rec["trace"]
    spans = intervals(tr, names)
    ops = _credited(rec, kind, names)
    if not spans or ops is None:
        return None

    def busy_us(launched):
        # the union of their intervals: `trace.busy_us` over a window
        # from the first one's start, which holds them all
        o = [op for _, op in launched]
        return T.busy_us({"device_ops": o, "calls": [(o[0][1], o[0][1])]}
                         ) if o else 0.0
    return statistics.median(
        max(0.0, sum(e - s for s, e in c) - busy_us(o)) / 1e3
        for c, o in zip(_by_call(tr, spans), _by_call(tr, ops)))


def _credited(rec: dict, kind: str, names):
    """(its launch's host time, device operation) of every operation of a
    `kind` cell launched inside a span `names` accepts, by launch, or
    None (another kind, no call, no pairing)."""
    tr = rec["trace"]
    if rec["kind"] != kind or not tr["calls"]:
        return None
    own = owners(tr)
    if own is None:
        return None
    return [(t, d) for d, (t, o) in zip(paired_ops(tr), own)
            if o is not None and names(o)]


def ns_per_frame(rec: dict, kind: str, names):
    """Device ns per frame of the traced window of a `kind` cell spent in
    the operations launched inside a span `names` accepts, or None."""
    ops = _credited(rec, kind, names)
    frames = rec["frames_per_call"] * len(rec["trace"]["calls"])
    us = sum(e - s for _, (_, s, e) in ops or ())
    if us <= 0 or not frames:
        return None
    return 1e3 * us / frames


def launches_per_call(rec: dict, kind: str, names):
    """Device operations per traced call of a `kind` cell launched inside
    a span `names` accepts, or None."""
    ops = _credited(rec, kind, names)
    return T.per_call(rec, kind, len(ops)) if ops else None
