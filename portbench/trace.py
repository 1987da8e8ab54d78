"""The traced run's record and what the per-layer readers share.

A traced run profiles its first `trace_calls` calls of the window with
`torch.profiler` (CPU and CUDA activity). `record` turns the profile
into plain data: every device operation (kernels, copies, sets) and
every host operation as (name, start_us, end_us) on the profiler's one
clock, and the benchmark's own call spans (`portbench.call`), which
bound the traced window. Readers take the record and return a number,
or None when they find nothing to read.
"""

from __future__ import annotations

import numpy as np

CALL_SPAN = "portbench.call"


def record(prof) -> dict:
    """Device and host operations of a finished `torch.profiler.profile`."""
    import torch
    device, host, calls = [], [], []
    events = prof.events()
    # record_function ranges (the benchmark's spans, the optimizers' own)
    # are mirrored on the device's timeline; they are no device work
    spans = {ev.name for ev in events
             if getattr(ev, "is_user_annotation", False)} | {CALL_SPAN}
    for ev in events:
        item = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name not in spans:
                device.append(item)
        elif ev.name == CALL_SPAN:
            calls.append(item[1:])
        else:
            host.append(item)
    device.sort(key=lambda x: x[1])
    calls.sort()
    return {"device_ops": device, "host_ops": host, "calls": calls}


def window_us(rec: dict):
    """(start, end) of the traced window: from the first call's start to
    the later of the last call's end and the last device operation's end."""
    calls = rec["calls"]
    if not calls:
        return None
    end = max([c[1] for c in calls] + [d[2] for d in rec["device_ops"]])
    return calls[0][0], end


def busy_us(rec: dict) -> float:
    """Microseconds in which at least one device operation ran, inside
    the window: the union of their intervals (overlaps counted once)."""
    win = window_us(rec)
    if win is None:
        return 0.0
    iv = sorted((max(s, win[0]), min(e, win[1]))
                for _, s, e in rec["device_ops"])
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def op_us(rec: dict, names) -> float:
    """Summed device time of the operations whose name `names` accepts."""
    return sum(e - s for n, s, e in rec["device_ops"] if names(n))


def per_call(rec: dict, kind: str, count: float):
    """`count` per traced call of a `kind` cell, or None."""
    calls = len(rec["trace"]["calls"])
    if rec["kind"] != kind or not calls or not count:
        return None
    return count / calls


def ns_per_frame(rec: dict, kind: str, names):
    """Device ns per frame of the traced window spent in the operations
    whose name `names` accepts, for a `kind` cell, or None."""
    frames = rec["frames_per_call"] * len(rec["trace"]["calls"])
    us = op_us(rec["trace"], names)
    if rec["kind"] != kind or us <= 0 or not frames:
        return None
    return 1e3 * us / frames


def idle_share(rec: dict, kind: str):
    """% of the traced window of a `kind` cell in which no device
    operation ran, or None."""
    win = window_us(rec["trace"])
    busy = busy_us(rec["trace"])
    if rec["kind"] != kind or win is None or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (win[1] - win[0]))


def mfu(rec: dict, kind: str, mult: float):
    """% of the configuration's peak: the model's matmul FLOPs per frame
    x `mult` x the traced window's frames over its seconds, or None."""
    from portbench import roofline
    win = window_us(rec["trace"])
    calls = len(rec["trace"]["calls"])
    if rec["kind"] != kind or win is None or not calls:
        return None
    cfg = rec["cfg"]
    flops = (roofline.model_flops_per_frame(cfg) * mult
             * rec["frames_per_call"] * calls)
    return 100.0 * flops / ((win[1] - win[0]) / 1e6) / cfg["peak_flops"]


def is_matmul(name: str) -> bool:
    """cuBLAS's products (Hopper's bf16 ones are named nvjet_*)."""
    low = name.lower()
    return ("gemm" in low or "cutlass" in low or "xmma" in low
            or low.startswith("nvjet"))


def is_scan(name: str) -> bool:
    """Kernels #1 and #2 (every dtype entry)."""
    return "lstm_scan_kernel" in name


def is_train_fwd(name: str) -> bool:
    return "lstm_train_fwd_kernel" in name


def is_train_bwd(name: str) -> bool:
    """Kernel #8: the backward scan and its dW reduction."""
    return "lstm_train_bwd_kernel" in name or "lstm_train_dw_kernel" in name


def is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def is_other(name: str) -> bool:
    """Every device operation that is no LSTM kernel, product or copy:
    elementwise glue, IK, fusion, losses, optimizers."""
    return not (is_matmul(name) or is_copy(name) or "lstm_" in name
                or "multicell_scan" in name)


def group(name: str) -> str:
    """The breakdown's name of a device operation."""
    for pred, label in ((is_scan, "lstm_scan (#1, #2)"),
                        (is_train_fwd, "lstm_train_fwd (#7)"),
                        (is_train_bwd, "lstm_train_bwd + dw (#8)"),
                        (is_matmul, "matmul (cuBLAS)"), (is_copy, "copies")):
        if pred(name):
            return label
    return name[:80]


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time (by group) and the
    longest idle gaps, summed by the innermost host operation running at
    each gap's middle, in seconds."""
    by = {}
    for n, s, e in rec["device_ops"]:
        by[group(n)] = by.get(group(n), 0.0) + (e - s) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    win = window_us(rec)
    gaps = []
    if win is not None:
        cur = win[0]
        for _, s, e in rec["device_ops"]:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if win[1] > cur:
            gaps.append((cur, win[1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    labels = {}
    if gaps and rec["host_ops"]:
        names = [h[0] for h in rec["host_ops"]]
        st = np.array([h[1] for h in rec["host_ops"]])
        en = np.array([h[2] for h in rec["host_ops"]])
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.nonzero((st <= mid) & (en >= mid))[0]
            lab = ("(no host operation)" if inside.size == 0 else
                   names[inside[np.argmin(en[inside] - st[inside])]][:80])
            labels[lab] = labels.get(lab, 0.0) + (b - a) / 1e6
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
