"""Exact-path streamed IMU frames/s of the port on one CUDA device.

Times `MobilePoserNet.forward_online_sequence_batched` (exact 45-frame
window semantics) on S streams x N frames with CUDA events, keeping the
honesty rules of the JAX package's root `bench.py`:

  * the timed result folds all four outputs (pose, joints, translation,
    contact) into one checksum, fetched after the end event, so no
    output's work can be skipped;
  * a warm-up call first (kernel build, cuBLAS handles, allocator);
  * a chained repetition: R calls with the state threaded from each to
    the next, timed as one region, `trials` times; one unchained call is
    timed too and `chained_per_run_ratio` (single-call rate / chained
    rate) must stay near 1;
  * an analytic matmul-FLOP count (a copy of the formula in
    benchmarks/flops.py) turns the rate into FLOP/s and a share of the
    card's float32 peak, so an impossible number flags the harness.

`breakdown` is the traced run: one call under `torch.profiler`, with the
device time summed by kernel group and the device's busy share of the
wall time. The rate comes from `run`, with tracing off.

Random weights from a seed (the JAX bench uses random weights too).
Run:  python -m mobileposer_tpu_torch.bench [--streams 256] [--frames 100]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS, init_all_modules
from mobileposer_tpu_torch.models.net import NUM_TOTAL, MobilePoserNet

#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet, at
#: the 700 W limit). The port runs float32 with TF32 off, so its matmuls
#: and kernels are held to this rate.
F32_PEAK_FLOPS = 67e12


def rnn_block_flops_per_frame(cfg) -> float:
    """Matmul FLOPs for one timestep of one stream through one RNN block:
    linear1 -> n_layers x (bi)LSTM -> linear2."""
    n_dir = 2 if cfg.bidirectional else 1
    f = 2.0 * cfg.n_input * cfg.n_hidden                      # linear1
    for layer in range(cfg.n_layers):
        n_in = cfg.n_hidden if layer == 0 else cfg.n_hidden * n_dir
        per_dir = 2.0 * (n_in * 4 * cfg.n_hidden              # x @ w_ih
                         + cfg.n_hidden * 4 * cfg.n_hidden)   # h @ w_hh
        f += n_dir * per_dir
    f += 2.0 * cfg.n_hidden * n_dir * cfg.n_output            # linear2
    return f


def streaming_flops_per_emitted_frame(window: int = NUM_TOTAL) -> float:
    """One emitted streaming frame re-runs the full `window` through all
    four modules (reference semantics, net.py:174-178)."""
    return window * sum(rnn_block_flops_per_frame(cfg)
                        for cfg in MODULE_CONFIGS.values())


def _setup(n_streams: int, n_frames: int, mode: str, seed: int, device):
    """Net, random weights, fresh state and frames on the CUDA device."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the bench times a CUDA device; a CPU run is not "
                           "a measurement of the port")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = MobilePoserNet(device=device)
    params = init_all_modules(torch.Generator().manual_seed(seed),
                              device=device)
    state0 = net.init_online_state_batched(n_streams)
    rng = np.random.RandomState(seed)
    frames = torch.from_numpy(
        rng.randn(n_frames, n_streams, 60).astype(np.float32) * 0.1
    ).to(device)
    if mode == "auto":
        mode = ("unfolded" if n_streams < MobilePoserNet.UNFOLD_MAX_STREAMS
                else "scan")
    return device, net, params, state0, frames, mode


def run(n_streams: int = 256, n_frames: int = 100, mode: str = "auto",
        reps: int = 3, trials: int = 5, seed: int = 0, device=None) -> dict:
    """Measure exact-path streamed frames/s; returns the JSON record.

    `trials` chained regions of `reps` calls each are timed; the record's
    value is their median rate, with the lowest and highest beside it."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device)

    def chained(R: int):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        st = state0
        total = torch.zeros((), device=device)
        start.record()
        for _ in range(R):
            (pose, joints, root, contact), st = \
                net.forward_online_sequence_batched(params, st, frames,
                                                    mode=mode)
            total = total + (pose.sum() + joints.sum() + root.sum()
                             + contact.sum())
        end.record()
        checksum = total.item()   # waits for the device
        return start.elapsed_time(end) / 1e3, checksum

    chained(1)                                      # warm-up
    t_single, _ = chained(1)
    per_call = n_streams * n_frames
    rates = []
    for _ in range(trials):
        t_chain, checksum = chained(reps)
        if not math.isfinite(checksum):
            raise RuntimeError(f"non-finite output checksum {checksum}")
        rates.append(per_call * reps / t_chain)
    fps = float(np.median(rates))
    flops = streaming_flops_per_emitted_frame()
    return {
        "metric": "exact_streamed_frames_per_sec",
        "value": fps,
        "unit": "frames/s",
        "streams": n_streams,
        "frames": n_frames,
        "mode": mode,
        "reps": reps,
        "trials": trials,
        "rate_min": min(rates),
        "rate_max": max(rates),
        "seconds_single": t_single,
        "chained_per_run_ratio": (per_call / t_single) / fps,
        "model_flops_per_frame": flops,
        "model_flops_per_sec": fps * flops,
        "pct_of_f32_peak": 100.0 * fps * flops / F32_PEAK_FLOPS,
        "checksum": checksum,
        "device_kind": torch.cuda.get_device_name(device),
    }


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "lstm_scan_kernel" in low:
        return "lstm_scan (ops/csrc/lstm_scan.cu)"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul (cuBLAS: projections, linears)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, cat/flip, IK, fusion)"


def breakdown(n_streams: int = 256, n_frames: int = 100, mode: str = "auto",
              seed: int = 0, device=None) -> dict:
    """One call under `torch.profiler`: device time by kernel group, the
    device's busy share of the call's wall time (profiler on), and the
    longest kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device)
    net.forward_online_sequence_batched(params, state0, frames, mode=mode)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.forward_online_sequence_batched(params, state0, frames, mode=mode)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    groups: dict = {}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        sec = ev.self_device_time_total / 1e6
        g = groups.setdefault(_kernel_group(ev.key), {"seconds": 0.0,
                                                      "launches": 0})
        g["seconds"] += sec
        g["launches"] += ev.count
        kernels.append((sec, ev.count, ev.key[:90]))
    busy = sum(g["seconds"] for g in groups.values())
    for g in groups.values():
        g["share_of_busy"] = g["seconds"] / busy if busy else 0.0
    return {
        "streams": n_streams, "frames": n_frames, "mode": mode,
        "wall_seconds": wall, "device_busy_seconds": busy,
        "device_busy_share": busy / wall,
        "groups": groups,
        "top_kernels": [{"name": n, "seconds": s, "launches": c}
                        for s, c, n in sorted(kernels, reverse=True)[:6]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args()
    print(json.dumps(run(args.streams, args.frames)))


if __name__ == "__main__":
    main()
