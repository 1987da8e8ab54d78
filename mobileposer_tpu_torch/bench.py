"""Exact-path streamed IMU frames/s and offline-evaluation frames/s of the
port on one CUDA device.

`run` times `MobilePoserNet.forward_online_sequence_batched` (exact
45-frame window semantics) on S streams x N frames; `run_offline` times
`evaluation.forward_offline_batched` on one ragged evaluation group (B
sequences padded to a 512-frame bucket, every LSTM layer on the masked
kernels). Both use CUDA events and keep the honesty rules of the JAX
package's root `bench.py`:

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

`breakdown` and `breakdown_offline` are the traced runs: one call under
`torch.profiler`, with the device time summed by kernel group and the
device's busy share of the wall time. The rates come from `run` and
`run_offline`, with tracing off.

Random weights from a seed (the JAX bench uses random weights too).
Run:  python -m mobileposer_tpu_torch.bench [--streams 256] [--frames 100]
      python -m mobileposer_tpu_torch.bench --offline
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
from mobileposer_tpu_torch.evaluation.pose_eval import forward_offline_batched
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


def model_flops_per_frame() -> float:
    """Matmul FLOPs for one timestep of one stream through the four
    modules."""
    return sum(rnn_block_flops_per_frame(cfg)
               for cfg in MODULE_CONFIGS.values())


def _net(seed: int, device):
    """Net and random weights on the CUDA device, TF32 off."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the bench times a CUDA device; a CPU run is not "
                           "a measurement of the port")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = MobilePoserNet(device=device)
    params = init_all_modules(torch.Generator().manual_seed(seed),
                              device=device)
    return device, net, params


def _setup(n_streams: int, n_frames: int, mode: str, seed: int, device):
    """Net, random weights, fresh state and frames on the CUDA device."""
    device, net, params = _net(seed, device)
    state0 = net.init_online_state_batched(n_streams)
    rng = np.random.RandomState(seed)
    frames = torch.from_numpy(
        rng.randn(n_frames, n_streams, 60).astype(np.float32) * 0.1
    ).to(device)
    if mode == "auto":
        mode = ("unfolded" if n_streams < MobilePoserNet.UNFOLD_MAX_STREAMS
                else "scan")
    return device, net, params, state0, frames, mode


def _chained_rates(call, state0, per_call: int, reps: int, trials: int,
                   device):
    """Time `trials` chained regions of `reps` calls with CUDA events,
    after a warm-up call and one timed single call. `call(state)` returns
    (outputs, next state); every output is folded into one checksum,
    fetched after the end event, so no output can be skipped.
    Returns (rates in frames/s, seconds of the single call, checksum)."""
    def chained(R: int):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        st = state0
        total = torch.zeros((), device=device)
        start.record()
        for _ in range(R):
            outputs, st = call(st)
            total = total + sum(o.sum() for o in outputs)
        end.record()
        checksum = total.item()   # waits for the device
        return start.elapsed_time(end) / 1e3, checksum

    chained(1)                                      # warm-up
    t_single, _ = chained(1)
    rates = []
    for _ in range(trials):
        t_chain, checksum = chained(reps)
        if not math.isfinite(checksum):
            raise RuntimeError(f"non-finite output checksum {checksum}")
        rates.append(per_call * reps / t_chain)
    return rates, t_single, checksum


def run(n_streams: int = 256, n_frames: int = 100, mode: str = "auto",
        reps: int = 3, trials: int = 5, seed: int = 0, device=None) -> dict:
    """Measure exact-path streamed frames/s; returns the JSON record.

    `trials` chained regions of `reps` calls each are timed; the record's
    value is their median rate, with the lowest and highest beside it."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device)
    per_call = n_streams * n_frames
    rates, t_single, checksum = _chained_rates(
        lambda st: net.forward_online_sequence_batched(params, st, frames,
                                                       mode=mode),
        state0, per_call, reps, trials, device)
    fps = float(np.median(rates))
    # one emitted streaming frame re-runs the full window through all four
    # modules (reference semantics, net.py:174-178)
    flops = NUM_TOTAL * model_flops_per_frame()
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


def _offline_setup(batch: int, bucket: int, seed: int, device):
    """Net, random weights and one ragged evaluation group on the card:
    imu [batch, bucket, 60] with lengths drawn from the seed in
    [bucket/2 + 1, bucket], each row padded with its last valid frame as
    the evaluation pads it."""
    device, net, params = _net(seed, device)
    rng = np.random.RandomState(seed)
    lengths = rng.randint(bucket // 2 + 1, bucket + 1, size=batch)
    imu = rng.randn(batch, bucket, 60).astype(np.float32) * 0.1
    for b, n in enumerate(lengths):
        imu[b, n:] = imu[b, n - 1]
    return (device, net, params, torch.from_numpy(imu).to(device),
            torch.from_numpy(lengths).to(device), int(lengths.sum()))


def run_offline(batch: int = 64, bucket: int = 512, seed: int = 0,
                reps: int = 3, trials: int = 5, device=None) -> dict:
    """Measure offline-evaluation valid frames/s of
    `forward_offline_batched` over one ragged group; returns the JSON
    record. Same chained timing as `run`: `trials` regions of `reps` calls,
    all four outputs folded into the checksum; the record's value is the
    median rate."""
    device, net, params, imu, lengths, n_valid = _offline_setup(
        batch, bucket, seed, device)
    rates, t_single, checksum = _chained_rates(
        lambda st: (forward_offline_batched(net, params, imu, lengths), st),
        None, n_valid, reps, trials, device)
    fps = float(np.median(rates))
    padded_fps = fps * batch * bucket / n_valid
    # each padded frame goes once through the four modules (the masked
    # kernels step through the padding too)
    flops = model_flops_per_frame()
    return {
        "metric": "offline_eval_valid_frames_per_sec",
        "value": fps,
        "unit": "frames/s",
        "batch": batch,
        "bucket": bucket,
        "valid_frames": n_valid,
        "padded_frames_per_sec": padded_fps,
        "seconds_per_group": batch * bucket / padded_fps,
        "reps": reps,
        "trials": trials,
        "rate_min": min(rates),
        "rate_max": max(rates),
        "seconds_single": t_single,
        "chained_per_run_ratio": (n_valid / t_single) / fps,
        "model_flops_per_padded_frame": flops,
        "model_flops_per_sec": padded_fps * flops,
        "pct_of_f32_peak": 100.0 * padded_fps * flops / F32_PEAK_FLOPS,
        "checksum": checksum,
        "device_kind": torch.cuda.get_device_name(device),
    }


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "lstm_scan_masked_kernel" in low:
        return "lstm_scan masked (ops/csrc/lstm_scan.cu)"
    if "lstm_scan_kernel" in low:
        return "lstm_scan (ops/csrc/lstm_scan.cu)"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul (cuBLAS: projections, linears)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, cat/flip, IK, fusion)"


def breakdown(n_streams: int = 256, n_frames: int = 100, mode: str = "auto",
              seed: int = 0, device=None) -> dict:
    """One streaming call under `torch.profiler`: device time by kernel
    group, the device's busy share of the call's wall time (profiler on),
    the longest kernels by name, and the host operations with the most
    self time (what keeps the host from running ahead of the device)."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device)
    rec = _traced(lambda: net.forward_online_sequence_batched(
        params, state0, frames, mode=mode), device)
    return {"streams": n_streams, "frames": n_frames, "mode": mode, **rec}


def breakdown_offline(batch: int = 64, bucket: int = 512, seed: int = 0,
                      device=None) -> dict:
    """One `forward_offline_batched` call over the `run_offline` group
    under `torch.profiler`, reported as `breakdown` reports."""
    device, net, params, imu, lengths, n_valid = _offline_setup(
        batch, bucket, seed, device)
    rec = _traced(lambda: forward_offline_batched(net, params, imu, lengths),
                  device)
    return {"batch": batch, "bucket": bucket, "valid_frames": n_valid, **rec}


def _traced(call, device) -> dict:
    """Warm `call` up, then run it once under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    groups: dict = {}
    kernels, host = [], []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append((ev.self_cpu_time_total / 1e6, ev.count, ev.key[:60]))
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
        "wall_seconds": wall, "device_busy_seconds": busy,
        "device_busy_share": busy / wall,
        "groups": groups,
        "top_kernels": [{"name": n, "seconds": s, "launches": c}
                        for s, c, n in sorted(kernels, reverse=True)[:6]],
        "host_seconds": sum(s for s, _, _ in host),
        "top_host_ops": [{"name": n, "self_seconds": s, "calls": c}
                         for s, c, n in sorted(host, reverse=True)[:8]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--offline", action="store_true",
                    help="time one ragged 64 x 512 offline-evaluation "
                         "group instead")
    args = ap.parse_args()
    print(json.dumps(run_offline() if args.offline
                     else run(args.streams, args.frames)))


if __name__ == "__main__":
    main()
