"""Exact-path streamed IMU frames/s, offline-evaluation frames/s,
training frames/s and single-window forwards/s of the port on one CUDA
device.

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

`run(..., int8=True)` times the same streaming call on W8A8-quantized
params (`ops.quant.quantize_params_int8`: int8 input projections and the
int8 kernels #4 and #6), the counterpart of the JAX bench's `exact_int8`
leg. The JAX bench quantizes bf16 params; the port has no bf16, so it
quantizes the float32 params, and the record says so.

`run_train` times the concurrent four-module train step
(`train.make_multi_train_step`: every LSTM layer on the training kernels
#7 and #8, the four optimizers) on one batch of `TrainHypers.batch_size`
full-length windows, the same chained way with the losses folded into the
checksum; its rate is training frames/s, B x T valid frames per step over
the step time.

`run_forward` times one single-window `models.net.forward` (B windows of
T frames, pose at every frame, the velocity carry threaded from call to
call) with `backend='fused'` (the trio on the multicell kernel) or
'auto' (every module on the layer kernels), in windows/s and ms per
forward, the same chained way with all four outputs in the checksum.

`breakdown`, `breakdown_offline`, `breakdown_train` and
`breakdown_forward` are the traced runs: one call under
`torch.profiler`, with the device time summed by kernel group and the
device's busy share of the wall time. The rates come from `run`,
`run_offline`, `run_train` and `run_forward`, with tracing off.

Random weights from a seed (the JAX bench uses random weights too).
Run:  python -m mobileposer_tpu_torch.bench [--streams 256] [--frames 100]
      python -m mobileposer_tpu_torch.bench --int8 [--streams 256]
      python -m mobileposer_tpu_torch.bench --offline
      python -m mobileposer_tpu_torch.bench --train
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.evaluation.pose_eval import forward_offline_batched
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS, init_all_modules
from mobileposer_tpu_torch.models.net import (NUM_TOTAL, MobilePoserNet,
                                              forward)
from mobileposer_tpu_torch.ops import lstm_train_cuda
from mobileposer_tpu_torch.ops.quant import quantize_params_int8
from mobileposer_tpu_torch.train.trainer import (MODULE_NAMES,
                                                 init_train_state,
                                                 make_multi_train_step,
                                                 to_device)

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


def _setup(n_streams: int, n_frames: int, mode: str, seed: int, device,
           int8: bool = False):
    """Net, random weights (W8A8-quantized with `int8`), fresh state and
    frames on the CUDA device."""
    device, net, params = _net(seed, device)
    if int8:
        params = quantize_params_int8(params)
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
        reps: int = 3, trials: int = 5, seed: int = 0, device=None,
        int8: bool = False) -> dict:
    """Measure exact-path streamed frames/s; returns the JSON record.

    `trials` chained regions of `reps` calls each are timed; the record's
    value is their median rate, with the lowest and highest beside it.
    `int8` runs on W8A8-quantized params."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device, int8)
    per_call = n_streams * n_frames
    rates, t_single, checksum = _chained_rates(
        lambda st: net.forward_online_sequence_batched(params, st, frames,
                                                       mode=mode),
        state0, per_call, reps, trials, device)
    fps = float(np.median(rates))
    # one emitted streaming frame re-runs the full window through all four
    # modules (reference semantics, net.py:174-178)
    flops = NUM_TOTAL * model_flops_per_frame()
    int8_fields = {"int8": int8}
    if int8:
        int8_fields["int8_quantized_from"] = (
            "float32 params (the JAX bench's exact_int8 leg quantizes its "
            "bf16 params; the port has no bf16)")
    return {
        "metric": ("exact_int8_streamed_frames_per_sec" if int8
                   else "exact_streamed_frames_per_sec"),
        "value": fps,
        **int8_fields,
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


def _train_setup(batch: int, window: int, seed: int, device):
    """Four fresh train states, the concurrent step, one full-length batch
    on the card (numpy draws from the seed: IMU, joint, pose and velocity
    targets, contacts) and the draws' generator."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the bench times a CUDA device; a CPU run is not "
                           "a measurement of the port")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = torch.Generator().manual_seed(seed)
    states = {n: init_train_state(n, init, C.train_hypers.lr, device)
              for n in MODULE_NAMES}
    step = make_multi_train_step(ParametricModel.synthetic())
    rng = np.random.RandomState(seed)
    B, W = batch, window

    def f32(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    batch_np = {"imu": f32(B, W, 60, scale=0.3), "joints": f32(B, W, 72),
                "pose_r6d": f32(B, W, 24, 6), "vels": f32(B, W, 72),
                "tran": f32(B, W, 3),
                "contacts": (rng.rand(B, W, 2) > 0.5).astype(np.float32),
                "lengths": np.full((B,), W, np.int32)}
    gen = torch.Generator(device=device).manual_seed(seed)
    return device, states, step, to_device(batch_np, device), gen


def run_train(batch: int = 256, window: int = 125, seed: int = 0,
              reps: int = 3, trials: int = 3, device=None) -> dict:
    """Measure training frames/s of the concurrent four-module step;
    returns the JSON record. `trials` chained regions of `reps` steps,
    the states threaded from step to step and every step's four losses
    folded into the checksum; the record's value is the median rate."""
    device, states, step, b, gen = _train_setup(batch, window, seed, device)

    def call(st):
        st, losses = step(st, b, gen)
        return list(losses.values()), st

    lstm_train_cuda.reset_launches()
    step(states, b, gen)
    per_step = dict(lstm_train_cuda.launches)
    rates, t_single, checksum = _chained_rates(call, states, batch * window,
                                               reps, trials, device)
    fps = float(np.median(rates))
    # forward + backward of every matmul: ~3x the forward FLOPs per frame
    flops = 3.0 * model_flops_per_frame()
    return {
        "metric": "training_frames_per_sec",
        "value": fps,
        "unit": "frames/s",
        "batch": batch,
        "window": window,
        "step_ms": 1e3 * batch * window / fps,
        "reps": reps,
        "trials": trials,
        "rate_min": min(rates),
        "rate_max": max(rates),
        "seconds_single": t_single,
        "chained_per_run_ratio": (batch * window / t_single) / fps,
        "train_kernel_launches_per_step": per_step,
        "model_flops_per_frame": flops,
        "model_flops_per_sec": fps * flops,
        "pct_of_f32_peak": 100.0 * fps * flops / F32_PEAK_FLOPS,
        "checksum": checksum,
        "device_kind": torch.cuda.get_device_name(device),
    }


def breakdown_train(batch: int = 256, window: int = 125, seed: int = 0,
                    device=None) -> dict:
    """One concurrent train step under `torch.profiler`, reported as
    `breakdown` reports: #7, #8's scan and #8's dW reduction are groups of
    their own."""
    device, states, step, b, gen = _train_setup(batch, window, seed, device)
    rec = _traced(lambda: step(states, b, gen), device)
    return {"batch": batch, "window": window, **rec}


def _forward_setup(batch: int, window: int, seed: int, device):
    """Net, random weights, one batch of windows [batch, window, 60] and a
    fresh velocity carry on the card."""
    device, net, params = _net(seed, device)
    rng = np.random.RandomState(seed)
    imu = torch.from_numpy(
        rng.randn(batch, window, 60).astype(np.float32) * 0.1).to(device)
    cfg = MODULE_CONFIGS["velocity"]
    carry = tuple(torch.zeros((cfg.n_layers, batch, cfg.n_hidden),
                              device=device) for _ in range(2))
    return device, net, params, imu, carry


def run_forward(batch: int = 256, window: int = 45, backend: str = "fused",
                seed: int = 0, reps: int = 3, trials: int = 5,
                device=None) -> dict:
    """Measure single-window forwards/s of `models.net.forward` (one
    window per row, pose_index=None, every output in the checksum, the
    velocity carry threaded); returns the JSON record. Same chained timing
    as `run`; the record's value is the median rate in windows/s."""
    device, net, params, imu, carry = _forward_setup(batch, window, seed,
                                                     device)

    def call(vel_hc):
        pose, joints, vel, contact, vel_hc = forward(
            params, imu, net.body_model, vel_h0c0=vel_hc, backend=backend)
        return (pose, joints, vel, contact), vel_hc

    rates, t_single, checksum = _chained_rates(call, carry, batch, reps,
                                               trials, device)
    wps = float(np.median(rates))
    # every frame of every window goes once through the four modules
    flops = window * model_flops_per_frame()
    return {
        "metric": "single_window_forwards_per_sec",
        "value": wps,
        "unit": "windows/s",
        "backend": backend,
        "batch": batch,
        "window": window,
        "ms_per_forward": 1e3 * batch / wps,
        "reps": reps,
        "trials": trials,
        "rate_min": min(rates),
        "rate_max": max(rates),
        "seconds_single": t_single,
        "chained_per_run_ratio": (batch / t_single) / wps,
        "model_flops_per_window": flops,
        "model_flops_per_sec": wps * flops,
        "pct_of_f32_peak": 100.0 * wps * flops / F32_PEAK_FLOPS,
        "checksum": checksum,
        "device_kind": torch.cuda.get_device_name(device),
    }


def breakdown_forward(batch: int = 256, window: int = 45,
                      backend: str = "fused", seed: int = 0,
                      device=None) -> dict:
    """One `run_forward` call under `torch.profiler`, reported as
    `breakdown` reports; the multicell kernel is a group of its own."""
    device, net, params, imu, carry = _forward_setup(batch, window, seed,
                                                     device)
    rec = _traced(lambda: forward(params, imu, net.body_model,
                                  vel_h0c0=carry, backend=backend), device)
    return {"batch": batch, "window": window, "backend": backend, **rec}


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "multicell_scan_kernel" in low:
        return "#9 multicell_scan (ops/csrc/multicell_scan.cu)"
    if "lstm_train_fwd_kernel" in low:
        return "#7 lstm_train_fwd (ops/csrc/lstm_train.cu)"
    if "lstm_train_bwd_kernel" in low:
        return "#8 lstm_train_bwd scan (ops/csrc/lstm_train.cu)"
    if "lstm_train_dw_kernel" in low:
        return "#8 lstm_train_dw reduction (ops/csrc/lstm_train.cu)"
    if "lstm_scan_masked_int8_kernel" in low:
        return "lstm_scan int8 masked (ops/csrc/lstm_scan_int8.cu)"
    if "lstm_scan_int8_kernel" in low:
        return "lstm_scan int8 (ops/csrc/lstm_scan_int8.cu)"
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
              seed: int = 0, device=None, int8: bool = False) -> dict:
    """One streaming call under `torch.profiler`: device time by kernel
    group, the device's busy share of the call's wall time (profiler on),
    the longest kernels by name, and the host operations with the most
    self time (what keeps the host from running ahead of the device).
    `int8` traces the call on W8A8-quantized params."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device, int8)
    rec = _traced(lambda: net.forward_online_sequence_batched(
        params, state0, frames, mode=mode), device)
    return {"streams": n_streams, "frames": n_frames, "mode": mode,
            "int8": int8, **rec}


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
    ap.add_argument("--train", action="store_true",
                    help="time the concurrent train step at B=256, T=125 "
                         "instead")
    ap.add_argument("--int8", action="store_true",
                    help="stream on W8A8-quantized params")
    args = ap.parse_args()
    if args.train:
        print(json.dumps(run_train()))
    else:
        print(json.dumps(run_offline() if args.offline
                         else run(args.streams, args.frames,
                                  int8=args.int8)))


if __name__ == "__main__":
    main()
