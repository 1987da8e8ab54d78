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
int8 kernels #4 and #6) quantized from the float32 params, and the
record says so. `run(..., bf16=True)` times the call on bf16 params,
state and frames (`nn.convert.cast_params`: the layer kernels' bf16
entries), the counterpart of the JAX bench's `exact_bf16_frames_per_sec`.
`run(..., int8=True, bf16=True)` casts to bf16 first and then quantizes
(int8 on bf16 params: the int8 kernels' bf16 entries, a bf16 state and
bf16 frames), the JAX bench's `exact_int8` leg as it is written.

`run_train` times the concurrent four-module train step
(`train.make_multi_train_step`: every LSTM layer on the training kernels
#7 and #8, the four optimizers) on one batch of `TrainHypers.batch_size`
full-length windows, the same chained way with the losses folded into the
checksum; its rate is training frames/s, B x T valid frames per step over
the step time, and it records the step's peak device memory.
`run_train(..., bf16_residuals=True)` times the same step with the
residuals stored in bf16 (backend 'auto_train_bf16res', the kernels'
`*_bf16res` entries), the counterpart of `cli.train --bf16-residuals`;
`run_train(..., bf16_params=True)` on bf16 params (the float32 batch
promoted as JAX promotes it: the f32 forward on the widened w_hh and
the backward's `*_wbf16` entries, the optimizers' bf16 step).

`run_train_dp` is one rank of the data-parallel concurrent step (run
under `parallel.spawn`, one process per rank): from the seed's states,
one step on the rank's rows of a ragged global batch under each rule,
with its launches, peak memory and gradients, then the steady step time
and the time of the gradient all-reduce alone.

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
      python -m mobileposer_tpu_torch.bench --bf16 [--streams 256]
      python -m mobileposer_tpu_torch.bench --int8 --bf16 [--streams 256]
      python -m mobileposer_tpu_torch.bench --offline
      python -m mobileposer_tpu_torch.bench --train [--bf16-residuals]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
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
from mobileposer_tpu_torch.nn.lstm import cast_params
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
           int8: bool = False, bf16: bool = False):
    """Net, random weights (cast to bf16 with `bf16`, the state and frames
    too; then W8A8-quantized with `int8`: with both, the int8 quantization
    of the bf16 cast, as the JAX bench makes it), fresh state and frames
    on the CUDA device."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    device, net, params = _net(seed, device)
    if bf16:
        params = cast_params(params, dtype)
    if int8:
        params = quantize_params_int8(params)
    state0 = net.init_online_state_batched(n_streams, dtype)
    rng = np.random.RandomState(seed)
    frames = torch.from_numpy(
        rng.randn(n_frames, n_streams, 60).astype(np.float32) * 0.1
    ).to(device=device, dtype=dtype)
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
        int8: bool = False, bf16: bool = False) -> dict:
    """Measure exact-path streamed frames/s; returns the JSON record.

    `trials` chained regions of `reps` calls each are timed; the record's
    value is their median rate, with the lowest and highest beside it.
    `int8` runs on W8A8-quantized params, `bf16` on bf16 params with a
    bf16 state and bf16 frames, both on the int8 quantization of the bf16
    cast."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device, int8, bf16)
    per_call = n_streams * n_frames
    rates, t_single, checksum = _chained_rates(
        lambda st: net.forward_online_sequence_batched(params, st, frames,
                                                       mode=mode),
        state0, per_call, reps, trials, device)
    fps = float(np.median(rates))
    # one emitted streaming frame re-runs the full window through all four
    # modules (reference semantics, net.py:174-178)
    flops = NUM_TOTAL * model_flops_per_frame()
    int8_fields = {"int8": int8, "bf16": bf16}
    if int8:
        int8_fields["int8_quantized_from"] = (
            "bf16 params (the JAX bench's exact_int8 leg)" if bf16 else
            "float32 params (the JAX bench's exact_int8 leg quantizes its "
            "bf16 params: run(int8=True, bf16=True))")
    return {
        "metric": ("exact_int8_bf16_streamed_frames_per_sec" if int8 and bf16
                   else "exact_int8_streamed_frames_per_sec" if int8
                   else "exact_bf16_streamed_frames_per_sec" if bf16
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


def _train_setup(batch: int, window: int, seed: int, device,
                 bf16_residuals: bool = False, bf16_params: bool = False):
    """Four fresh train states (bf16 params with `bf16_params`), the
    concurrent step (on backend 'auto_train', or 'auto_train_bf16res' with
    `bf16_residuals`), one full-length batch on the card (numpy draws from
    the seed: IMU, joint, pose and velocity targets, contacts) and the
    draws' generator."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the bench times a CUDA device; a CPU run is not "
                           "a measurement of the port")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = torch.Generator().manual_seed(seed)
    dtype = torch.bfloat16 if bf16_params else torch.float32
    states = {n: init_train_state(n, init, C.train_hypers.lr, device, dtype)
              for n in MODULE_NAMES}
    step = make_multi_train_step(
        ParametricModel.synthetic(),
        backend="auto_train_bf16res" if bf16_residuals else "auto_train")
    batch_np = train_batch(batch, window, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return device, states, step, to_device(batch_np, device), gen


def train_batch(batch: int, window: int, seed: int,
                ragged: bool = False) -> dict:
    """A numpy training batch from the seed: IMU, joint, pose and velocity
    targets, contacts; every window full length, or with `ragged` of
    lengths drawn between half the window and all of it."""
    rng = np.random.RandomState(seed)
    B, W = batch, window

    def f32(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    out = {"imu": f32(B, W, 60, scale=0.3), "joints": f32(B, W, 72),
           "pose_r6d": f32(B, W, 24, 6), "vels": f32(B, W, 72),
           "tran": f32(B, W, 3),
           "contacts": (rng.rand(B, W, 2) > 0.5).astype(np.float32),
           "lengths": np.full((B,), W, np.int32)}
    if ragged:
        out["lengths"] = rng.randint(W // 2, W + 1, size=B).astype(np.int32)
    return out


def _flat_grads(states) -> np.ndarray:
    return np.concatenate([p.grad.reshape(-1).cpu().numpy()
                           for n in MODULE_NAMES
                           for p in states[n].params.parameters()])


def _dp_states(weights, seed: int, device):
    """Four train states: the modules of the combined weights file
    `weights` with fresh optimizers, or without one the seed's init."""
    from mobileposer_tpu_torch.models.utils import load_model
    from mobileposer_tpu_torch.train.trainer import _state_from_tree
    if weights is not None:
        tree = load_model(weights)
        return {n: _state_from_tree(n, tree[n], C.train_hypers.lr, device)
                for n in MODULE_NAMES}
    init = torch.Generator().manual_seed(seed)
    return {n: init_train_state(n, init, C.train_hypers.lr, device)
            for n in MODULE_NAMES}


def run_train_dp(rank: int, device, out_dir: str, batch: int = 256,
                 window: int = 125, seed: int = 0, reps: int = 3,
                 weights=None) -> dict:
    """One rank of the data-parallel concurrent train step, in a process
    group `parallel.spawn` started (one process per rank). For each rule
    ('gspmd', 'shard_map'): from the seed's states (or those of the
    combined weights file `weights`, fresh optimizers), this rank's own loss
    before any reduction (the rule's draws), then one step on its rows of
    the seed's ragged global batch of `batch` windows (its launches of #7
    and #8, its peak memory, the reduced losses, the reduced gradients
    saved to `out_dir`), then the steady step time over `reps` steps and
    the time of the all-reduce of as many floats alone. Returns {rule:
    record}. On a CPU device (a gloo rehearsal) there is no peak memory."""
    import torch.distributed as dist

    from mobileposer_tpu_torch.parallel import distributed as D
    from mobileposer_tpu_torch.train.trainer import (_rank_losses,
                                                     local_rows, loss_fn_for)
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = D.process_mesh(device)
    world = mesh.size
    body = ParametricModel.synthetic()
    global_np = train_batch(batch, window, seed, ragged=True)
    local = to_device(local_rows(global_np, rank, world), device)
    out = {}
    for impl in ("gspmd", "shard_map"):
        states = _dp_states(weights, seed, device)
        step = make_multi_train_step(body, mesh=mesh, dp_impl=impl)
        with torch.no_grad():
            own = _rank_losses(
                {n: loss_fn_for(n, body) for n in MODULE_NAMES},
                {n: states[n].params for n in MODULE_NAMES}, local,
                torch.Generator(device=device).manual_seed(seed),
                (rank, world), impl, True)
        own = {n: float(v) for n, v in own.items()}
        lstm_train_cuda.reset_launches()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        states, losses = step(states, local,
                              torch.Generator(device=device).manual_seed(seed))
        sync()
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        launches = dict(lstm_train_cuda.launches)
        grads = _flat_grads(states)
        path = f"{out_dir}/grads_{impl}_{rank}.npy"
        np.save(path, grads)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            states, _ = step(states, local, gen)
        sync()
        step_ms = 1e3 * (time.perf_counter() - t0) / reps
        flat = torch.zeros(grads.size + len(MODULE_NAMES), device=device)
        dist.all_reduce(flat)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(flat)
        sync()
        reduce_ms = 1e3 * (time.perf_counter() - t0) / reps
        out[impl] = {"rank": rank, "device": str(device), "world": world,
                     "backend": dist.get_backend(),
                     "rows": batch // world, "window": window,
                     "own_losses": own,
                     "losses": {n: float(v) for n, v in losses.items()},
                     "launches": launches, "peak_memory_bytes": peak,
                     "step_ms": step_ms, "reduce_ms": reduce_ms,
                     "reduce_floats": int(flat.numel()), "grads": path}
    return out


def run_train(batch: int = 256, window: int = 125, seed: int = 0,
              reps: int = 3, trials: int = 3, device=None,
              bf16_residuals: bool = False,
              bf16_params: bool = False) -> dict:
    """Measure training frames/s of the concurrent four-module step (its
    residuals in bf16 with `bf16_residuals`, on bf16 params with
    `bf16_params`); returns the JSON record.
    `trials` chained regions of `reps` steps, the states threaded from
    step to step and every step's four losses folded into the checksum;
    the record's value is the median rate. `peak_memory_bytes` is
    `torch.cuda.max_memory_allocated` over one step (the states, the batch
    and everything the step allocates), after a reset."""
    device, states, step, b, gen = _train_setup(batch, window, seed, device,
                                                bf16_residuals, bf16_params)

    def call(st):
        st, losses = step(st, b, gen)
        return list(losses.values()), st

    lstm_train_cuda.reset_launches()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    step(states, b, gen)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    per_step = dict(lstm_train_cuda.launches)
    rates, t_single, checksum = _chained_rates(call, states, batch * window,
                                               reps, trials, device)
    fps = float(np.median(rates))
    # forward + backward of every matmul: ~3x the forward FLOPs per frame
    flops = 3.0 * model_flops_per_frame()
    return {
        "metric": ("training_"
                   + "bf16params_" * bf16_params
                   + "bf16res_" * bf16_residuals + "frames_per_sec"),
        "value": fps,
        "unit": "frames/s",
        "batch": batch,
        "window": window,
        "bf16_residuals": bf16_residuals,
        "bf16_params": bf16_params,
        "step_ms": 1e3 * batch * window / fps,
        "peak_memory_bytes": peak,
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
                    device=None, bf16_residuals: bool = False) -> dict:
    """One concurrent train step (its residuals in bf16 with
    `bf16_residuals`) under `torch.profiler`, reported as `breakdown`
    reports: #7, #8's scan and #8's dW reduction are groups of their own,
    their bf16res entries too."""
    device, states, step, b, gen = _train_setup(batch, window, seed, device,
                                                bf16_residuals)
    rec = _traced(lambda: step(states, b, gen), device)
    return {"batch": batch, "window": window,
            "bf16_residuals": bf16_residuals, **rec}


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


def _train_entry_suffix(low: str) -> str:
    """The entry suffix of a training kernel's instantiation, from its
    template arguments <R, Res[, IO[, W]]> (`lstm_train_cuda.SCAN_ENTRY`):
    '' for float32 throughout, 'bf16res', 'bf16', 'wbf16', ..."""
    m = re.search(r"_kernel<\d+((?:,\s*\w+)*)>", low)
    types = [t.strip() for t in m.group(1).split(",")[1:]] if m else []
    res, io, w = (["bfloat16" in t for t in types] + [False] * 3)[:3]
    base = "bf16" if io else "wbf16" if w else ""
    return "_".join(x for x in (base, "bf16res" * res) if x)


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "bfloat16" in low and "_scan_" in low:  # a bf16-I/O entry's kernel
        return _kernel_group(low.replace("bfloat16", "")) + " bf16"
    if "lstm_train_" in low:
        suffix = _train_entry_suffix(low)
        group = ("#7 lstm_train_fwd" if "lstm_train_fwd_kernel" in low
                 else "#8 lstm_train_bwd scan"
                 if "lstm_train_bwd_kernel" in low
                 else "#8 lstm_train_dw reduction")
        return f"{group} (ops/csrc/lstm_train.cu)" + (
            f" {suffix}" if suffix else "")
    if "multicell_scan_kernel" in low:
        return "#9 multicell_scan (ops/csrc/multicell_scan.cu)"
    if "lstm_scan_masked_int8_kernel" in low:
        return "lstm_scan int8 masked (ops/csrc/lstm_scan_int8.cu)"
    if "lstm_scan_int8_kernel" in low:
        return "lstm_scan int8 (ops/csrc/lstm_scan_int8.cu)"
    if "lstm_scan_masked_kernel" in low:
        return "lstm_scan masked (ops/csrc/lstm_scan.cu)"
    if "lstm_scan_kernel" in low:
        return "lstm_scan (ops/csrc/lstm_scan.cu)"
    # cuBLAS's Hopper kernels for bf16 products are named nvjet_*
    if ("gemm" in low or "cutlass" in low or "xmma" in low
            or low.startswith("nvjet")):
        return "matmul (cuBLAS: projections, linears)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, cat/flip, IK, fusion)"


def breakdown(n_streams: int = 256, n_frames: int = 100, mode: str = "auto",
              seed: int = 0, device=None, int8: bool = False,
              bf16: bool = False) -> dict:
    """One streaming call under `torch.profiler`: device time by kernel
    group, the device's busy share of the call's wall time (profiler on),
    the longest kernels by name, and the host operations with the most
    self time (what keeps the host from running ahead of the device).
    `int8` traces the call on W8A8-quantized params, `bf16` on bf16
    ones."""
    device, net, params, state0, frames, mode = _setup(
        n_streams, n_frames, mode, seed, device, int8, bf16)
    rec = _traced(lambda: net.forward_online_sequence_batched(
        params, state0, frames, mode=mode), device)
    return {"streams": n_streams, "frames": n_frames, "mode": mode,
            "int8": int8, "bf16": bf16, **rec}


def breakdown_offline(batch: int = 64, bucket: int = 512, seed: int = 0,
                      device=None) -> dict:
    """One `forward_offline_batched` call over the `run_offline` group
    under `torch.profiler`, reported as `breakdown` reports."""
    device, net, params, imu, lengths, n_valid = _offline_setup(
        batch, bucket, seed, device)
    rec = _traced(lambda: forward_offline_batched(net, params, imu, lengths),
                  device)
    return {"batch": batch, "bucket": bucket, "valid_frames": n_valid, **rec}


def run_offline_sharded(mesh=None, batch: int = 64, bucket: int = 512,
                        seed: int = 0, calls: int = 5, device=None) -> dict:
    """The evaluation's offline pass over the `run_offline` group (the
    same seeded rows, as [n_i, 60] host sequences), as `evaluate_pose`
    runs it: `pose_eval._predict_offline_batched`, from the host
    sequences to the host predictions, on one device or sharded over
    `mesh` (`parallel.Mesh`; the params replicated once, outside the
    timing, as `evaluate_pose` replicates them once). Seconds of a call,
    each ended by the fetch to the host: the median of `calls` after a
    warm-up, then one call under `torch.profiler` with each card's busy
    share. `checksum` sums the predictions (finite, and equal to one
    device's up to the per-shard tiling)."""
    from mobileposer_tpu_torch.evaluation.pose_eval import (
        _predict_offline_batched)
    from mobileposer_tpu_torch.parallel import replicate_params
    device, net, params = _net(seed, device)
    rng = np.random.RandomState(seed)
    lengths = rng.randint(bucket // 2 + 1, bucket + 1, size=batch)
    imu = rng.randn(batch, bucket, 60).astype(np.float32) * 0.1
    imus = [imu[b, :n] for b, n in enumerate(lengths)]
    if mesh is not None:
        params = replicate_params(params, mesh)

    def call():
        return _predict_offline_batched(net, params, imus, bucket, batch,
                                        mesh=mesh)
    call()
    secs = []
    for _ in range(calls):
        t0 = time.perf_counter()
        preds = call()
        secs.append(time.perf_counter() - t0)
    checksum = float(sum(p.sum(dtype=np.float64) + t.sum(dtype=np.float64)
                         for p, t in preds))
    if not math.isfinite(checksum):
        raise RuntimeError(f"non-finite predictions (checksum {checksum})")
    devices = mesh.distinct if mesh is not None else (device,)
    return {
        "metric": "offline_eval_group_seconds",
        "value": float(np.median(secs)),
        "unit": "s",
        "batch": batch, "bucket": bucket,
        "valid_frames": int(lengths.sum()),
        "shards": mesh.size if mesh is not None else 1,
        "devices": [str(d) for d in devices],
        "seconds": secs,
        "valid_frames_per_sec": float(lengths.sum() / np.median(secs)),
        "checksum": checksum,
        "trace": _traced(call, devices),
        "device_kind": torch.cuda.get_device_name(device),
    }


def _traced(call, device) -> dict:
    """Warm `call` up, then run it once under `torch.profiler`. `device`
    may be a sequence of devices: each is synchronized, and the record
    gives each one's busy seconds and share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    devices = [device] if isinstance(device, (str, torch.device)) \
        else list(device)

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)
    call()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        sync()
        wall = time.perf_counter() - t0
    by_device: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = f"cuda:{ev.device_index}"
            by_device[k] = by_device.get(k, 0.0) + (
                ev.time_range.elapsed_us() / 1e6)
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
        "busy_seconds_by_device": by_device,
        "busy_share_by_device": {k: v / wall for k, v in by_device.items()},
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
    ap.add_argument("--bf16", action="store_true",
                    help="stream on bf16 params, state and frames")
    ap.add_argument("--bf16-residuals", action="store_true",
                    help="with --train: store the residuals in bf16")
    args = ap.parse_args()
    if args.train:
        print(json.dumps(run_train(bf16_residuals=args.bf16_residuals)))
    else:
        print(json.dumps(run_offline() if args.offline
                         else run(args.streams, args.frames,
                                  int8=args.int8, bf16=args.bf16)))


if __name__ == "__main__":
    main()
