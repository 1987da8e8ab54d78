#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's streaming, evaluation, training and fused
single-window paths on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels of `mobileposer_tpu_torch` from this checkout,
then runs these phases, each printing JSON lines:

  1. card    — `nvidia-smi` name and power limit, torch and CUDA versions;
               TF32 is turned off for the whole run;
  2. build   — nvcc time for the four sources, built in parallel
               (set-up, not kernel time), and ptxas usage;
  3. kernel  — each full-length kernel against its plain PyTorch version
               at the streaming shapes (f32, nonzero h0/c0): max abs
               error, kernel / plain / cuDNN `torch.nn.LSTM` times, the
               card's bound for the same work, and the kernel time PERF.md
               recorded for the same shape;
  3b. masked — each masked kernel against its plain version at the
               evaluation shapes (T = 512 and 1024, a seeded ragged mask
               with an empty row and a full row): the same numbers, with
               cuDNN on `pack_padded_sequence` as the yardstick, and a
               check that every masked step emitted exactly zero;
  3c. train kernels — the training forward (#7), the BPTT backward (#8)
               and its dW reduction against their plain versions at
               T = 125, B = 256 (H = 256 and 64) and B = 37, a seeded
               ragged mask: the same numbers, cuDNN `torch.nn.LSTM` in
               training mode (forward, backward) and `torch.matmul` (dW)
               as the yardsticks, exact zeros at masked steps, dW the same
               from run to run;
  3d. int8 kernels — the W8A8 scans (#4, #5, #6) against their plain
               versions at the streaming and evaluation shapes: one step
               from h0, the full shape, exact zeros at masked steps; kernel,
               plain and float-kernel times and the bound at the int8 rate
               (no PyTorch call computes a W8A8 scan, so no library time);
  3e. multicell — the multicell scan (#9) against its plain version at
               T = 45, B = 256 and 8, the trio's five cells H = (256, 256,
               64, 64, 256), nonzero h0/c0, and threaded through chunks of
               4 steps; kernel, plain and per-module times (the layer
               kernels on the same five cells, the yardstick: no PyTorch
               call computes cells of different H, so no library time;
               three cuDNN `torch.nn.LSTM` calls printed beside it) and the
               bound summed over the cells;
  4. slice   — the trained fixture weights through
               `forward_online_sequence_batched` on the card in 'scan'
               and 'unfolded' modes, each continued from its final state,
               held to the same calls on the CPU port; the kernels'
               launch counters must move by the expected counts; then the
               same on the fixture quantized to W8A8 (the int8 counters
               move by the float path's counts, the float ones not at
               all);
  4b. eval   — synthetic sequences written as a processed `.pt`, evaluated
               by the port's CLI (`cli.evaluate.main`) with the trained
               fixture: offline alone on the card (the masked counters
               must move by 6 bi + 2 uni per bucket group, the
               full-length ones not at all), then offline + ONLINE +
               drift on the card and on the CPU, tables compared; then all
               of it again with `--int8`, and the int8 tables held to the
               float32 ones within the JAX package's accuracy bound;
  4c. train  — synthetic training data written with the port's fixture,
               `cli.train --concurrent --fast-dev-run --combine` on the
               card (two steps at B = 256, one validation batch): finite
               losses, the training counters at 14 launches per step, the
               validation batch on the masked kernels only; the combined
               weights through `cli.evaluate`; one concurrent step on the
               card against the CPU port from identical params, batch and
               draws;
  4d. fused  — the trained fixture through `forward(backend='fused')` on
               the card at B = 8 and 256 windows of T = 45, held to the CPU
               port and to `forward(backend='auto')` on the card; exactly 2
               multicell and 2 bidirectional launches per forward, none
               of the unidirectional kernel; with `lengths`, the masked
               kernels (6 bi + 2 uni) and no multicell launch; int8 params
               raise ValueError;
  5. rate    — exact-path streamed frames/s (`mobileposer_tpu_torch.bench`)
               at 256 streams (scan) and 8 streams (unfolded), then one
               traced call of each: device time by kernel group and the
               device's busy share; then the same at 256 streams on W8A8
               params (`bench.run(int8=True)`);
  5b. offline rate — offline-evaluation valid and padded frames/s of one
               64 x 512 ragged group (`bench.run_offline`), then one
               traced call;
  5c. train rate — training frames/s of the concurrent step at B = 256,
               T = 125 (`bench.run_train`), then one traced step;
  5d. forward rate — single-window forwards/s at B = 256, T = 45
               (`bench.run_forward`), 'fused' and 'auto' in turns (fused,
               auto, auto, fused), then one traced call of each;
  6. kernels — one line with every ported kernel's numbers; no TPU
               kernel is left to port.

Any failure raises and exits non-zero before the last line, which is
`{"ok": true, "device": {...}}` only when every phase passed. The script
exits non-zero at once when no CUDA device is present, and when run
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "demo_checkpoint_f16.npz"

# Max abs error of a kernel against its plain version: both accumulate
# h @ w_hh in float32, in a different order (the kernel sums k serially
# per thread, cuBLAS in tiles), so outputs in [-1, 1] differ by float32
# rounding carried through 45 steps.
KERNEL_TOL = 1e-5
# Max abs error of the slice on the card against the CPU port (plain
# versions): the same rounding differences through 8 LSTM layers, the
# IK and the translation fusion.
SLICE_TOL = 5e-5
# Relative tolerance of the evaluation tables (and drift) on the card
# against the CPU port: the metrics are means over 1,300 frames of
# errors in degrees, cm and m/s^3 (the jerk rows scaled by fps^3 =
# 27,000), computed from poses and a root translation summed over up to
# 565 frames, through T = 1024 masked scans; ten times the CPU pin of
# the port against the JAX package (1e-4, tests/test_torch_eval.py) for
# the card's other summation order. EVAL_ATOL covers rows near zero.
EVAL_RTOL = 1e-3
EVAL_ATOL = 1e-4
# Max abs error of the training kernels against their plain versions
# (#7's six outputs; #8's dx_proj, dh0 and dc0): the recurrent products
# accumulate in float32 in a different order, and nvcc contracts the gate
# derivatives into FMAs, so values of order 1 differ by float32 rounding
# carried through 125 steps forward and back.
TRAIN_TOL = 1e-5
# dw_hh sums 32,000 products (T*B rows) per entry, in tiles and slabs on
# the card and step by step in the plain version: its error is held
# relative to max|dw_hh|, at float32 rounding of a sum that long.
DW_REL_TOL = 1e-5
LIB_TRAIN = ("torch.nn.LSTM 1 layer, training mode, full length (cuDNN, "
             "TF32 off; its input projection included), ")
# Phase 4c's synthetic training data: 20 sequences of 300 frames are 60
# windows (the last of each 50 frames long) x 12 combos = 720 samples,
# 648 in the 90% training split: two full batches of 256.
TRAIN_SEQUENCES = (20, 300)
# Phase 4c's card-vs-CPU train step: batch size (the CPU side runs the
# plain loops), and tolerances. Losses are means over the batch, held
# relatively; each gradient tensor is held relative to its largest entry:
# the card sums the projections in cuBLAS tiles and the recurrences in
# another order, and the difference is carried back through 125 steps of
# BPTT and two layers.
STEP_BATCH = 8
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-4
# Phase 4b's sequence lengths: bucket 512 holds two ragged sequences,
# 560 frames takes a 1024 bucket of its own.
EVAL_LENGTHS = (300, 420, 560)
# The full-length kernels' times at T=45, H=256, B=256 recorded in
# PERF.md section 6, printed beside this run's.
PERF_MD_MS = {"bilstm_scan_f32": 1.307, "lstm_scan_f32": 1.311}

HBM_BYTES_PER_S = 3.35e12    # H100 SXM
F32_FLOPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12     # H100 SXM, int8 tensor cores, dense

# The int8 kernels against their plain versions. One step from h0: both
# sides quantize the same h0, so the recurrent term is the same exact
# int32 product dequantized in the same order; the kernel computes the
# cell with torch's formulas and roundings, so only a difference between
# its expf/tanhf and torch's would show, at float32 rounding of values
# in [-1, 1].
INT8_STEP_TOL = 1e-6
# Full shape: if the nonlinearities differ in a last bit, an h/scale can
# land on the other side of a rounding boundary and move one int8 value by
# one level, which moves that row's gates by max|w| * scale <= (1/16) *
# (1/127) = 5e-4 at H = 256 and carries on through the row's later steps.
# Both compute the same roundings (0.0 on an H100 at 700 W); ten flips'
# worth.
INT8_KERNEL_TOL = 5e-3
# The int8 slice on the card against the CPU port: torch's CPU sigmoid and
# tanh differ from the card's in the last bits, so flips occur (tens per
# call at S = 8); a few flips' worth after the linears and the r6d
# normalization, as tests/test_torch_quant.py holds the CPU port to the
# JAX package.
INT8_SLICE_TOL = 2e-3
# The int8 evaluation tables, card against the CPU port: the same flips
# move a frame's pose and joints by a few 1e-4, so each mean row by a
# relative 1e-3 at most; the jitter row (6) is a mean of jerks, positions
# times fps^3 = 27,000, so it is held absolutely (units of 100 m/s^3);
# drift windows integrate the root velocity over metres of travel.
INT8_EVAL_RTOL = 1e-3
INT8_JITTER_ATOL = 2e-2
INT8_DRIFT_RTOL = 1e-2
# int8 against float32 on the card: the JAX package's own accuracy bound
# for the exact path (tests/test_quant.py:391-393), on rows 0 (SIP, deg),
# 3 (positional, cm) and 6 (jitter).
INT8_DELTA_BOUND = {0: 0.5, 3: 0.5, 6: 0.2}

# file:line of each TPU kernel (the `pallas_call` site's function) and the
# port's kernel for it; every one is ported
TPU_KERNELS = [
    ("bilstm_layer_pallas", "mobileposer_tpu/ops/lstm_pallas.py:264",
     "bilstm_scan_f32"),
    ("lstm_layer_pallas", "mobileposer_tpu/ops/lstm_pallas.py:73",
     "lstm_scan_f32"),
    ("lstm_layer_masked_pallas", "mobileposer_tpu/ops/lstm_pallas.py:163",
     "bilstm_scan_masked_f32"),
    ("lstm_layer_masked_pallas", "mobileposer_tpu/ops/lstm_pallas.py:163",
     "lstm_scan_masked_f32"),
    ("lstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:434",
     "lstm_scan_int8"),
    ("lstm_layer_masked_pallas_int8",
     "mobileposer_tpu/ops/lstm_pallas.py:354", "bilstm_scan_masked_int8"),
    ("lstm_layer_masked_pallas_int8",
     "mobileposer_tpu/ops/lstm_pallas.py:354", "lstm_scan_masked_int8"),
    ("bilstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:523",
     "bilstm_scan_int8"),
    ("_fwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:90",
     "lstm_train_fwd_f32"),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
     "lstm_train_bwd_f32"),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
     "lstm_train_dw_f32"),
    ("multicell_lstm_pallas", "mobileposer_tpu/ops/multicell_pallas.py:83",
     "multicell_scan_f32"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean ms per call of `fn` over n calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def layer_bound(n_dir: int, T: int, B: int, H: int, valid_steps=None):
    """Least time (ms) the card needs for one layer scan: each input read
    once, each output written once, the recurrent products at the
    float32 rate. With `valid_steps` (the sum of a ragged batch's
    lengths) only the valid steps need their products and their x_proj
    rows, and the [T, B] mask is read once. Returns (bound_ms, bound_by,
    flops, bytes)."""
    steps = T * B if valid_steps is None else valid_steps
    flops = n_dir * steps * 2.0 * H * 4 * H
    floats = n_dir * (steps * 4 * H      # x_proj
                      + H * 4 * H        # w_hh
                      + 2 * B * H        # h0, c0
                      + T * B * H        # ys
                      + 2 * B * H)       # h_T, c_T
    if valid_steps is not None:
        floats += T * B                  # mask, shared by the directions
    t_bytes = 4.0 * floats / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", flops, 4 * floats)


def phase_kernels(torch, lstm_cuda):
    """Each kernel vs its plain version at the streaming path's shapes:
    B=256 is the scan mode at 256 streams, B=200 the unfolded mode's
    chunk of 25 windows x 8 streams, B=8 its velocity layers."""
    import numpy as np
    T = 45
    cases = [("bilstm_scan_f32", 256, 256), ("bilstm_scan_f32", 64, 256),
             ("lstm_scan_f32", 256, 256), ("bilstm_scan_f32", 256, 200),
             ("bilstm_scan_f32", 64, 200), ("lstm_scan_f32", 256, 8)]
    results = []
    for name, H, B in cases:
        bi = name == "bilstm_scan_f32"
        n_dir = 2 if bi else 1
        rng = np.random.RandomState(H + B)

        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).cuda()

        bound = 1.0 / math.sqrt(H)
        dirs = [(t(T, B, 4 * H),
                 torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H))
                                  .astype(np.float32)).cuda(),
                 t(B, H, scale=0.5), t(B, H, scale=0.5))
                for _ in range(n_dir)]
        if bi:
            (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = dirs
            args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b)
            kern, plain = lstm_cuda.bilstm_layer, lstm_cuda.bilstm_layer_plain
        else:
            args = dirs[0]
            kern, plain = lstm_cuda.lstm_layer, lstm_cuda.lstm_layer_plain

        def flat(out):
            return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]

        got = flat(kern(*args))
        torch.cuda.synchronize()
        want = flat(plain(*args))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)

        lstm = torch.nn.LSTM(H, H, num_layers=1, bidirectional=bi).cuda()
        x_lib = t(T, B, H)
        hc_lib = (t(n_dir, B, H, scale=0.5), t(n_dir, B, H, scale=0.5))
        with torch.no_grad():
            library_ms = time_ms(lambda: lstm(x_lib, hc_lib), 20)
            kernel_ms = time_ms(lambda: kern(*args), 20)
            plain_ms = time_ms(lambda: plain(*args), 3, warmup=1)
        bound_ms, bound_by, flops, nbytes = layer_bound(n_dir, T, B, H)
        rec = {"phase": "kernel", "name": name, "T": T, "B": B, "H": H,
               "max_abs_err": err, "tol": KERNEL_TOL, "kernel_ms": kernel_ms,
               "perf_md_ms": PERF_MD_MS.get(name) if (H, B) == (256, 256)
               else None,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "torch.nn.LSTM 1 layer (cuDNN, TF32 off; includes "
                          "its input projection)",
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        require(finite, f"{name} H={H} B={B}: non-finite output")
        require(err <= KERNEL_TOL,
                f"{name} H={H} B={B}: max abs err {err} > {KERNEL_TOL}")
        results.append(rec)
    return results


def phase_masked_kernels(torch, lstm_cuda):
    """Each masked kernel vs its plain version at the evaluation shapes:
    B=64 is `evaluate_pose`'s group size, T=512 its bucket; B=37, T=1024
    a ragged batch edge and the next bucket. Lengths are drawn from a
    seed, with an empty row and a full row."""
    import numpy as np
    from torch.nn.utils.rnn import pack_padded_sequence
    cases = [("bilstm_scan_masked_f32", 256, 64, 512),
             ("bilstm_scan_masked_f32", 64, 64, 512),
             ("lstm_scan_masked_f32", 256, 64, 512),
             ("bilstm_scan_masked_f32", 256, 37, 1024)]
    results = []
    for name, H, B, T in cases:
        bi = name == "bilstm_scan_masked_f32"
        n_dir = 2 if bi else 1
        rng = np.random.RandomState(H + B + T)

        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).cuda()

        bound = 1.0 / math.sqrt(H)
        dirs = [(t(T, B, 4 * H),
                 torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H))
                                  .astype(np.float32)).cuda(),
                 t(B, H, scale=0.5), t(B, H, scale=0.5))
                for _ in range(n_dir)]
        lengths = rng.randint(1, T, size=B)
        lengths[0], lengths[1] = 0, T
        mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None, :]
                ).float().cuda()
        if bi:
            (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = dirs
            args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b, mask)
            kern = lstm_cuda.bilstm_layer_masked
            plain = lstm_cuda.bilstm_layer_masked_plain
        else:
            args = dirs[0] + (mask,)
            kern = lstm_cuda.lstm_layer_masked
            plain = lstm_cuda.lstm_layer_masked_plain

        def flat(out):
            return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]

        got = flat(kern(*args))
        torch.cuda.synchronize()
        want = flat(plain(*args))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ys = got[:n_dir]
        masked_nonzero = sum(int((y[mask == 0] != 0).sum()) for y in ys)

        # cuDNN yardstick: one layer on the packed batch (lengths >= 1:
        # packing takes no empty row, so the empty row runs one step)
        lstm = torch.nn.LSTM(H, H, num_layers=1, bidirectional=bi).cuda()
        packed = pack_padded_sequence(
            t(T, B, H), torch.from_numpy(np.maximum(lengths, 1)),
            enforce_sorted=False)
        hc_lib = (t(n_dir, B, H, scale=0.5), t(n_dir, B, H, scale=0.5))
        with torch.no_grad():
            library_ms = time_ms(lambda: lstm(packed, hc_lib), 5)
            kernel_ms = time_ms(lambda: kern(*args), 5)
            plain_ms = time_ms(lambda: plain(*args), 1, warmup=1)
        bound_ms, bound_by, flops, nbytes = layer_bound(
            n_dir, T, B, H, valid_steps=int(lengths.sum()))
        rec = {"phase": "masked_kernel", "name": name, "T": T, "B": B,
               "H": H, "lengths_min_max_sum": [int(lengths.min()),
                                               int(lengths.max()),
                                               int(lengths.sum())],
               "max_abs_err": err, "tol": KERNEL_TOL,
               "masked_steps_nonzero": masked_nonzero,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "torch.nn.LSTM 1 layer on pack_padded_sequence "
                          "(cuDNN, TF32 off; includes its input projection)",
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        require(finite, f"{name} H={H} B={B} T={T}: non-finite output")
        require(masked_nonzero == 0,
                f"{name} H={H} B={B} T={T}: {masked_nonzero} masked outputs "
                "are not zero")
        require(err <= KERNEL_TOL,
                f"{name} H={H} B={B} T={T}: max abs err {err} > {KERNEL_TOL}")
        results.append(rec)
    return results


def int8_layer_bound(n_dir: int, T: int, B: int, H: int, valid_steps=None):
    """Least time (ms) the card needs for one int8 layer scan: each input
    read once (x_proj, state and mask float32, w_hh int8, its scale
    float32), each output written once, the recurrent products at the
    int8 tensor-core rate; with `valid_steps`, only the valid steps'
    products and x_proj rows. Returns (bound_ms, bound_by, ops, bytes)."""
    steps = T * B if valid_steps is None else valid_steps
    ops = n_dir * steps * 2.0 * H * 4 * H
    nbytes = n_dir * (4.0 * (steps * 4 * H    # x_proj
                             + 4 * H          # w_scale
                             + 2 * B * H      # h0, c0
                             + T * B * H      # ys
                             + 2 * B * H)     # h_T, c_T
                      + H * 4 * H)            # w_hh, int8
    if valid_steps is not None:
        nbytes += 4.0 * T * B                 # mask, shared by the directions
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT8_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def phase_int8_kernels(torch, lstm_cuda):
    """Kernels #4, #5 and #6 against their plain versions, at the
    streaming shapes (T = 45: B = 256 the scan mode at 256 streams, B = 200
    the unfolded chunk of 25 windows x 8 streams, B = 8 its velocity
    layers) and the evaluation shapes (T = 512, B = 64; T = 1024, B = 37)
    with a seeded ragged mask holding an empty row and a full row. Weights
    drawn like torch's init and quantized per column; h0 in (-1, 1) as a
    hidden state is. Three checks: one step from h0 (both sides quantize
    the same h0, so the recurrent term is the same exact product: the
    outputs within INT8_STEP_TOL), the full shape (INT8_KERNEL_TOL, with
    the mean error and the share of elements beyond 1e-5), and exact zeros
    at masked steps. The float kernel is timed at the same shape on the
    dequantized weights."""
    import numpy as np
    from mobileposer_tpu_torch.ops.quant import quantize_weight_int8
    L = lstm_cuda
    fns = {"bilstm_scan_int8": (L.bilstm_layer_int8, L.bilstm_layer_int8_plain,
                                L.bilstm_layer),
           "lstm_scan_int8": (L.lstm_layer_int8, L.lstm_layer_int8_plain,
                              L.lstm_layer),
           "bilstm_scan_masked_int8": (L.bilstm_layer_masked_int8,
                                       L.bilstm_layer_masked_int8_plain,
                                       L.bilstm_layer_masked),
           "lstm_scan_masked_int8": (L.lstm_layer_masked_int8,
                                     L.lstm_layer_masked_int8_plain,
                                     L.lstm_layer_masked)}
    cases = [("bilstm_scan_int8", 256, 256, 45),
             ("bilstm_scan_int8", 64, 256, 45),
             ("lstm_scan_int8", 256, 256, 45),
             ("bilstm_scan_int8", 256, 200, 45),
             ("bilstm_scan_int8", 64, 200, 45),
             ("lstm_scan_int8", 256, 8, 45),
             ("bilstm_scan_masked_int8", 256, 64, 512),
             ("bilstm_scan_masked_int8", 64, 64, 512),
             ("lstm_scan_masked_int8", 256, 64, 512),
             ("bilstm_scan_masked_int8", 256, 37, 1024)]
    results, failures = [], []
    for name, H, B, T in cases:
        kern, plain, kern_f32 = fns[name]
        n_dir = 2 if name.startswith("bi") else 1
        masked = "masked" in name
        rng = np.random.RandomState(H + B + T + 1)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

        bound = 1.0 / math.sqrt(H)
        dirs = []
        for _ in range(n_dir):
            w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound,
                                                        (H, 4 * H)))
            dirs.append({"x": t(rng.randn(T, B, 4 * H)),
                         "w": torch.from_numpy(w_q).cuda(), "s": t(w_s),
                         "w_f32": t(w_q.astype(np.float32) * w_s),
                         "h0": t(np.tanh(rng.randn(B, H))),
                         "c0": t(rng.randn(B, H) * 0.5)})
        lengths = rng.randint(1, T, size=B)
        lengths[0], lengths[1] = 0, T
        mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None, :]
                ).float().cuda()

        def args(steps, f32=False):
            """The kernel's (or the float kernel's) arguments over the
            first `steps` steps."""
            xs = [d["x"][:steps].contiguous() for d in dirs]
            ws = [d["w_f32" if f32 else "w"] for d in dirs]
            scales = [] if f32 else [d["s"] for d in dirs]
            state = [v for d in dirs for v in (d["h0"], d["c0"])]
            m = [mask[:steps].contiguous()] if masked else []
            return (*xs, *ws, *scales, *state, *m)

        def flat(out):
            return [x for o in out
                    for x in (o if isinstance(o, tuple) else (o,))]

        def compare(a):
            got = flat(kern(*a))
            torch.cuda.synchronize()
            want = flat(plain(*a))
            diff = torch.cat([(g - w).abs().flatten()
                              for g, w in zip(got, want)])
            return got, float(diff.max()), float(diff.mean()), float(
                (diff > 1e-5).float().mean())

        _, step_err, _, _ = compare(args(1))
        full = args(T)
        got, err, mean_err, beyond = compare(full)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        masked_nonzero = (sum(int((y[mask == 0] != 0).sum())
                              for y in got[:n_dir]) if masked else 0)
        n = 5 if masked else 20
        with torch.no_grad():
            kernel_ms = time_ms(lambda: kern(*full), n)
            f32_args = args(T, f32=True)
            float_ms = time_ms(lambda: kern_f32(*f32_args), n)
            plain_ms = time_ms(lambda: plain(*full), 1 if masked else 3,
                               warmup=1)
        bound_ms, bound_by, ops, nbytes = int8_layer_bound(
            n_dir, T, B, H, int(lengths.sum()) if masked else None)
        rec = {"phase": "int8_kernel", "name": name, "T": T, "B": B, "H": H,
               "step_max_abs_err": step_err, "step_tol": INT8_STEP_TOL,
               "max_abs_err": err, "tol": INT8_KERNEL_TOL,
               "mean_abs_err": mean_err, "share_beyond_1e-5": beyond,
               "masked_steps_nonzero": masked_nonzero,
               "kernel_ms": kernel_ms, "float_kernel_ms": float_ms,
               "plain_ms": plain_ms, "library_ms": None,
               "library": "none: no single PyTorch call computes a W8A8 "
                          "LSTM scan",
               "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        if masked:
            rec["lengths_min_max_sum"] = [int(lengths.min()),
                                          int(lengths.max()),
                                          int(lengths.sum())]
        emit(rec)
        results.append(rec)
        tag = f"{name} H={H} B={B} T={T}"
        if not finite:
            failures.append(f"{tag}: non-finite output")
        if step_err > INT8_STEP_TOL:
            failures.append(f"{tag}: one step err {step_err} > "
                            f"{INT8_STEP_TOL}")
        if err > INT8_KERNEL_TOL:
            failures.append(f"{tag}: max abs err {err} > {INT8_KERNEL_TOL}")
        if masked_nonzero:
            failures.append(f"{tag}: {masked_nonzero} masked outputs not 0")
    require(not failures, "; ".join(failures))
    return results


def train_bounds(T: int, B: int, H: int, valid_steps: int):
    """Least time (ms) the card needs for kernel #7, for kernel #8 with its
    dW reduction, and for the dW reduction alone, on one layer-direction:
    each input read once, each output written once, the products of this
    run's valid steps at the float32 rate (masked steps need no product,
    but every residual and gradient row is written). Returns {"fwd",
    "bwd", "dw"}, each (bound_ms, bound_by, flops, bytes)."""
    H4 = 4 * H
    seq, hc = T * B * H, B * H
    fwd_flops = 2.0 * valid_steps * H * H4
    fwd_floats = (valid_steps * H4 + H * H4 + 2 * hc + T * B   # x_proj, w, h0c0, mask
                  + seq * 3 + T * B * H4 + 2 * hc)            # ys/h/c seqs, acts, h_T c_T
    bwd_flops = 2 * fwd_flops                                  # dh recurrence + dW
    bwd_floats = (seq + 2 * hc + T * B * H4 + 3 * seq          # dy, dh_T dc_T, acts, c/h_prev/c_prev
                  + H * H4 + T * B                             # w_hh^T, mask
                  + T * B * H4 + H * H4 + 2 * hc)              # dx_proj, dw_hh, dh0 dc0
    dw_floats = seq + T * B * H4 + H * H4                      # h_prev, dgates, dw_hh
    out = {}
    for name, flops, floats in (("fwd", fwd_flops, fwd_floats),
                                ("bwd", bwd_flops, bwd_floats),
                                ("dw", fwd_flops, dw_floats)):
        t_bytes = 4.0 * floats / HBM_BYTES_PER_S
        t_ops = flops / F32_FLOPS_PER_S
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     4 * floats)
    return out


def phase_train_kernels(torch, train_cuda):
    """Kernels #7 and #8 (with the dW kernel) against their plain versions
    at the training shape, T = 125 and B = 256 (a batch of `TrainHypers`),
    at H = 256 and 64, plus a ragged batch edge (B = 37). Nonzero h0/c0,
    random dy/dh_T/dc_T, and a seeded ragged mask with an empty row, a
    full row and rows in between. The plain backward gets the same
    residuals as the kernel (the kernel's forward outputs)."""
    import numpy as np
    results = []
    failures = []
    for H, B in ((256, 256), (64, 256), (256, 37)):
        T = 125
        rng = np.random.RandomState(7 + H + B)

        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).cuda()

        bound = 1.0 / math.sqrt(H)
        x_proj = t(T, B, 4 * H)
        w_hh = torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H))
                                .astype(np.float32)).cuda()
        h0, c0 = t(B, H, scale=0.5), t(B, H, scale=0.5)
        lengths = rng.randint(1, T, size=B)
        lengths[0], lengths[1] = 0, T
        mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None, :]
                ).float().cuda()
        dy, dh_t, dc_t = t(T, B, H), t(B, H), t(B, H)

        fwd_args = (x_proj, w_hh, h0, c0, mask)
        got = train_cuda.lstm_train_fwd(*fwd_args)
        torch.cuda.synchronize()
        want = train_cuda.lstm_train_fwd_plain(*fwd_args)
        names = ("ys", "acts", "hseq", "cseq", "h_T", "c_T")
        fwd_err = {n: float((g - w).abs().max())
                   for n, g, w in zip(names, got, want)}
        masked_nonzero = int((got[0][mask == 0] != 0).sum())
        fwd_finite = all(bool(torch.isfinite(g).all()) for g in got)

        _, acts, hseq, cseq, _, _ = got
        h_prev = torch.cat([h0[None], hseq[:-1]])
        c_prev = torch.cat([c0[None], cseq[:-1]])
        bwd_args = (dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w_hh, mask)
        gb = train_cuda.lstm_train_bwd(*bwd_args)
        torch.cuda.synchronize()
        wb = train_cuda.lstm_train_bwd_plain(*bwd_args)
        dw_scale = float(wb[1].abs().max())
        bwd_err = {n: float((g - w).abs().max())
                   for n, g, w in zip(("dx_proj", "dw_hh", "dh0", "dc0"),
                                      gb, wb)}
        dw_rel = bwd_err["dw_hh"] / dw_scale
        bwd_finite = all(bool(torch.isfinite(g).all()) for g in gb)
        dw_again = train_cuda.lstm_train_bwd(*bwd_args)[1]
        dw_repeatable = bool(torch.equal(dw_again, gb[1]))

        # the dW reduction alone (its share of #8)
        n_slabs, rows = train_cuda._dw_slabs(T * B, H)
        slabs = torch.empty((n_slabs, H, 4 * H), device="cuda")
        dx = gb[0]
        dw_ms = time_ms(lambda: train_cuda._call(
            "lstm_train_dw_f32", h_prev, dx, slabs, T * B, H, n_slabs, rows),
            10)

        # cuDNN yardstick: one full-length layer in training mode (its own
        # input projection included), forward; then its backward
        lstm = torch.nn.LSTM(H, H, num_layers=1).cuda().train()
        x_lib = t(T, B, H).requires_grad_(True)
        hc_lib = (t(1, B, H, scale=0.5), t(1, B, H, scale=0.5))
        lib_fwd_ms = time_ms(lambda: lstm(x_lib, hc_lib), 10)
        y_lib, _ = lstm(x_lib, hc_lib)
        g_lib = torch.randn_like(y_lib)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            y_lib, [x_lib, *lstm.parameters()], g_lib, retain_graph=True),
            10)
        dw_plain_ms = time_ms(
            lambda: train_cuda.lstm_train_dw_plain(h_prev, dx), 1, warmup=1)
        dw_lib_ms = time_ms(lambda: torch.matmul(
            h_prev.reshape(-1, H).t(), dx.reshape(-1, 4 * H)), 10)
        fwd_ms = time_ms(lambda: train_cuda.lstm_train_fwd(*fwd_args), 10)
        bwd_ms = time_ms(lambda: train_cuda.lstm_train_bwd(*bwd_args), 10)
        fwd_plain_ms = time_ms(
            lambda: train_cuda.lstm_train_fwd_plain(*fwd_args), 1, warmup=1)
        bwd_plain_ms = time_ms(
            lambda: train_cuda.lstm_train_bwd_plain(*bwd_args), 1, warmup=1)
        bounds = train_bounds(T, B, H, int(lengths.sum()))
        for name, err, ms, plain_ms, lib_ms, lib, extra in (
                ("lstm_train_fwd_f32", fwd_err, fwd_ms, fwd_plain_ms,
                 lib_fwd_ms, LIB_TRAIN + "forward",
                 {"masked_steps_nonzero": masked_nonzero, "tol": TRAIN_TOL}),
                ("lstm_train_bwd_f32", bwd_err, bwd_ms, bwd_plain_ms,
                 lib_bwd_ms, LIB_TRAIN + "backward (autograd.grad)",
                 {"includes": "the scan, the dW kernel, the slab sum",
                  "dw_hh_max_abs": dw_scale, "dw_hh_rel_err": dw_rel,
                  "tol": TRAIN_TOL, "dw_rel_tol": DW_REL_TOL,
                  "dw_repeatable": dw_repeatable}),
                ("lstm_train_dw_f32", {"dw_hh": bwd_err["dw_hh"]}, dw_ms,
                 dw_plain_ms, dw_lib_ms,
                 "torch.matmul(h_prev^T, dgates) over the T*B rows "
                 "(cuBLAS, TF32 off)",
                 {"dw_hh_rel_err": dw_rel, "dw_rel_tol": DW_REL_TOL,
                  "slabs": [n_slabs, rows],
                  "note": "its time excludes the slab sum"})):
            b_ms, b_by, flops, nbytes = bounds[name.split("_")[2]]
            rec = {"phase": "train_kernel", "name": name, "T": T, "B": B,
                   "H": H, "lengths_min_max_sum": [int(lengths.min()),
                                                   int(lengths.max()),
                                                   int(lengths.sum())],
                   "max_abs_err": err, **extra, "kernel_ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library": lib,
                   "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                   "bytes": nbytes, "pct_of_bound": 100.0 * b_ms / ms}
            emit(rec)
            results.append(rec)
        tag = f"H={H} B={B}"
        if not (fwd_finite and bwd_finite):
            failures.append(f"{tag}: non-finite output")
        if masked_nonzero:
            failures.append(f"{tag}: {masked_nonzero} masked ys not zero")
        if max(fwd_err.values()) > TRAIN_TOL:
            failures.append(f"{tag}: forward err {fwd_err} > {TRAIN_TOL}")
        if max(v for k, v in bwd_err.items() if k != "dw_hh") > TRAIN_TOL:
            failures.append(f"{tag}: backward err {bwd_err} > {TRAIN_TOL}")
        if dw_rel > DW_REL_TOL:
            failures.append(f"{tag}: dw_hh rel err {dw_rel} > {DW_REL_TOL}")
        if not dw_repeatable:
            failures.append(f"{tag}: dw_hh differs between two runs")
    require(not failures, "; ".join(failures))
    return results


def multicell_bound(T: int, B: int, hidden_sizes):
    """Least time (ms) the card needs for one multicell scan: the cells'
    operations and bytes, each counted as `layer_bound` counts one
    direction, summed over the cells. Returns (bound_ms, bound_by, flops,
    bytes)."""
    parts = [layer_bound(1, T, B, H) for H in hidden_sizes]
    flops, nbytes = sum(p[2] for p in parts), sum(p[3] for p in parts)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_multicell(torch, multicell_cuda, lstm_cuda):
    """Kernel #9 against its plain version at the fused path's shapes:
    T = 45, the trio's five cells (`models.fused._ROW_H`), B = 256 windows
    and B = 8; at B = 8 also threaded through chunks of 4 steps. The
    yardstick is the per-module layer kernels on the same five cells (a
    bidirectional launch at H = 256, one at H = 64, a unidirectional one
    at H = 256), timed in turns with the multicell kernel; they should
    give the same numbers, and the difference is printed."""
    import numpy as np
    from mobileposer_tpu_torch.models.fused import _ROW_H
    T, hs = 45, _ROW_H
    offs = [sum(4 * h for h in hs[:i]) for i in range(len(hs))]
    results, failures = [], []
    for B in (256, 8):
        rng = np.random.RandomState(B + 9)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

        x = t(rng.randn(T, B, 4 * sum(hs)))
        ws = [t(rng.uniform(-1 / math.sqrt(H), 1 / math.sqrt(H), (H, 4 * H)))
              for H in hs]
        h0s = [t(np.tanh(rng.randn(B, H))) for H in hs]
        c0s = [t(rng.randn(B, H) * 0.5) for H in hs]
        args = (x, ws, h0s, c0s, hs)

        def flat(out):
            return [v for part in out for v in part]

        def max_err(got, want):
            return max(float((g - w).abs().max()) for g, w in zip(got, want))

        got = flat(multicell_cuda.multicell_lstm(*args))
        torch.cuda.synchronize()
        want = flat(multicell_cuda.multicell_lstm_plain(*args))
        err = max_err(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)

        chunk_err = None
        if B == 8:
            h, c, chunks = h0s, c0s, []
            for t0 in range(0, T, 4):
                ys, h, c = multicell_cuda.multicell_lstm(
                    x[t0:t0 + 4].contiguous(), ws, h, c, hs)
                chunks.append(ys)
            chunked = ([torch.cat([ys[i] for ys in chunks])
                        for i in range(len(hs))] + list(h) + list(c))
            torch.cuda.synchronize()
            chunk_err = max_err(chunked, want)

        xs = [x[..., o:o + 4 * H].contiguous() for o, H in zip(offs, hs)]

        def per_module():
            pf = lstm_cuda.bilstm_layer(xs[0], xs[1], ws[0], ws[1], h0s[0],
                                        c0s[0], h0s[1], c0s[1])
            ff = lstm_cuda.bilstm_layer(xs[2], xs[3], ws[2], ws[3], h0s[2],
                                        c0s[2], h0s[3], c0s[3])
            ys_v, hc_v = lstm_cuda.lstm_layer(xs[4], ws[4], h0s[4], c0s[4])
            return ([pf[0], pf[1], ff[0], ff[1], ys_v]
                    + [pf[2][0], pf[3][0], ff[2][0], ff[3][0], hc_v[0]]
                    + [pf[2][1], pf[3][1], ff[2][1], ff[3][1], hc_v[1]])

        per_module_diff = max_err(per_module(), got)

        # three cuDNN calls on the same cells' widths (input width H, so
        # each also does its input projection): printed, not a yardstick
        nets = [torch.nn.LSTM(H, H, num_layers=1, bidirectional=bi).cuda()
                for H, bi in ((256, True), (64, True), (256, False))]
        lib_in = [(t(rng.randn(T, B, net.hidden_size)),
                   (t(rng.randn(n, B, net.hidden_size) * 0.5),
                    t(rng.randn(n, B, net.hidden_size) * 0.5)))
                  for net, n in zip(nets, (2, 2, 1))]

        def cudnn():
            for net, (xi, hc) in zip(nets, lib_in):
                net(xi, hc)

        with torch.no_grad():
            # the multicell kernel and its yardstick in turns
            times = {"multicell": [], "per_module": []}
            for which in ("multicell", "per_module", "per_module",
                          "multicell"):
                fn = ((lambda: multicell_cuda.multicell_lstm(*args))
                      if which == "multicell" else per_module)
                times[which].append(time_ms(fn, 10))
            cudnn_ms = time_ms(cudnn, 10)
            plain_ms = time_ms(
                lambda: multicell_cuda.multicell_lstm_plain(*args), 3,
                warmup=1)
        kernel_ms = sum(times["multicell"]) / 2
        per_module_ms = sum(times["per_module"]) / 2
        bound_ms, bound_by, flops, nbytes = multicell_bound(T, B, hs)
        rec = {"phase": "multicell_kernel", "name": "multicell_scan_f32",
               "T": T, "B": B, "H": list(hs), "max_abs_err": err,
               "chunked_max_abs_err": chunk_err,
               "per_module_max_abs_diff": per_module_diff, "tol": KERNEL_TOL,
               "kernel_ms": kernel_ms, "kernel_ms_turns": times["multicell"],
               "per_module_kernels_ms": per_module_ms,
               "per_module_ms_turns": times["per_module"],
               "per_module": "bilstm_scan_f32 H=256 + bilstm_scan_f32 H=64 "
                             "+ lstm_scan_f32 H=256, one launch each",
               "plain_ms": plain_ms, "library_ms": None,
               "library": "none: no single PyTorch call computes five LSTM "
                          "cells of different H",
               "cudnn_three_calls_ms": cudnn_ms,
               "cudnn": "torch.nn.LSTM bi H=256 + bi H=64 + uni H=256 "
                        "(cuDNN, TF32 off; each includes its input "
                        "projection)",
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        results.append(rec)
        tag = f"multicell_scan_f32 B={B}"
        if not finite:
            failures.append(f"{tag}: non-finite output")
        for what, e in (("max abs err", err), ("chunked err", chunk_err),
                        ("per-module diff", per_module_diff)):
            if e is not None and e > KERNEL_TOL:
                failures.append(f"{tag}: {what} {e} > {KERNEL_TOL}")
    require(not failures, "; ".join(failures))
    return results


def phase_fused(torch, lstm_cuda, multicell_cuda):
    """The trained fixture through `forward(backend='fused')` on the card,
    B windows of T = 45 frames with a nonzero velocity carry, held to the
    CPU port and to `forward(backend='auto')` on the card; then the
    `lengths` route and int8 params. Returns the launch counts of the
    full-length fused forwards (the main-path run of kernel #9)."""
    import numpy as np
    from mobileposer_tpu_torch.models import MobilePoserNet, forward
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8

    tree = load_npz(FIXTURE)
    params = {d: params_from_jax(tree, device=d) for d in ("cuda", "cpu")}
    body = MobilePoserNet(device="cuda").body_model
    rng = np.random.RandomState(2)
    T = 45

    def counts():
        return {**lstm_cuda.launches, **multicell_cuda.launches}

    def inputs(B, d):
        return (torch.from_numpy(imu[:B]).to(d),
                tuple(torch.from_numpy(a[:, :B]).to(d) for a in hc))

    imu = (rng.randn(256, T, 60) * 0.1).astype(np.float32)
    hc = (np.tanh(rng.randn(2, 256, 256)).astype(np.float32),
          (rng.randn(2, 256, 256) * 0.5).astype(np.float32))
    names = ("pose", "joints", "vel", "contact", "vel_h", "vel_c")
    lstm_cuda.reset_launches()
    multicell_cuda.reset_launches()
    for B in (8, 256):
        x, carry = inputs(B, "cuda")
        before = counts()
        card = forward(params["cuda"], x, body, vel_h0c0=carry,
                       backend="fused")
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in counts().items()}
        expect = dict.fromkeys(moved, 0)
        expect.update(multicell_scan_f32=2, bilstm_scan_f32=2)
        auto = forward(params["cuda"], x, body, vel_h0c0=carry,
                       backend="auto")
        x_cpu, carry_cpu = inputs(B, "cpu")
        cpu = forward(params["cpu"], x_cpu, body, vel_h0c0=carry_cpu,
                      backend="fused")
        card, auto, cpu = ([*o[:4], *o[4]] for o in (card, auto, cpu))
        errs, auto_errs = {}, {}
        for nm, g, a, c in zip(names, card, auto, cpu):
            require(tuple(g.shape) == tuple(c.shape),
                    f"fused B={B} {nm}: shape {tuple(g.shape)} vs "
                    f"{tuple(c.shape)}")
            require(bool(torch.isfinite(g).all()),
                    f"fused B={B} {nm}: non-finite")
            errs[nm] = float((g.cpu() - c).abs().max())
            auto_errs[nm] = float((g - a).abs().max())
        pose = card[0]
        ortho = float((pose @ pose.transpose(-1, -2)
                       - torch.eye(3, device=pose.device)).abs().max())
        emit({"phase": "fused", "B": B, "T": T,
              "max_abs_err_vs_cpu": errs,
              "max_abs_err_vs_auto_on_card": auto_errs, "tol": SLICE_TOL,
              "pose_orthonormal_err": ortho, "launches": moved,
              "expected_launches": expect})
        require(moved == expect,
                f"fused B={B}: launches {moved}, expected {expect}")
        require(max(errs.values()) <= SLICE_TOL,
                f"fused B={B}: card vs CPU max abs err {errs}")
        require(max(auto_errs.values()) <= SLICE_TOL,
                f"fused B={B}: 'fused' vs 'auto' max abs err {auto_errs}")
        require(ortho <= 1e-4, f"fused B={B}: pose not orthonormal "
                               f"({ortho})")
    main_run = counts()

    # with lengths: the per-module masked path, as 'auto' runs it
    x, carry = inputs(8, "cuda")
    lengths = torch.tensor([45, 44, 30, 17, 45, 1, 9, 38])
    before = counts()
    fused_len = forward(params["cuda"], x, body, lengths=lengths,
                        vel_h0c0=carry, backend="fused")
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in counts().items()}
    expect = dict.fromkeys(moved, 0)
    expect.update(bilstm_scan_masked_f32=6, lstm_scan_masked_f32=2)
    auto_len = forward(params["cuda"], x, body, lengths=lengths,
                       vel_h0c0=carry, backend="auto")
    len_err = max(float((g - a).abs().max()) for g, a in
                  zip([*fused_len[:4], *fused_len[4]],
                      [*auto_len[:4], *auto_len[4]]))
    try:
        forward(quantize_params_int8(params["cuda"]), x, body,
                vel_h0c0=carry, backend="fused")
        int8_error = None
    except ValueError as e:
        int8_error = str(e)
    emit({"phase": "fused_lengths_int8", "lengths": lengths.tolist(),
          "launches": moved, "expected_launches": expect,
          "max_abs_diff_vs_auto": len_err, "int8_value_error": int8_error})
    require(moved == expect,
            f"fused with lengths: launches {moved}, expected {expect}")
    require(len_err == 0.0, f"fused with lengths differs from 'auto' by "
                            f"{len_err}")
    require(int8_error is not None, "fused on int8 params did not raise")
    return main_run


def write_eval_sequences(torch, path: Path) -> None:
    """Synthetic sequences in the processed `.pt` schema (reference
    process.py:113-121): smooth local poses from cumulative random twists,
    a random translation walk, small random accelerations and sensor
    orientations, all from a numpy seed."""
    import numpy as np
    from mobileposer_tpu_torch.kinematics.rotation import \
        axis_angle_to_rotation_matrix as aa_to_rot
    rng = np.random.RandomState(5)
    data = {k: [] for k in ("pose", "tran", "acc", "ori")}

    def rot(aa):
        return aa_to_rot(torch.from_numpy(aa.astype(np.float32).reshape(
            -1, 3))).reshape(aa.shape[:-1] + (3, 3))

    for T in EVAL_LENGTHS:
        data["pose"].append(rot(np.cumsum(rng.normal(0, 0.02, (T, 24, 3)),
                                          axis=0)))
        data["tran"].append(torch.from_numpy(np.cumsum(
            rng.normal(0, 0.01, (T, 3)), axis=0).astype(np.float32)))
        data["acc"].append(torch.from_numpy(
            rng.normal(0, 1.0, (T, 6, 3)).astype(np.float32)))
        data["ori"].append(rot(rng.normal(0, 0.3, (T, 6, 3))))
    torch.save(data, path)


def phase_eval(torch, lstm_cuda, int8: bool = False):
    """The evaluation entry point on the card (with `--int8`: on W8A8
    params), held to the CPU port. Returns (the offline pass's launch
    counts, the online pass's, the card's result dict)."""
    import numpy as np
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.evaluation.pose_eval import _BUCKET, _groups

    suffix = "int8" if int8 else "f32"
    n_groups = len(_groups(EVAL_LENGTHS, _BUCKET, 64))
    with tempfile.TemporaryDirectory() as tmp:
        write_eval_sequences(torch, Path(tmp) / "synthetic.pt")
        os.environ["MP_PROCESSED"] = tmp
        argv = ["--model", str(FIXTURE), "--dataset", "synthetic"]
        if int8:
            argv.append("--int8")

        # offline alone: the main-path run the masked counters are read on
        lstm_cuda.reset_launches()
        eval_cli.main(argv)
        torch.cuda.synchronize()
        offline = dict(lstm_cuda.launches)
        expect = dict.fromkeys(lstm_cuda.launches, 0)
        expect[f"bilstm_scan_masked_{suffix}"] = 6 * n_groups
        expect[f"lstm_scan_masked_{suffix}"] = 2 * n_groups
        emit({"phase": "eval_offline_launches", "int8": int8,
              "lengths": EVAL_LENGTHS,
              "bucket_groups": n_groups, "launches": offline,
              "expected_launches": expect})
        require(offline == expect,
                f"offline evaluation launches {offline}, expected {expect}")

        # offline + ONLINE + drift, on the card, then on the CPU
        lstm_cuda.reset_launches()
        t0 = time.perf_counter()
        card = eval_cli.main(argv + ["--online", "--tran"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        both = dict(lstm_cuda.launches)
        t0 = time.perf_counter()
        cpu = eval_cli.main(argv + ["--online", "--tran", "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        del os.environ["MP_PROCESSED"]

    online = {k: both[k] - offline[k] for k in both}
    # ONLINE: each bucket group is one unfolded stream batch (S < 32) of
    # the group's longest sequence + 5 future frames: 6 bi launches per
    # 25-frame chunk, 2 uni launches per frame
    frames = [max(EVAL_LENGTHS[i] + 5 for i in chunk)
              for _, chunk in _groups([n + 5 for n in EVAL_LENGTHS],
                                      _BUCKET, 64)]
    expect_online = dict.fromkeys(lstm_cuda.launches, 0)
    expect_online[f"bilstm_scan_{suffix}"] = sum(6 * -(-n // 25)
                                                 for n in frames)
    expect_online[f"lstm_scan_{suffix}"] = sum(2 * n for n in frames)
    # the tolerance of each table entry: rtol + atol, or for int8 the
    # jitter row's absolute bound (see INT8_EVAL_RTOL)
    rtol = INT8_EVAL_RTOL if int8 else EVAL_RTOL
    drift_rtol = INT8_DRIFT_RTOL if int8 else EVAL_RTOL
    errs = {}
    for k in ("offline", "online"):
        require(card[k].shape == (8, 2) and bool(np.isfinite(card[k]).all()),
                f"{k} table on the card: shape {card[k].shape} or non-finite")
        tol = EVAL_ATOL + rtol * np.abs(cpu[k])
        if int8:
            tol[6] = INT8_JITTER_ATOL
        errs[k] = float(np.max(np.abs(card[k] - cpu[k]) / tol))
    require(card["tran_errors"].keys() == cpu["tran_errors"].keys(),
            f"drift windows {sorted(card['tran_errors'])} vs "
            f"{sorted(cpu['tran_errors'])}")
    errs["tran_errors"] = max(
        [abs(card["tran_errors"][w] - cpu["tran_errors"][w])
         / (EVAL_ATOL + drift_rtol * abs(cpu["tran_errors"][w]))
         for w in cpu["tran_errors"]], default=0.0)
    emit({"phase": "eval", "int8": int8, "lengths": EVAL_LENGTHS,
          "card": {"offline": card["offline"].tolist(),
                   "online": card["online"].tolist(),
                   "tran_errors": card["tran_errors"]},
          "cpu_tran_errors": cpu["tran_errors"],
          "worst_err_over_tol": errs, "rtol": rtol, "atol": EVAL_ATOL,
          "drift_rtol": drift_rtol,
          "jitter_atol": INT8_JITTER_ATOL if int8 else None,
          "card_seconds": card_s, "cpu_seconds": cpu_s,
          "online_launches": online, "expected_online_launches": expect_online,
          "online_frames_per_group": frames})
    require(online == expect_online,
            f"online evaluation launches {online}, expected {expect_online}")
    for k, e in errs.items():
        require(e <= 1.0, f"eval {k} int8={int8}: card vs CPU beyond its "
                          f"tolerance (worst ratio {e})")
    return offline, online, card


def phase_train(torch, lstm_cuda, train_cuda):
    """The training entry point on the card: `cli.train --concurrent
    --fast-dev-run --combine` on synthetic processed data (two steps at
    B = 256, one validation batch, the checkpoints and the combine), the
    combined weights through the evaluation CLI, then one concurrent step
    on the card against the CPU port from identical params, batch and
    draws. Returns the training run's launch counts."""
    import numpy as np
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.cli import train as train_cli
    from mobileposer_tpu_torch.data import PoseDataset
    from mobileposer_tpu_torch.data.fixtures import \
        make_synthetic_processed_dataset
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
    from mobileposer_tpu_torch.train.trainer import (
        MODULE_NAMES, _train_val_split, init_train_state,
        make_multi_train_step, to_device)

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt = Path(tmp) / "processed", Path(tmp) / "ckpt"
        t0 = time.perf_counter()
        make_synthetic_processed_dataset(
            data / "synthetic_train.pt", n_sequences=TRAIN_SEQUENCES[0],
            T=TRAIN_SEQUENCES[1], seed=11, body_model=body, device="cuda")
        synth_s = time.perf_counter() - t0
        os.environ["MP_PROCESSED"] = str(data)
        lstm_cuda.reset_launches()
        train_cuda.reset_launches()
        t0 = time.perf_counter()
        train_cli.main(["--concurrent", "--fast-dev-run", "--combine",
                        "--checkpoint-dir", str(ckpt)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = dict(train_cuda.launches)
        infer_launches = dict(lstm_cuda.launches)
        records = [json.loads(ln) for ln in
                   (ckpt / "metrics.jsonl").read_text().splitlines()]
        combined = ckpt / "base_model.npz"
        require(combined.exists(), "no combined weights written")
        n_ckpts = {m: len(list((ckpt / m).glob("epoch=*.npz")))
                   for m in MODULE_NAMES}

        # the combined weights through the slice-2 evaluation CLI
        (data / "synthetic_train.pt").rename(data / "synthetic.pt")
        table = eval_cli.main(["--model", str(combined), "--dataset",
                               "synthetic"])
        torch.cuda.synchronize()

        # one concurrent step, card vs CPU: identical params (the card
        # states copied from the CPU ones), batch and draws (one CPU
        # generator seeded alike for both runs)
        ds = PoseDataset(fold="train", body_model=body,
                         data_files=[data / "synthetic.pt"], device="cpu")
        _, train_idx, _ = _train_val_split(len(ds), 0, 0.1)
        batch = ds._assemble(train_idx[:STEP_BATCH],
                             C.datasets.window_length)
        del os.environ["MP_PROCESSED"]
    step = make_multi_train_step(body)
    outs = {}
    for dev in ("cpu", "cuda"):
        states = {n: init_train_state(n, torch.Generator().manual_seed(3),
                                      C.train_hypers.lr, dev)
                  for n in MODULE_NAMES}
        t0 = time.perf_counter()
        states, losses = step(states, to_device(batch, dev),
                              torch.Generator().manual_seed(4))
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = (
            {n: float(v) for n, v in losses.items()},
            {n: [p.grad.detach().cpu() for p in states[n].params.parameters()]
             for n in MODULE_NAMES}, time.perf_counter() - t0)
    loss_rel = {n: abs(outs["cuda"][0][n] - outs["cpu"][0][n])
                / abs(outs["cpu"][0][n]) for n in MODULE_NAMES}
    grad_rel = {n: max(float((g - c).abs().max()) / float(c.abs().max())
                       for g, c in zip(outs["cuda"][1][n], outs["cpu"][1][n]))
                for n in MODULE_NAMES}

    n_layer_dirs = sum((2 if cfg.bidirectional else 1) * cfg.n_layers
                       for cfg in MODULE_CONFIGS.values())
    steps = 2
    expect_train = {"lstm_train_fwd_f32": n_layer_dirs * steps,
                    "lstm_train_bwd_f32": n_layer_dirs * steps,
                    "lstm_train_dw_f32": n_layer_dirs * steps}
    # one validation batch on the inference route: the masked kernels,
    # 6 bidirectional layers and 2 velocity layers
    expect_infer = dict.fromkeys(lstm_cuda.launches, 0)
    expect_infer.update(bilstm_scan_masked_f32=6, lstm_scan_masked_f32=2)
    losses_ok = all(math.isfinite(r["train_loss"])
                    and math.isfinite(r["val_loss"]) for r in records)
    emit({"phase": "train", "sequences": list(TRAIN_SEQUENCES),
          "samples": len(ds), "synth_seconds": synth_s,
          "train_cli_seconds": train_s, "records": records,
          "checkpoints": n_ckpts, "train_launches": train_launches,
          "expected_train_launches": expect_train,
          "validation_launches": infer_launches,
          "expected_validation_launches": expect_infer,
          "eval_offline_table": table["offline"].tolist(),
          "step_batch": STEP_BATCH, "step_loss_rel_err": loss_rel,
          "step_loss_rtol": STEP_LOSS_RTOL, "step_grad_rel_err": grad_rel,
          "step_grad_rtol": STEP_GRAD_RTOL,
          "step_losses_card": outs["cuda"][0],
          "step_seconds": {d: outs[d][2] for d in outs}})
    require(len(records) == 4 and losses_ok,
            f"training records {records}: missing or non-finite losses")
    require(all(n == 1 for n in n_ckpts.values()),
            f"checkpoints per module {n_ckpts}, expected 1 each")
    require(train_launches == expect_train,
            f"training launches {train_launches}, expected {expect_train}")
    require(infer_launches == expect_infer,
            f"validation launches {infer_launches}, expected {expect_infer}")
    require(table["offline"].shape == (8, 2)
            and bool(np.isfinite(table["offline"]).all()),
            "evaluation of the trained weights: bad table")
    require(max(loss_rel.values()) <= STEP_LOSS_RTOL,
            f"train step losses card vs CPU: {loss_rel}")
    require(max(grad_rel.values()) <= STEP_GRAD_RTOL,
            f"train step gradients card vs CPU: {grad_rel}")
    return train_launches


def phase_slice(torch, lstm_cuda, int8: bool = False):
    """The trained weights (W8A8-quantized with `int8`, from the same
    float32 weights on each device) through the streaming entry point on
    the card, against the CPU port; returns the launch counts of the
    whole phase."""
    import numpy as np
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8

    tree = load_npz(FIXTURE)
    nets = {d: MobilePoserNet(device=d) for d in ("cuda", "cpu")}
    params = {d: params_from_jax(tree, device=d) for d in ("cuda", "cpu")}
    if int8:
        params = {d: quantize_params_int8(p) for d, p in params.items()}
    suffix, tol = ("int8", INT8_SLICE_TOL) if int8 else ("f32", SLICE_TOL)
    rng = np.random.RandomState(1)
    S = 8
    lstm_cuda.reset_launches()
    for mode, N, chunk in (("scan", 6, 25), ("unfolded", 7, 3)):
        states = {d: nets[d].init_online_state_batched(S) for d in nets}
        for call in ("fresh", "continued"):
            frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
            before = dict(lstm_cuda.launches)
            outs = {}
            for d in ("cuda", "cpu"):
                outs[d], states[d] = nets[d].forward_online_sequence_batched(
                    params[d], states[d], torch.from_numpy(frames).to(d),
                    mode=mode, chunk=chunk)
            torch.cuda.synchronize()
            moved = {k: lstm_cuda.launches[k] - before[k] for k in before}
            n_windows = N if mode == "scan" else -(-N // chunk)
            expect = dict.fromkeys(lstm_cuda.launches, 0)
            expect[f"bilstm_scan_{suffix}"] = 6 * n_windows
            expect[f"lstm_scan_{suffix}"] = 2 * N

            names = ["pose", "joints", "root", "contact"]
            errs = {}
            for nm, g, c in zip(names, outs["cuda"], outs["cpu"]):
                require(tuple(g.shape) == tuple(c.shape),
                        f"{mode} {nm}: shape {tuple(g.shape)} vs {tuple(c.shape)}")
                require(bool(torch.isfinite(g).all()), f"{mode} {nm}: non-finite")
                errs[nm] = float((g.cpu() - c).abs().max())
            for nm, g, c in zip(states["cuda"]._fields, states["cuda"],
                                states["cpu"]):
                errs["state." + nm] = float(
                    (g.cpu().float() - c.float()).abs().max())
            pose = outs["cuda"][0]
            ortho = float((pose @ pose.transpose(-1, -2)
                           - torch.eye(3, device=pose.device)).abs().max())
            emit({"phase": "slice", "int8": int8, "mode": mode,
                  "call": call, "S": S,
                  "N": N, "chunk": chunk if mode == "unfolded" else None,
                  "max_abs_err": errs, "tol": tol,
                  "pose_orthonormal_err": ortho, "launches": moved,
                  "expected_launches": expect})
            require(moved == expect,
                    f"{mode} {call}: launches {moved}, expected {expect}")
            worst = max(errs.values())
            require(worst <= tol,
                    f"{mode} {call} int8={int8}: card vs CPU max abs err "
                    f"{worst} > {tol}")
            require(ortho <= 1e-4, f"{mode} {call}: pose not orthonormal "
                                   f"({ortho})")
    return dict(lstm_cuda.launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mobileposer_tpu_torch
    require(Path(mobileposer_tpu_torch.__file__).resolve().parent.parent
            == ROOT, "mobileposer_tpu_torch was not imported from this "
                     "checkout")
    from mobileposer_tpu_torch import bench
    from mobileposer_tpu_torch.ops import _build, lstm_cuda, multicell_cuda
    from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build (set-up time, not kernel time): one nvcc per source, all
    # started together
    t0 = time.perf_counter()
    sources = ("lstm_scan.cu", "lstm_scan_int8.cu", "lstm_train.cu",
               "multicell_scan.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(_build.build, src) for src in sources]:
            fut.result()
    lstm_cuda.build()
    train_cuda.build()
    multicell_cuda.build()
    ptxas = {}
    for src in sources:
        log = _build.library_path(src).with_suffix(".log")
        ptxas[src] = [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    # 3. each kernel against its plain version
    kernel_recs = phase_kernels(torch, lstm_cuda)
    # 3b. each masked kernel against its plain version
    kernel_recs += phase_masked_kernels(torch, lstm_cuda)
    # 3c. the training kernels against their plain versions
    train_recs = phase_train_kernels(torch, train_cuda)
    # 3d. the int8 kernels against their plain versions
    kernel_recs += phase_int8_kernels(torch, lstm_cuda)
    # 3e. the multicell kernel against its plain version
    kernel_recs += phase_multicell(torch, multicell_cuda, lstm_cuda)

    # 4. the streaming slice on the card, float32 then int8 (their
    # main-path runs: the full-length counters are read on them)
    multicell_cuda.reset_launches()
    stream_launches = phase_slice(torch, lstm_cuda)
    stream_int8_launches = phase_slice(torch, lstm_cuda, int8=True)
    # 4b. the evaluation entry point, float32 then --int8 (their offline
    # runs: the masked counters)
    offline_launches, online_launches, card_f32 = phase_eval(torch,
                                                             lstm_cuda)
    offline_int8_launches, online_int8_launches, card_int8 = phase_eval(
        torch, lstm_cuda, int8=True)
    # int8 against float32 on the card, within the JAX package's bound
    deltas = {k: {row: float(card_int8[k][row, 0] - card_f32[k][row, 0])
                  for row in INT8_DELTA_BOUND} for k in ("offline", "online")}
    emit({"phase": "eval_int8_vs_f32", "deltas": deltas,
          "bounds": INT8_DELTA_BOUND,
          "rows": {0: "SIP Error (deg)", 3: "Positional Error (cm)",
                   6: "Jitter Error (100m/s^3)"}})
    for k, d in deltas.items():
        for row, v in d.items():
            require(abs(v) < INT8_DELTA_BOUND[row],
                    f"{k} int8 - float32 row {row}: {v} beyond "
                    f"{INT8_DELTA_BOUND[row]}")
    # 4c. the training entry point (its run: the training counters)
    train_launches = phase_train(torch, lstm_cuda, train_cuda)
    # the multicell kernel is `forward(backend='fused')`'s alone
    require(multicell_cuda.launches["multicell_scan_f32"] == 0,
            "the streaming, evaluation or training path launched the "
            "multicell kernel")
    # 4d. the fused single-window forward (its run: the multicell counter)
    fused_launches = phase_fused(torch, lstm_cuda, multicell_cuda)
    main_launches = {
        **{k: n for k, n in stream_launches.items() if k.endswith("f32")
           and "masked" not in k},
        **{k: n for k, n in offline_launches.items() if k.endswith("f32")
           and "masked" in k},
        **{k: n for k, n in stream_int8_launches.items()
           if k.endswith("int8") and "masked" not in k},
        **{k: n for k, n in offline_int8_launches.items()
           if k.endswith("int8") and "masked" in k},
        **train_launches,
        "multicell_scan_f32": fused_launches["multicell_scan_f32"]}
    for name, n in main_launches.items():
        require(n > 0, f"{name} was never launched on its main path")

    # 5. exact-path streamed frames/s (tracing off), then one traced call
    for streams in (256, 8):
        rec = bench.run(n_streams=streams, n_frames=100)
        emit({"phase": "rate", **rec})
        require(rec["pct_of_f32_peak"] < 100.0,
                "implied FLOP/s above the card's peak: the harness is wrong")
        trace = bench.breakdown(n_streams=streams, n_frames=100)
        emit({"phase": "breakdown", **trace})
        require(trace["device_busy_seconds"] > 0,
                "the traced call shows no device time")
    # the same on W8A8 params at 256 streams (the JAX bench's exact_int8)
    rec = bench.run(n_streams=256, n_frames=100, mode="scan", int8=True)
    emit({"phase": "rate", **rec})
    require(rec["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    trace = bench.breakdown(n_streams=256, n_frames=100, mode="scan",
                            int8=True)
    emit({"phase": "breakdown", **trace})
    require(any("int8" in g for g in trace["groups"]),
            "the traced int8 call shows no int8 kernel")

    # 5b. offline-evaluation frames/s of one 64 x 512 ragged group
    rec = bench.run_offline(batch=64, bucket=512)
    emit({"phase": "offline_rate", **rec})
    require(rec["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    trace = bench.breakdown_offline(batch=64, bucket=512)
    emit({"phase": "offline_breakdown", **trace})
    require(trace["device_busy_seconds"] > 0,
            "the traced offline call shows no device time")

    # 5c. training frames/s of the concurrent step at B=256, T=125, then
    # one traced step
    rec = bench.run_train(batch=256, window=125)
    emit({"phase": "train_rate", **rec})
    require(rec["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    require(rec["train_kernel_launches_per_step"]
            == {k: n // 2 for k, n in train_launches.items()},
            f"bench step launches {rec['train_kernel_launches_per_step']}")
    trace = bench.breakdown_train(batch=256, window=125)
    emit({"phase": "train_breakdown", **trace})
    require(trace["device_busy_seconds"] > 0,
            "the traced train step shows no device time")

    # 5d. single-window forwards/s at B=256, T=45, 'fused' and 'auto' in
    # turns, then one traced call of each
    for backend in ("fused", "auto", "auto", "fused"):
        rec = bench.run_forward(batch=256, window=45, backend=backend)
        emit({"phase": "forward_rate", **rec})
        require(rec["pct_of_f32_peak"] < 100.0,
                "implied FLOP/s above the card's peak: the harness is wrong")
    for backend in ("fused", "auto"):
        trace = bench.breakdown_forward(batch=256, window=45,
                                        backend=backend)
        emit({"phase": "forward_breakdown", **trace})
        require(trace["device_busy_seconds"] > 0,
                "the traced forward shows no device time")
        has_multicell = any("#9" in g for g in trace["groups"])
        require(has_multicell == (backend == "fused"),
                f"the traced {backend!r} forward: multicell group "
                f"{sorted(trace['groups'])}")

    # 6. kernels line: each kernel's main-path shape (streaming: T=45,
    # H=256, B=256; evaluation: T=512, H=256, B=64; training: T=125,
    # H=256, B=256; fused: T=45, B=256, the trio's five cells); the int8
    # kernels have no library yardstick and carry the float kernel's time
    # at the same shape, the multicell kernel the per-module kernels' time
    ported = []
    for tpu_name, replaces, name in TPU_KERNELS:
        recs = [r for r in kernel_recs + train_recs if r["name"] == name]
        multicell = name == "multicell_scan_f32"
        T, B = ((512, 64) if "masked" in name
                else (125, 256) if "train" in name else (45, 256))
        main = next(r for r in recs if (r["T"], r["B"]) == (T, B)
                    and (multicell or r["H"] == 256))
        source = ("lstm_train.cu" if "train" in name
                  else "lstm_scan_int8.cu" if "int8" in name
                  else "multicell_scan.cu" if multicell
                  else "lstm_scan.cu")
        errs = [max(r["max_abs_err"].values())
                if isinstance(r["max_abs_err"], dict) else r["max_abs_err"]
                for r in recs]
        extra = ({"float_kernel_ms": main["float_kernel_ms"]}
                 if "int8" in name else
                 {"per_module_kernels_ms": main["per_module_kernels_ms"]}
                 if multicell else {})
        ported.append({
            "name": name, "route": "cuda",
            "source": f"mobileposer_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(errs),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], **extra,
            "shape": {"T": T, "B": B, "H": main["H"]}})
    emit({"kernels": ported,
          "online_eval_launches": online_launches,
          "online_eval_int8_launches": online_int8_launches,
          "not_ported": []})

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
