#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's streaming, evaluation and training paths
on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels of `mobileposer_tpu_torch` from this checkout,
then runs these phases, each printing JSON lines:

  1. card    — `nvidia-smi` name and power limit, torch and CUDA versions;
               TF32 is turned off for the whole run;
  2. build   — nvcc time for both sources, built in parallel (set-up,
               not kernel time), and ptxas usage;
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
  4. slice   — the trained fixture weights through
               `forward_online_sequence_batched` on the card in 'scan'
               and 'unfolded' modes, each continued from its final state,
               held to the same calls on the CPU port; the kernels'
               launch counters must move by the expected counts;
  4b. eval   — synthetic sequences written as a processed `.pt`, evaluated
               by the port's CLI (`cli.evaluate.main`) with the trained
               fixture: offline alone on the card (the masked counters
               must move by 6 bi + 2 uni per bucket group, the
               full-length ones not at all), then offline + ONLINE +
               drift on the card and on the CPU, tables compared;
  4c. train  — synthetic training data written with the port's fixture,
               `cli.train --concurrent --fast-dev-run --combine` on the
               card (two steps at B = 256, one validation batch): finite
               losses, the training counters at 14 launches per step, the
               validation batch on the masked kernels only; the combined
               weights through `cli.evaluate`; one concurrent step on the
               card against the CPU port from identical params, batch and
               draws;
  5. rate    — exact-path streamed frames/s (`mobileposer_tpu_torch.bench`)
               at 256 streams (scan) and 8 streams (unfolded), then one
               traced call of each: device time by kernel group and the
               device's busy share;
  5b. offline rate — offline-evaluation valid and padded frames/s of one
               64 x 512 ragged group (`bench.run_offline`), then one
               traced call;
  5c. train rate — training frames/s of the concurrent step at B = 256,
               T = 125 (`bench.run_train`), then one traced step;
  6. kernels — one line with every ported kernel's numbers, and the TPU
               kernels not yet ported.

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

# file:line of each TPU kernel (the `pallas_call` site's function)
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
     None),
    ("lstm_layer_masked_pallas_int8",
     "mobileposer_tpu/ops/lstm_pallas.py:354", None),
    ("bilstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:523",
     None),
    ("_fwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:90",
     "lstm_train_fwd_f32"),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
     "lstm_train_bwd_f32"),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
     "lstm_train_dw_f32"),
    ("multicell_lstm_pallas", "mobileposer_tpu/ops/multicell_pallas.py:83",
     None),
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


def phase_eval(torch, lstm_cuda):
    """The evaluation entry point on the card, held to the CPU port.
    Returns (the offline pass's launch counts, the online pass's)."""
    import numpy as np
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.evaluation.pose_eval import _BUCKET, _groups

    n_groups = len(_groups(EVAL_LENGTHS, _BUCKET, 64))
    with tempfile.TemporaryDirectory() as tmp:
        write_eval_sequences(torch, Path(tmp) / "synthetic.pt")
        os.environ["MP_PROCESSED"] = tmp
        argv = ["--model", str(FIXTURE), "--dataset", "synthetic"]

        # offline alone: the main-path run the masked counters are read on
        lstm_cuda.reset_launches()
        eval_cli.main(argv)
        torch.cuda.synchronize()
        offline = dict(lstm_cuda.launches)
        expect = {"bilstm_scan_f32": 0, "lstm_scan_f32": 0,
                  "bilstm_scan_masked_f32": 6 * n_groups,
                  "lstm_scan_masked_f32": 2 * n_groups}
        emit({"phase": "eval_offline_launches", "lengths": EVAL_LENGTHS,
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
    expect_online = {"bilstm_scan_f32": sum(6 * -(-n // 25) for n in frames),
                     "lstm_scan_f32": sum(2 * n for n in frames),
                     "bilstm_scan_masked_f32": 0, "lstm_scan_masked_f32": 0}
    errs = {}
    for k in ("offline", "online"):
        require(card[k].shape == (8, 2) and bool(np.isfinite(card[k]).all()),
                f"{k} table on the card: shape {card[k].shape} or non-finite")
        errs[k] = float(np.max(np.abs(card[k] - cpu[k])
                               / (EVAL_ATOL + EVAL_RTOL * np.abs(cpu[k]))))
    require(card["tran_errors"].keys() == cpu["tran_errors"].keys(),
            f"drift windows {sorted(card['tran_errors'])} vs "
            f"{sorted(cpu['tran_errors'])}")
    errs["tran_errors"] = max(
        [abs(card["tran_errors"][w] - cpu["tran_errors"][w])
         / (EVAL_ATOL + EVAL_RTOL * abs(cpu["tran_errors"][w]))
         for w in cpu["tran_errors"]], default=0.0)
    emit({"phase": "eval", "lengths": EVAL_LENGTHS,
          "card": {"offline": card["offline"].tolist(),
                   "online": card["online"].tolist(),
                   "tran_errors": card["tran_errors"]},
          "cpu_tran_errors": cpu["tran_errors"],
          "worst_err_over_tol": errs, "rtol": EVAL_RTOL, "atol": EVAL_ATOL,
          "card_seconds": card_s, "cpu_seconds": cpu_s,
          "online_launches": online, "expected_online_launches": expect_online,
          "online_frames_per_group": frames})
    require(online == expect_online,
            f"online evaluation launches {online}, expected {expect_online}")
    for k, e in errs.items():
        require(e <= 1.0, f"eval {k}: card vs CPU beyond rtol {EVAL_RTOL} "
                          f"+ atol {EVAL_ATOL} (worst ratio {e})")
    return offline, online


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
    expect_infer = {"bilstm_scan_f32": 0, "lstm_scan_f32": 0,
                    "bilstm_scan_masked_f32": 6,
                    "lstm_scan_masked_f32": 2}
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


def phase_slice(torch, lstm_cuda):
    """The trained weights through the streaming entry point on the card,
    against the CPU port; returns the launch counts of the whole phase."""
    import numpy as np
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax

    tree = load_npz(FIXTURE)
    nets = {d: MobilePoserNet(device=d) for d in ("cuda", "cpu")}
    params = {d: params_from_jax(tree, device=d) for d in ("cuda", "cpu")}
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
            expect = {"bilstm_scan_f32": 6 * n_windows, "lstm_scan_f32": 2 * N,
                      "bilstm_scan_masked_f32": 0, "lstm_scan_masked_f32": 0}

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
            emit({"phase": "slice", "mode": mode, "call": call, "S": S,
                  "N": N, "chunk": chunk if mode == "unfolded" else None,
                  "max_abs_err": errs, "tol": SLICE_TOL,
                  "pose_orthonormal_err": ortho, "launches": moved,
                  "expected_launches": expect})
            require(moved == expect,
                    f"{mode} {call}: launches {moved}, expected {expect}")
            worst = max(errs.values())
            require(worst <= SLICE_TOL,
                    f"{mode} {call}: card vs CPU max abs err {worst} > "
                    f"{SLICE_TOL}")
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
    from mobileposer_tpu_torch.ops import _build, lstm_cuda
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

    # 2. build (set-up time, not kernel time): one nvcc per source, both
    # started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(_build.build, src)
                    for src in ("lstm_scan.cu", "lstm_train.cu")]:
            fut.result()
    lstm_cuda.build()
    train_cuda.build()
    ptxas = {}
    for src in ("lstm_scan.cu", "lstm_train.cu"):
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

    # 4. the streaming slice on the card (its main-path run: the
    # full-length counters are read on it)
    stream_launches = phase_slice(torch, lstm_cuda)
    # 4b. the evaluation entry point (its offline run: the masked ones)
    offline_launches, online_launches = phase_eval(torch, lstm_cuda)
    # 4c. the training entry point (its run: the training counters)
    train_launches = phase_train(torch, lstm_cuda, train_cuda)
    main_launches = {
        **{k: n for k, n in stream_launches.items() if "masked" not in k},
        **{k: n for k, n in offline_launches.items() if "masked" in k},
        **train_launches}
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

    # 6. kernels line: each kernel's main-path shape (streaming: T=45,
    # H=256, B=256; evaluation: T=512, H=256, B=64; training: T=125,
    # H=256, B=256)
    ported = []
    for tpu_name, replaces, name in TPU_KERNELS:
        if name is None:
            continue
        recs = [r for r in kernel_recs + train_recs if r["name"] == name]
        T, B = ((512, 64) if "masked" in name
                else (125, 256) if "train" in name else (45, 256))
        main = next(r for r in recs
                    if (r["T"], r["B"], r["H"]) == (T, B, 256))
        source = ("lstm_train.cu" if "train" in name else "lstm_scan.cu")
        errs = [max(r["max_abs_err"].values())
                if isinstance(r["max_abs_err"], dict) else r["max_abs_err"]
                for r in recs]
        ported.append({
            "name": name, "route": "cuda",
            "source": f"mobileposer_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(errs),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": {"T": T, "B": B, "H": 256}})
    emit({"kernels": ported,
          "online_eval_launches": online_launches,
          "not_ported": [{"name": n, "replaces": r, "status": "to port"}
                         for n, r, p in TPU_KERNELS if p is None]})

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
