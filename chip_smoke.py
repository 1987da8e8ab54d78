#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's streaming, evaluation, training, fused
single-window and serving paths on one CUDA card, in float32, W8A8,
bfloat16 and W8A8 on bfloat16 params, training on bf16 residuals, the
offline recipe (raw-data processing, finetune, example, overfit), the
live runtime (sensor ingest, calibration, `LivePoser`, `cli.live_demo`),
data parallelism (sharded evaluation and serving, two-rank training) and
the rest of the library (`SequenceLoader`, `RNNWithInit`, the physics
layer, the offline viewers and `cli.render`).

    python3 chip_smoke.py

Builds the CUDA kernels of `mobileposer_tpu_torch` from this checkout,
then runs these phases, each printing JSON lines:

  1. card    — `nvidia-smi` name and power limit, torch and CUDA versions;
               TF32 is turned off for the whole run;
  2. build   — nvcc time for the four sources, built in parallel
               (set-up, not kernel time), and ptxas usage;
  3. kernel  — each full-length kernel against its plain PyTorch version
               at the streaming shapes (f32, nonzero h0/c0), and at B = 1
               and B = 37 with H = 160 (a cluster of five CTAs): max abs
               error, kernel / plain / cuDNN `torch.nn.LSTM` times, the
               card's bound for the same work, and the kernel time PERF.md
               recorded for the same shape (the one-block kernel of
               slice 1); each shape's cluster geometry (rows per cluster,
               clusters, the clusters the card holds, shared memory per
               CTA) and the ptxas report of its instantiation;
  3b. masked — each masked kernel against its plain version at the
               evaluation shapes (T = 512 and 1024, a seeded ragged mask
               with an empty row and a full row; every frame valid, with
               the difference to the full-length kernel; lengths sorted
               so that every cluster ends early): the same numbers, with
               cuDNN on `pack_padded_sequence` as the yardstick, a check
               that every masked step emitted exactly zero, each shape's
               cluster geometry and the ptxas report of its instantiation;
  3c. train kernels — the training forward (#7), the BPTT backward (#8)
               and its dW reduction against their plain versions at
               T = 125, B = 256 (H = 256 and 64) and B = 37 (H = 256 and
               160), a seeded ragged mask: the same numbers, #8's scan
               alone, cuDNN `torch.nn.LSTM` in training mode (forward,
               backward) and `torch.matmul` (dW) as the yardsticks, exact
               zeros at masked steps, dW the same from run to run (its
               tile, slabs, ptxas line and TFLOP/s over all T*B rows
               beside torch.matmul's); each shape's cluster geometry
               (clusters the card holds, CTAs per cluster, rows, shared
               memory per CTA) and the ptxas report of `lstm_train.cu`;
  3d. int8 kernels — the W8A8 scans (#4, #5, #6) against their plain
               versions at the streaming and evaluation shapes: one step
               from h0, the full shape, exact zeros at masked steps; kernel,
               plain and float-kernel times and the bound at the int8 rate
               (no PyTorch call computes a W8A8 scan, so no library time);
               each shape's cluster geometry (the masked entries' from the
               masked instantiation), the ptxas report of its instantiation
               (no stack, no spill) and the kernel time PERF.md recorded
               for the one-block kernel it replaced; for the full-length
               scans (#4, #6) the difference to the masked entry under an
               all-ones mask (exactly 0.0);
  3e. multicell — the multicell scan (#9) against its plain version at
               T = 45, B = 256 and 8, the trio's five cells H = (256, 256,
               64, 64, 256), nonzero h0/c0, and threaded through chunks of
               4 steps; kernel, plain and per-module times (the layer
               kernels on the same five cells, the yardstick: no PyTorch
               call computes cells of different H, so no library time;
               three cuDNN `torch.nn.LSTM` calls printed beside it) and the
               bound summed over the cells; its cluster geometry, the ptxas
               report of its instantiation (no stack, no spill) and its
               difference to the per-module kernels (exactly 0.0: one
               body);
  3f. bf16 kernels — the bf16-I/O entries of #1, #2, #3 and #9 against
               their bf16 plain versions: the full-length scans at the
               streaming shapes, the masked ones at T = 512, B = 64 (exact
               zeros at masked steps), the multicell scan on the trio's
               cells at T = 45, B = 256 (exactly 0.0 from the bf16 layer
               entries on the same cells); one step within 1 bf16 ulp of
               the output's magnitude, the shape within 2; the ptxas
               report of each shape's bf16 instantiation and of every bf16
               instantiation (no stack, no spill); kernel, float32-entry,
               plain and bf16 cuDNN times (or what the card's PyTorch
               refuses) and the bound with bf16 bytes;
  3g. int8 bf16 kernels — the bf16-I/O entries of the W8A8 scans #4, #5
               and #6 against their bf16 plain versions at the main path's
               shapes (#6 at T = 45, B = 256, H = 256 and 64; #4 at B = 256
               and 8; #5 at T = 512, B = 64, bi at H = 256 and 64, uni at
               256, a ragged bf16 mask): within 1 bf16 ulp with at most 1%
               of the outputs differing, exactly 0.0 from the float32 int8
               entry on the same inputs widened, rounded to bf16; no stack
               or spill in any bf16 int8 instantiation; the bf16
               instantiation's residency equal to the float32 one's;
               kernel, float32 int8 entry, float bf16 entry and plain
               times and the bound with bf16 bytes at the int8 rate;
  3h. train bf16res — the bf16-residual entries of #7, #8's scan and #8's
               dW at phase 3c's shapes, inputs and seeds: the forward's
               ys, h_T and c_T equal to the f32 entry's and its acts, hseq
               and cseq to the f32 entry's rounded to bf16, the backward
               on the bf16 residuals equal to the f32 entry on them
               widened (all exactly 0.0); against the plain bf16res
               versions TRAIN_TOL / DW_REL_TOL (the residuals within 1
               bf16 ulp on at most 1%); dW the same from run to run; each
               bf16res instantiation's stack and spills those of its f32
               twin, none in dW; residency equal to the f32 one's; times
               beside the f32 entries', plain, cuDNN training mode and
               `torch.matmul` times, the bound with 2-byte residuals;
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
               then `--online --online-mode carry`, float32 and `--int8`,
               on the card and on the CPU (the ONLINE pass launches no
               LSTM kernel); the CPU evaluations of 4b, 4f and 4g run in
               processes of their own from phase 4 on, joined before 4e;
  4c. train  — synthetic training data written with the port's fixture,
               `cli.train --concurrent --fast-dev-run --combine` on the
               card (two steps at B = 256, one validation batch): finite
               losses, the training counters at 14 launches per step, the
               validation batch on the masked kernels only; then
               `--bf16-residuals` the same way (14 launches of each
               bf16res entry per step, none of the f32 ones); the combined
               weights through `cli.evaluate`; one concurrent step on the
               card against the CPU port from identical params, batch and
               draws, on float32 residuals and on bf16 ones (losses,
               gradients and the updated params each within its argued
               bound);
  4d. fused  — the trained fixture through `forward(backend='fused')` on
               the card at B = 8 and 256 windows of T = 45, held to the CPU
               port and to `forward(backend='auto')` on the card (exactly
               0.0 apart: the multicell kernel runs the layer scans' body);
               exactly 2
               multicell and 2 bidirectional launches per forward, none
               of the unidirectional kernel; with `lengths`, the masked
               kernels (6 bi + 2 uni) and no multicell launch; int8 params
               raise ValueError;
  4e. serving — `PoseServer` on loopback UDP with the full model (random
               weights from seed 0), 64 `PoseClient`s in lockstep for 60
               ticks in four variants (exact and carry, float32 and
               int8), each synchronous and pipelined: replies equal to the
               server's step and post step called directly on the card
               (exactly 0.0), pipelined equal to synchronous (0.0), the
               card's step within 5e-5 of the CPU port's (int8 2e-3: the
               pose on the trained fixture, see `phase_serving`), 6 bi + 2 uni
               layer-kernel launches per exact tick and none in carry
               mode, native UDP in use; then the paced rates at 30 Hz
               (tick and fetch percentiles, sustained tick rate, reply
               rate) of every variant at 64 streams, pipelined and
               synchronous, and of the exact path at 256 streams, float32
               and int8; then `cli.serve` on the card;
  4f. bf16   — the trained fixture cast to bf16 through the streaming
               path on the card ('scan' at S = 256, 'unfolded' at S = 8)
               against the CPU port, bf16 launch counts; 'fused' against
               'auto' in bf16 (exactly 0.0) at B = 8 and 256, 2 multicell
               and 2 bi bf16 launches a forward; `cli.evaluate --bf16` on
               the synthetic sequences, card against CPU (masked bf16
               launches offline, the full-length ones ONLINE); the bf16
               `PoseServer` in lockstep (replies equal to the direct bf16
               step, exactly), exact and carry, its paced 30 Hz runs at 64
               streams, and `cli.serve --bf16` (exact and carry);
  4g. int8 on bf16 params — the trained fixture cast to bf16 and then
               quantized on each device through streaming on the card
               ('scan' and 'unfolded', fresh and continued, then carry
               mode) against the CPU port, the int8 bf16 launch counts;
               `cli.evaluate --int8 --bf16` card against CPU on every
               table entry and drift window (masked int8 bf16 launches
               offline, the full-length ones ONLINE); `PoseServer(bf16
               params, quantize='int8')` in lockstep (replies equal to the
               direct step on the quantized cast, exactly), exact and
               carry, its paced 30 Hz runs at 64 streams, and
               `cli.serve --int8 --bf16` (exact and carry);
  4h. bundle — the AOT serving bundle (`serving.py`: `torch.export` with
               the layer kernels as custom ops) of the full model (random
               weights from seed 0) written to a temporary directory and
               loaded back: exact float32, int8 and bf16 at 256 streams and
               carry at 64 over 10 frames against the eager step on the
               loaded weights (outputs and state, 1e-5; int8 and bf16 at
               phase 4's gates), the loaded step launching the variant's
               kernels as often as the eager step (6 bi + 2 uni a frame,
               none in carry mode); the offline program, float32 and
               int8, on a 64 x 128 ragged group against the eager
               `forward_offline_batched` (6 + 2 masked launches); export +
               save, load and first-step seconds, the steady step loaded
               against eager in turns, the weight archives' sizes (int8
               under 0.45x float32) and the phase's seconds;
  4i. recipe — the offline recipe at full width (the 6,890-vertex body,
               the full model): raw-format fixtures at the public
               datasets' sizes (AMASS 8 x 2,400 frames at 120 Hz, 2 at
               60 Hz, one at 100 Hz that is skipped; DIP-IMU 6 motions of
               3,600 frames with NaN bursts; TotalCapture 2 motions of
               3,600 frames and one without AMASS poses; IMUPoser 2 x
               1,800) through `cli.process` for every dataset (output
               frames/s, peak memory), the first sequence of each again on
               the CPU port and the card's files held to it (pose, ori,
               joint, tran 1e-5, acc 1e-5 of its largest magnitude,
               contact exact outside the threshold band); every processed
               file through `PoseDataset`; a base `cli.train --concurrent
               --fast-dev-run` on the processed AMASS files, then
               `cli.finetune --dataset dip` sequential and `--concurrent`
               (training kernels at 8 layer directions x 2 steps, the
               validation batch on the masked kernels), `--dataset
               imuposer` chained off `finetuned_dip`,
               `combine_weights(finetune='dip')` through `cli.evaluate`
               on dip_test, `cli.example` offline (6 bi + 2 uni launches)
               and `--online` (that per frame) with their frame rates,
               both on the trained fixture's weights held to the CPU port
               at SLICE_TOL (offline the whole sequence, online its first
               240 frames), #1 and #2 against
               their plain versions at the example's offline B = 1
               shapes (its online shapes are the live step's, phase 4j),
               `cli.overfit --module poser` (its loss must fall), and one
               finetune step card against CPU at phase 4c's tolerances
               (losses, gradients and the updated params);
  4j. live   — the live runtime at full width on the trained fixture's
               weights: #1 at (45, 1, 256) and (45, 1, 64) and #2 at
               (45, 1, 256), the live step's shapes, against their plain
               versions (kernel, plain, cuDNN times and the bound); a
               calibration from synthetic body-frame and T-pose holds,
               then 120 recorded raw frames through `LivePoser.step_frame`
               on the card (each step timed, 6 + 2 launches a frame) and
               on the CPU port (SLICE_TOL on pose, joints, tran,
               contact); with a replayer and the sensor frontend
               (`cli.calibration --native`) as processes of their own,
               `cli.live_demo --save` in a third (its session must load
               with the reference's schema), then the loop in this
               process over loopback sockets, calibrated over them, 5 s
               at 30 Hz pipelined and synchronous: frames, output and
               sensor frames/s, step and fetch p50/p99 against 33.3 ms,
               6 + 2 launches a frame, the recording's schema;
  4k. parallel — data parallelism (`parallel/`): #1 and #2 at the
               per-shard shapes of 256 streams over 4 shards (45, 64, H),
               #7 and #8 at a rank's half of a 256 batch (125, 128, H),
               against their plain versions with kernel, plain, library
               times and the bound; the card split into 4 shards (a mesh
               naming cuda:0 four times): phase 4b's fixture and sequences
               through `evaluate_pose(mesh=...)`, float32 and int8, the
               tables and drift windows held to one device's (PARALLEL_TOL;
               int8 at the int8 pins), exactly shards x the per-shard
               launches offline (masked) and ONLINE; the offline pass's
               seconds at C3's group (64 x 512, `bench.run_offline_sharded`)
               on one device and sharded, traced (each card's busy share);
               `PoseServer(mesh=...)`
               at S256 exact float32 and int8 and S64 carry in lockstep
               against the unsharded server (replies PARALLEL_TOL, int8
               INT8_SLICE_TOL, shards x 6 bi + 2 uni launches a tick), a
               synchronous tick of each traced (wall, host, each card's
               busy share), then paced at 30 Hz (tick p50 / p90 / p99,
               ticks/s, reply rate); two ranks on the card over gloo
               (`parallel.spawn`, `bench.run_train_dp`; the ranks load the
               kernels phase 2 built) in one concurrent step at B = 256 x
               125 from the trained fixture's weights under 'gspmd'
               (losses DP_LOSS_RTOL, each gradient tensor DP_GRAD_TOL of
               its largest entry, against the one-process step on the
               whole ragged batch) and 'shard_map' (the mean of the ranks' own losses),
               14 launches of each training kernel per rank, each rank's
               step, all-reduce and peak memory; with more than one card
               the same over every card, the training over NCCL;
  4l. library — the rest of the library on the trained fixture's weights
               and at full width: `SequenceLoader.run_offline` over 1,800
               frames (6 #1 + 2 #2 launches) and `run_online` over 240
               (that per frame), card against the CPU port (SLICE_TOL);
               `RNNWithInit` (velocity's LSTM config, n_init = 72) at
               B = 256, T = 125: the forward on #2 and, with sorted random
               lengths, on #3 against the plain versions (KERNEL_TOL), #8's
               dh0 / dc0 at its layer 0 against the plain version, one
               'auto_train' step (#7, #8) against the CPU port's gradients
               (STEP_GRAD_RTOL, the init MLP's included), each one's ms;
               `DynamicsModel` at 8 seeded states card against CPU (ID, h,
               M 1e-4, kinematics 1e-5, FD 5e-3, relative), ID == M qdd + h
               on the card, each call's ms and device launches;
               `PhysicsOptimizer(dynamics=)` over the 240 online frames card
               against CPU; `SMPLViewer.view` of the online motion, then
               `cli.render --gif` in a process of its own on the card
               (frames, GIF; `load_bundle_joints` card against CPU 1e-5);
  5. rate    — exact-path streamed frames/s (`mobileposer_tpu_torch.bench`)
               at 256 streams (scan; there also on bf16 params, beside the
               float32 rate) and 8 streams (unfolded), then one traced call
               of each: device time by kernel group and the device's busy
               share; then the same at 256 streams on W8A8 params
               (`bench.run(int8=True)`) and on W8A8 on bf16 params
               (`bench.run(int8=True, bf16=True)`, beside the W8A8 and the
               bf16 rates of the same run; its trace shows the bf16 int8
               kernels);
  5b. offline rate — offline-evaluation valid and padded frames/s of one
               64 x 512 ragged group (`bench.run_offline`), then one
               traced call;
  5c. train rate — training frames/s of the concurrent step at B = 256,
               T = 125 (`bench.run_train`), then one traced step; then the
               same on bf16 residuals (C9) beside it, with both steps'
               peak device memory, and one traced bf16res step whose
               training kernels are the bf16res ones;
  5d. forward rate — single-window forwards/s at B = 256, T = 45
               (`bench.run_forward`), 'fused' and 'auto' in turns (fused,
               auto, auto, fused), then one traced call of each;
  6. kernels — one line with every ported kernel's numbers (with
               `parallel_launches`, phase 4k's count, and for #1, #2, #7
               and #8 `per_shard`, their numbers at the per-shard shape);
               no TPU kernel is left to port, one dtype variant is (the
               bf16 I/O of #7 and #8, ROADMAP.md queue B.4).

Any failure raises and exits non-zero before the last line, which is
`{"ok": true, "device": {...}}` only when every phase passed. The script
exits non-zero at once when no CUDA device is present, and when run
outside a checkout of the repository.
"""

from __future__ import annotations

import atexit
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
# Phase 4e: PoseServer with SERVE_STREAMS PoseClients in lockstep for
# SERVE_TICKS ticks (15 past the 45-frame window warm-up), in each
# variant, held to the direct step on the card and on the CPU port (whose
# steps run in processes of their own, `CpuServing`); the paced runs at
# SERVE_STREAMS (and 256): their warm-up and measured window, in seconds
# (3 s windows until phase 4m needed the time).
SERVE_STREAMS = 64
SERVE_TICKS = 60
SERVE_VARIANTS = (("exact", None), ("exact", "int8"), ("carry", None),
                  ("carry", "int8"))
SERVE_WARMUP_S = 0.5
SERVE_SECONDS = 1.5

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
# Phase 3h: the bf16res forward's residuals against the plain bf16res
# version's. The float32 values they round differ by the float32 rounding
# of TRAIN_TOL; where one lands on the other side of a bf16 rounding
# boundary the two stored values are one bf16 ulp apart, so at most 1 ulp
# of the residual's largest magnitude, on at most 1% of the values (PR
# 13's rule for the bf16 int8 entries, INT8_BF16_ULPS).
BF16RES_ULPS = 1
BF16RES_DIFFER_SHARE = 0.01
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
# The same step on bf16 residuals ('auto_train_bf16res'). The losses:
# STEP_LOSS_RTOL, since the forward's outputs do not depend on the
# residual dtype. The gradients: each stored residual is the bf16 rounding
# of a float32 value that the card and the CPU compute alike to about 1e-6
# (the float32 step meets STEP_GRAD_RTOL with ~1e-6 to spare); where the
# two land on opposite sides of a bf16 rounding boundary the stored values
# are one bf16 ulp apart, at most 2^-7 of the value. To first order the
# backward is linear in each residual's error, and each parameter
# gradient entry is a sum over the batch's rows, steps and gates of terms
# that each depend on one step's residuals (through the recurrence too,
# which the forget gates shrink), so one such flip moves an entry by at
# most 2^-7 of the terms it touches, under 2^-7 of the tensor's largest
# entry; the float32 differences add STEP_GRAD_RTOL. The updated params:
# one step of Adam (AdamW for joints) from fresh moments moves an entry by
# lr * g / (|g| + eps), about +-lr, so where |g| exceeds the gradient
# bound times the tensor's largest |g| both devices move it the same way,
# equal to float32 rounding of the params (STEP_PARAM_ATOL); any other
# entry may move the other way, at most 2 * lr apart. Phase 4i holds its
# float32 finetune step's update by the same rule with STEP_GRAD_RTOL as
# the gradient bound.
STEP_BF16RES_GRAD_RTOL = 2.0 ** -7 + STEP_GRAD_RTOL
STEP_PARAM_ATOL = 1e-6
# Phase 4b's sequence lengths: bucket 512 holds two ragged sequences,
# 520 frames takes a 1024 bucket of its own ((300, 420, 560) until phase
# 4m needed the time: the CPU port's evaluations, carry mode on the card
# and phase 4k's sharded evaluation take time in proportion).
EVAL_LENGTHS = (150, 210, 520)
# Phase 4i: raw-format fixtures at the sizes of the public datasets, each
# made with numpy from a seed. AMASS: (sequences, frames, mocap Hz) of one
# dataset folder, the 100 Hz sequence skipped by the processor; DIP-IMU:
# frames at 60 Hz of each motion (two per subject), a 3-frame NaN burst
# in each; TotalCapture: frames of each motion (two with AMASS poses, one
# without); IMUPoser: frames of the one sequence of P1 and of P9.
RAW_AMASS = ((8, 2400, 120), (2, 2400, 60), (1, 2400, 100))
RAW_DIP_FRAMES = 3600
RAW_TC_FRAMES = 3600
RAW_IMUPOSER_FRAMES = 1800
# Phase 4i: processed files, card against the CPU port. pose, ori, joint,
# tran within PROCESS_ATOL; acc, second differences of vertex positions
# times fps^2 = 900, within PROCESS_ACC_RTOL of its largest magnitude;
# contact exact on every frame whose foot displacement is more than
# CONTACT_BAND from the 0.008 threshold (the CPU tests' tolerances).
PROCESS_ATOL = 1e-5
PROCESS_ACC_RTOL = 1e-5
CONTACT_BAND = 1e-6
# Phase 4i's overfit run: steps of one repeated batch of poser windows.
OVERFIT_STEPS = 30
# Phase 4i's `cli.example` on the card against the CPU port, on the
# trained fixture's weights (FIXTURE) and the processed dip_test file:
# offline over the whole sequence, online over its first
# EXAMPLE_ONLINE_CPU_FRAMES frames (the CPU's plain scans take ~50 ms a
# frame, so all 1,794 would take ~90 s; the online path is causal, so the
# card's first frames are those of a run this long; 240 until the script
# needed the time for phase 4m), both at SLICE_TOL.
# Not on the finetuned weights the recipe's example runs on: two steps
# from a random init leave the poser's r6d outputs ~0.01 long and near
# parallel, and the Gram-Schmidt decode divides by those lengths, so
# differences in r6d near float32 rounding reach ~1e-4 in the pose
# (1.3e-4 card against CPU on an H100; tran 1.9e-6), where the trained
# weights' r6d (lengths >= 0.2) passes them on about as it gets them. The
# scan kernels are also held to their plain versions at the example's
# offline shapes, B = 1 and T = the sequence; online it runs
# `forward_online`, the live step, whose shapes phase 4j holds and times.
EXAMPLE_ONLINE_CPU_FRAMES = 120
# Phase 4k, data parallelism: the card split into PARALLEL_SHARDS shards
# (a mesh naming cuda:0 that many times; with more than one card, every
# card as well). Sharded tables and float32 replies are held to one
# device's at PARALLEL_TOL. int8 ones at the int8 pins above: cuBLAS may
# pick another kernel for the float input projection at a quarter of the
# rows, and a last bit there can move a re-quantized h by an int8 level
# (a flip), as on the CPU (tests/test_torch_parallel_serve.py).
# PARALLEL_SERVE: (mode, streams, quantize) of the sharded server, in
# lockstep for PARALLEL_SERVE_TICKS ticks, then paced at 30 Hz. Training:
# two ranks on one card over gloo (NCCL refuses two ranks on one card),
# and one rank per card over NCCL when there are several, one concurrent
# step at B = 256 x 125 on a ragged batch under each rule; 'gspmd' held
# to the one-process step on the whole batch: losses at DP_LOSS_RTOL,
# each gradient tensor relative to its largest entry at DP_GRAD_TOL (the
# same step summed in another order: dW and the weight products over a
# rank's rows, then the sum of the ranks'; 2.5e-6 on an H100 80GB HBM3 at
# 700 W). The states are the trained fixture's: at random weights the
# r6d decode of the poser's position loss divides by r6d lengths near 0
# and magnifies that rounding, as it does card against CPU:
# poser.linear1's gradient came out 1.57e-4 of its largest entry there
# (normwise 1.2e-4, the same card). 'shard_map' is held to the mean of the
# ranks' own losses (DP_MEAN_RTOL: one float32 division).
PARALLEL_SHARDS = 4
PARALLEL_TOL = 1e-4
PARALLEL_SERVE = (("exact", 256, None), ("exact", 256, "int8"),
                  ("carry", 64, None))
PARALLEL_SERVE_TICKS = 6
DP_LOSS_RTOL = 1e-5
DP_GRAD_TOL = 1e-5
DP_MEAN_RTOL = 1e-6
# Phase 4j, the live runtime: the single-stream step's layer shapes (#1 at
# H = 256 and 64, #2 at 256, over the 45-frame window of one stream);
# LIVE_FRAMES recorded raw frames through `LivePoser.step_frame` card
# against CPU port (SLICE_TOL; the trained fixture's weights, see
# EXAMPLE_ONLINE_CPU_FRAMES' note); the loopback loop of LIVE_SECONDS at
# LIVE_FPS, pipelined then synchronous, after LIVE_CALIBRATE_S of each
# socket calibration step; `cli.live_demo` for LIVE_CLI_SECONDS in a
# process of its own. LIVE_BUDGET_MS is a 30 Hz frame.
LIVE_SHAPES = ((True, 45, 1, 256), (True, 45, 1, 64), (False, 45, 1, 256))
LIVE_FRAMES = 120
LIVE_SECONDS = 5.0
LIVE_FPS = 30
LIVE_CALIBRATE_S = 0.5
LIVE_CLI_SECONDS = 3.0
LIVE_BUDGET_MS = 1000.0 / 30
# The full-length kernels' times at T=45, H=256, B=256 recorded in
# PERF.md section 6 for slice 1's one-block kernel, printed beside this
# run's.
# Phase 4l, the rest of the library: SequenceLoader over
# LIB_OFFLINE_FRAMES offline and the first LIB_ONLINE_FRAMES online;
# RNNWithInit at C4's batch and window; DynamicsModel at LIB_DYN_STATES
# seeded states; cli.render every LIB_RENDER_STRIDE-th frame.
LIB_OFFLINE_FRAMES = 1800
LIB_ONLINE_FRAMES = 240
LIB_RWI_BATCH = 256
LIB_RWI_WINDOW = 125
LIB_DYN_STATES = 8
LIB_RENDER_STRIDE = 10
PERF_MD_MS = {"bilstm_scan_f32": 1.307, "lstm_scan_f32": 1.311}
# The int8 kernels' times by (name, H, B) recorded in PERF.md for slice
# 4's one-block kernels (T = 45 full-length, T = 512 and 1024 masked),
# printed beside this run's.
PERF_MD_INT8_MS = {("bilstm_scan_int8", 256, 256): 1.135,
                   ("bilstm_scan_int8", 64, 256): 0.327,
                   ("bilstm_scan_int8", 256, 200): 1.126,
                   ("bilstm_scan_int8", 64, 200): 0.320,
                   ("lstm_scan_int8", 256, 256): 1.127,
                   ("lstm_scan_int8", 256, 8): 0.929,
                   ("bilstm_scan_masked_int8", 256, 64): 9.817,
                   ("bilstm_scan_masked_int8", 64, 64): 4.458,
                   ("lstm_scan_masked_int8", 256, 64): 9.672,
                   ("bilstm_scan_masked_int8", 256, 37): 19.43}
# The multicell kernel's times by B (T = 45, the trio's cells) recorded in
# PERF.md for slice 5's one-block kernel, printed beside this run's.
PERF_MD_MULTICELL_MS = {256: 1.432, 8: 1.275}

HBM_BYTES_PER_S = 3.35e12    # H100 SXM
F32_FLOPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM, bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12     # H100 SXM, int8 tensor cores, dense


def float_peak(elem_bytes: int) -> float:
    """The card's peak rate for products of the I/O dtype: the bf16
    tensor cores' for 2-byte I/O, float32's outside them for 4."""
    return BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S

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
# The int8-on-bf16 slice on the card against the CPU port: the int8 flips
# above (INT8_SLICE_TOL) and bf16's own, whole bf16 ulps of outputs of
# magnitude up to ~1 where a last float32 bit lands a value on the other
# side of a rounding boundary. Phase 4f measured two such ulps at 1
# (1.6e-2 on pose, measured on one H100); an int8 flip moves a value by
# up to INT8_SLICE_TOL before the rounding and can add a third.
INT8_BF16_SLICE_TOL = INT8_SLICE_TOL + 3 * 2.0 ** -7
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

# Phase 3f: the bf16-I/O entries against their bf16 plain versions, in
# bf16 ulps of the output's largest magnitude, 2^(floor(log2 max|x|) - 7).
# Both sides compute the same float32 products (a product of two bf16
# values is exact in float32) and differ only in the order of the float32
# sums and in the last bits of expf/tanhf, which moves a bf16 output by
# one ulp where it lands on a rounding boundary: one step from h0, 1 ulp.
# Over the shape such a flip of h moves the next gates by one ulp of h
# times a weight (|w| <= 1/16 at H = 256), far below an ulp, and the cell
# forgets it: 2 ulps over T = 45 and 512 steps.
BF16_STEP_ULPS = 1
BF16_ULPS = 2
# Phase 3i: the wbf16 backward's float32 outputs against the plain
# version, relative L2 over each. Both take the same products; the order
# of the float32 sums differs, and a last bit now and then flips a dgate's
# bf16 rounding for the dh product, which the scan carries on: a flip moves
# single entries as far as leaving the rounding out does, so no max-norm
# bound can tell the two apart, while over a whole output the flips stay
# far below the rounding's own share. On the CPU at phase 3c's shapes a
# float64 dh product in place of the float32 one (another order) moved
# dx_proj, dh0 and dc0 by at most 2.2e-5, 6.8e-5 and 2.0e-5; leaving the
# dgates rounding out (the f32 entry on the widened w_hh, which must fail
# these bounds) moved them by 2.1e-4, 1.07e-3 and 2.1e-4 or more.
WBF16_REL_L2 = {"dx_proj": 1e-4, "dh0": 4e-4, "dc0": 1e-4}
# Phase 4f: the bf16 slice on the card against the CPU port (both bf16,
# the kernels against their plain versions at a flip per layer at most),
# on every output, all of magnitude ~1: the JAX package's own bf16 bound
# on joints (tests/test_extras.py:87-101).
BF16_SLICE_TOL = 0.05
# The bundle phase: the loaded program against the eager step on the same
# weights, state and frames. The graph keeps the eager path's ops
# (`aten.linear`, the same custom ops' kernels), so 0.0 is expected; the
# float32 gate is a kernel's (KERNEL_TOL), int8 and bf16 take phase 4's
# gates. BUNDLE_FRAMES frames a streaming variant, each timed over
# BUNDLE_TIMED_STEPS steps a turn.
# Phase 5's streamed frames per call and chained trials (the cells C1,
# C2, C5, C7, C8 are timed at 100 frames and 5 trials by `bench_turns`;
# so here too until phase 4m needed the time).
RATE_FRAMES = 50
RATE_TRIALS = 3
BUNDLE_TOL = 1e-5
BUNDLE_FRAMES = 10
BUNDLE_TIMED_STEPS = 20
# The offline bundles' group: 64 rows of a 128-frame bucket (C3's 64 x
# 512 until phase 4l was added: the export unrolls the fusion loop per
# frame, and each 512-frame export took 36 to 83 s of the script's limit).
BUNDLE_OFFLINE_GROUP = (64, 128)
BUNDLE_VARIANTS = (("exact", 256, "float32", None, BUNDLE_TOL),
                   ("exact", 256, "float32", "int8", INT8_SLICE_TOL),
                   ("exact", 256, "bfloat16", None, BF16_SLICE_TOL),
                   ("carry", 64, "float32", None, BUNDLE_TOL))
# Phase 4f's bf16 evaluation, card against the CPU port (both bf16), on
# every entry of both tables and every drift window: absolute bounds a
# few times the largest difference measured on the synthetic fixture
# (NVIDIA H100 80GB HBM3, 700 W: 0.0020 on the rows in degrees and cm,
# 0.0171 on jitter, 2e-5 m on the drift windows). Jitter, a third
# difference of positions, amplifies a bf16 flip the most.
BF16_EVAL_ATOL = 0.01
BF16_JITTER_ATOL = 0.06
BF16_DRIFT_ATOL = 1e-4
# Phase 3g: the bf16-I/O int8 entries against their bf16 plain versions.
# The card's kernel and the plain version on the card compute the same
# exact int32 sums with the same roundings and the same expf/tanhf (the
# float32 int8 entries meet their plain versions at 0.0 on an H100 at
# 700 W), so the outputs should agree to the bit; where a last float32
# bit did differ, it moves a bf16 output by one ulp only on a rounding
# boundary: at most 1 ulp of the output's largest magnitude, on at most
# 1% of the outputs (the bound the CPU tests hold the plain versions to
# against the Pallas kernels; quantizing h rounded to bf16, the float
# body's product and not the int8 one's, differs on ~19% of them).
INT8_BF16_ULPS = 1
INT8_BF16_DIFFER_SHARE = 0.01

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
    # the bf16-I/O variants of the float TPU kernels (their I/O dtype is
    # the inputs', lstm_pallas.py:51-69, multicell_pallas.py:52-78)
    ("bilstm_layer_pallas", "mobileposer_tpu/ops/lstm_pallas.py:264",
     "bilstm_scan_bf16"),
    ("lstm_layer_pallas", "mobileposer_tpu/ops/lstm_pallas.py:73",
     "lstm_scan_bf16"),
    ("lstm_layer_masked_pallas", "mobileposer_tpu/ops/lstm_pallas.py:163",
     "bilstm_scan_masked_bf16"),
    ("lstm_layer_masked_pallas", "mobileposer_tpu/ops/lstm_pallas.py:163",
     "lstm_scan_masked_bf16"),
    ("multicell_lstm_pallas", "mobileposer_tpu/ops/multicell_pallas.py:83",
     "multicell_scan_bf16"),
    # the bf16-I/O variants of the W8A8 TPU kernels (int8 on bf16 params:
    # x_proj, state, mask and outputs in bf16, the carry float32,
    # lstm_pallas.py:318-337)
    ("lstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:434",
     "lstm_scan_int8_bf16"),
    ("lstm_layer_masked_pallas_int8",
     "mobileposer_tpu/ops/lstm_pallas.py:354",
     "bilstm_scan_masked_int8_bf16"),
    ("lstm_layer_masked_pallas_int8",
     "mobileposer_tpu/ops/lstm_pallas.py:354", "lstm_scan_masked_int8_bf16"),
    ("bilstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:523",
     "bilstm_scan_int8_bf16"),
    # the residual_dtype=bfloat16 variant of the training kernels
    # (lstm_train_pallas.py:79-82, :153-163)
    ("_fwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:90",
     "lstm_train_fwd_bf16res"),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
     "lstm_train_bwd_bf16res"),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
     "lstm_train_dw_bf16res"),
    # the training kernels on bf16 params (their I/O dtype is x_proj's
    # and dy's, lstm_train_pallas.py:63-64, :188-190): bf16 I/O, and the
    # backward of float32 I/O beside bf16 w_hh (a float32 batch promoted
    # over bf16 weights, whose forward is the f32 entry's on the widened
    # w_hh), each with float32 or bf16 residuals; the dW entries above
    # serve them
    *((tpu, f"mobileposer_tpu/ops/lstm_train_pallas.py:{line}",
       f"lstm_train_{kind}_{suffix}")
      for suffix in ("bf16", "bf16_bf16res")
      for tpu, line, kind in (("_fwd_call", 90, "fwd"),
                              ("_bwd_call", 202, "bwd"))),
    *(("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202",
       f"lstm_train_bwd_{suffix}") for suffix in ("wbf16", "wbf16_bf16res")),
]

# the command time each phase takes: the span from one mark to the next,
# labelled by the later one
MARKS = []


def mark(label: str) -> None:
    MARKS.append((label, time.perf_counter()))
    if len(MARKS) > 1:
        emit({"phase": "mark", "label": label,
              "seconds": MARKS[-1][1] - MARKS[-2][1],
              "since_start": MARKS[-1][1] - MARKS[0][1]})


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


def layer_bound(n_dir: int, T: int, B: int, H: int, valid_steps=None,
                elem_bytes: int = 4):
    """Least time (ms) the card needs for one layer scan: each input read
    once, each output written once, the recurrent products at the I/O
    dtype's peak rate (`float_peak`). With `valid_steps` (the sum of a
    ragged batch's lengths) only the valid steps need their products and their x_proj
    rows, and the [T, B] mask is read once. `elem_bytes` is the I/O
    dtype's size: 4 for float32, 2 for bf16 (the same operations at the
    bf16 rate, half the bytes). Returns (bound_ms, bound_by, flops, bytes)."""
    steps = T * B if valid_steps is None else valid_steps
    flops = n_dir * steps * 2.0 * H * 4 * H
    floats = n_dir * (steps * 4 * H      # x_proj
                      + H * 4 * H        # w_hh
                      + 2 * B * H        # h0, c0
                      + T * B * H        # ys
                      + 2 * B * H)       # h_T, c_T
    if valid_steps is not None:
        floats += T * B                  # mask, shared by the directions
    t_bytes = elem_bytes * floats / HBM_BYTES_PER_S
    t_ops = flops / float_peak(elem_bytes)
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", flops,
            elem_bytes * floats)


def ptxas_by_function(source: str, needle: str, bf16=False):
    """The ptxas report (registers, stack, spills) of each function of
    `source`'s build whose mangled name holds `needle`, of the float32
    instantiations or, with `bf16`, of the bf16-I/O ones (with None, of
    all): {name: [lines]}."""
    from mobileposer_tpu_torch.ops import _build
    log = _build.library_path(source).with_suffix(".log").read_text()
    out, fn = {}, None
    for ln in log.splitlines():
        for key in ("Compiling entry function '", "Function properties for "):
            if key in ln:
                fn = ln.split(key, 1)[1].split("'", 1)[0].strip()
        if (fn and needle in fn
                and (bf16 is None or ("bfloat16" in fn) == bf16)
                and ("registers" in ln or "spill" in ln)):
            out.setdefault(fn, []).append(ln.strip())
    return out


def _scan_case(torch, lstm_cuda, rng, bi: bool, T: int, B: int, H: int):
    """(kernel, plain version, arguments) of the full-length scan #1
    (`bi`) or #2 at [T, B, H] on inputs drawn from `rng`: projections
    N(0, 1), w_hh U(+-1/sqrt(H)), h0 and c0 N(0, 0.25)."""
    import numpy as np

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).cuda()

    bound = 1.0 / math.sqrt(H)
    dirs = [(t(T, B, 4 * H),
             torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H))
                              .astype(np.float32)).cuda(),
             t(B, H, scale=0.5), t(B, H, scale=0.5))
            for _ in range(2 if bi else 1)]
    if bi:
        (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = dirs
        return (lstm_cuda.bilstm_layer, lstm_cuda.bilstm_layer_plain,
                (xf, xb, wf, wb, h0f, c0f, h0b, c0b))
    return lstm_cuda.lstm_layer, lstm_cuda.lstm_layer_plain, dirs[0]


def _scan_vs_plain(torch, kern, plain, args):
    """(max abs error of every output of `kern` against `plain` on
    `args`, whether the kernel's outputs are finite)."""
    def flat(out):
        return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]

    got = flat(kern(*args))
    torch.cuda.synchronize()
    want = flat(plain(*args))
    return (max(float((g - w).abs().max()) for g, w in zip(got, want)),
            all(bool(torch.isfinite(g).all()) for g in got))


def phase_kernels(torch, lstm_cuda, cases=None):
    """Each kernel vs its plain version at the streaming path's shapes:
    B=256 is the scan mode at 256 streams, B=200 the unfolded mode's
    chunk of 25 windows x 8 streams, B=8 its velocity layers (and ONLINE
    evaluation's under 32 streams); then B=1 and an odd B=37 at H=160,
    a cluster of five CTAs. `cases` ((name, H, B), ...) replaces them
    (phase 4k's per-shard shapes)."""
    import numpy as np
    T = 45
    cases = cases or [
        ("bilstm_scan_f32", 256, 256), ("bilstm_scan_f32", 64, 256),
        ("lstm_scan_f32", 256, 256), ("bilstm_scan_f32", 256, 200),
        ("bilstm_scan_f32", 64, 200), ("lstm_scan_f32", 256, 8),
        ("lstm_scan_f32", 160, 1), ("bilstm_scan_f32", 160, 37)]
    results = []
    for name, H, B in cases:
        bi = name == "bilstm_scan_f32"
        n_dir = 2 if bi else 1
        geo = lstm_cuda.scan_geometry(n_dir, B, H, torch.device("cuda", 0))
        held = lstm_cuda.max_active_clusters(H, geo.rows, 0)
        emit({"phase": "scan_geometry", "name": name, "T": T, "B": B,
              "H": H, "rows_per_cluster": geo.rows,
              "rows_per_lane": geo.lane_rows,
              "cols_per_lane": geo.lane_cols, "clusters": geo.clusters,
              "ctas_per_cluster": geo.cluster,
              "max_active_clusters": held,
              "waves": math.ceil(geo.clusters / held),
              "smem_per_cta": geo.smem,
              "ptxas": ptxas_by_function(
                  "lstm_scan.cu",
                  f"lstm_scan_kernelILi{geo.lane_rows}ELi{geo.lane_cols}E")})
        rng = np.random.RandomState(H + B)

        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).cuda()

        kern, plain, args = _scan_case(torch, lstm_cuda, rng, bi, T, B, H)
        err, finite = _scan_vs_plain(torch, kern, plain, args)

        lstm = torch.nn.LSTM(H, H, num_layers=1, bidirectional=bi).cuda()
        x_lib = t(T, B, H)
        hc_lib = (t(n_dir, B, H, scale=0.5), t(n_dir, B, H, scale=0.5))
        with torch.no_grad():
            library_ms = time_ms(lambda: lstm(x_lib, hc_lib), 20)
            kernel_ms = time_ms(lambda: kern(*args), 20)
            plain_ms = time_ms(lambda: plain(*args), 3, warmup=1)
        bound_ms, bound_by, flops, nbytes = layer_bound(n_dir, T, B, H)
        rec = {"phase": "kernel", "name": name, "T": T, "B": B, "H": H,
               "rows_per_cluster": geo.rows, "clusters": geo.clusters,
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
    seed, with an empty row and a full row ('ragged'). Two more cases:
    'all ones', every frame valid, where the masked kernel must give the
    full-length kernel's outputs (its difference to them is printed), and
    'sorted', lengths in [T/4, 0.7 T] sorted so that each cluster's rows
    end together and every cluster ends before T. Each shape prints its
    cluster geometry and the ptxas report of its masked instantiation."""
    import numpy as np
    from torch.nn.utils.rnn import pack_padded_sequence
    cases = [("bilstm_scan_masked_f32", 256, 64, 512, "ragged"),
             ("bilstm_scan_masked_f32", 64, 64, 512, "ragged"),
             ("lstm_scan_masked_f32", 256, 64, 512, "ragged"),
             ("bilstm_scan_masked_f32", 256, 37, 1024, "ragged"),
             ("bilstm_scan_masked_f32", 256, 64, 512, "all ones"),
             ("bilstm_scan_masked_f32", 256, 37, 1024, "sorted")]
    results = []
    for name, H, B, T, case in cases:
        bi = name == "bilstm_scan_masked_f32"
        n_dir = 2 if bi else 1
        geo = lstm_cuda.scan_geometry(n_dir, B, H, torch.device("cuda", 0),
                                      masked=True)
        held = lstm_cuda.max_active_clusters(H, geo.rows, 0, masked=True)
        emit({"phase": "masked_scan_geometry", "name": name, "T": T, "B": B,
              "H": H, "case": case, "rows_per_cluster": geo.rows,
              "rows_per_lane": geo.lane_rows,
              "cols_per_lane": geo.lane_cols, "clusters": geo.clusters,
              "ctas_per_cluster": geo.cluster,
              "max_active_clusters": held,
              "waves": math.ceil(geo.clusters / held),
              "smem_per_cta": geo.smem,
              "ptxas": ptxas_by_function(
                  "lstm_scan.cu", f"lstm_scan_masked_kernelILi{geo.lane_rows}"
                                  f"ELi{geo.lane_cols}E")})
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
        if case == "ragged":
            lengths = rng.randint(1, T, size=B)
            lengths[0], lengths[1] = 0, T
        elif case == "all ones":
            lengths = np.full(B, T)
        else:
            lengths = np.sort(rng.randint(T // 4, int(0.7 * T) + 1,
                                          size=B))[::-1].copy()
        mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None, :]
                ).float().cuda()
        # the steps each cluster runs: its rows' longest length
        tile_steps = [int(lengths[b:b + geo.rows].max())
                      for b in range(0, B, geo.rows)]
        if bi:
            (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = dirs
            args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b, mask)
            kern = lstm_cuda.bilstm_layer_masked
            plain = lstm_cuda.bilstm_layer_masked_plain
            full = lstm_cuda.bilstm_layer
        else:
            args = dirs[0] + (mask,)
            kern = lstm_cuda.lstm_layer_masked
            plain = lstm_cuda.lstm_layer_masked_plain
            full = lstm_cuda.lstm_layer

        def flat(out):
            return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]

        got = flat(kern(*args))
        torch.cuda.synchronize()
        want = flat(plain(*args))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ys = got[:n_dir]
        masked_nonzero = sum(int((y[mask == 0] != 0).sum()) for y in ys)
        extra = {}
        if case == "all ones":
            # the same inputs through the full-length kernel
            ref = flat(full(*args[:-1]))
            extra["masked_vs_full_length_max_abs_diff"] = max(
                float((g - w).abs().max()) for g, w in zip(got, ref))

        # cuDNN yardstick: one layer on the packed batch (lengths >= 1:
        # packing takes no empty row, so the empty row runs one step)
        lstm = torch.nn.LSTM(H, H, num_layers=1, bidirectional=bi).cuda()
        packed = pack_padded_sequence(
            t(T, B, H), torch.from_numpy(np.maximum(lengths, 1)),
            enforce_sorted=False)
        hc_lib = (t(n_dir, B, H, scale=0.5), t(n_dir, B, H, scale=0.5))
        with torch.no_grad():
            library_ms = time_ms(lambda: lstm(packed, hc_lib), 5)
            kernel_ms = time_ms(lambda: kern(*args), 10)
            plain_ms = time_ms(lambda: plain(*args), 1, warmup=1)
        bound_ms, bound_by, flops, nbytes = layer_bound(
            n_dir, T, B, H, valid_steps=int(lengths.sum()))
        rec = {"phase": "masked_kernel", "name": name, "T": T, "B": B,
               "H": H, "lengths_min_max_sum": [int(lengths.min()),
                                               int(lengths.max()),
                                               int(lengths.sum())],
               "rows_per_cluster": geo.rows, "clusters": geo.clusters,
               "cluster_steps_max_mean": [max(tile_steps),
                                          sum(tile_steps) / len(tile_steps)],
               "max_abs_err": err, "tol": KERNEL_TOL,
               "masked_steps_nonzero": masked_nonzero, **extra,
               "kernel_ms": kernel_ms,
               "us_per_step": 1e3 * kernel_ms / max(max(tile_steps), 1),
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "torch.nn.LSTM 1 layer on pack_padded_sequence "
                          "(cuDNN, TF32 off; includes its input projection)",
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        if case != "ragged":
            rec["case"] = case
        emit(rec)
        tag = f"{name} H={H} B={B} T={T} {case}"
        require(finite, f"{tag}: non-finite output")
        require(masked_nonzero == 0,
                f"{tag}: {masked_nonzero} masked outputs are not zero")
        require(err <= KERNEL_TOL, f"{tag}: max abs err {err} > {KERNEL_TOL}")
        results.append(rec)
    return results


def int8_layer_bound(n_dir: int, T: int, B: int, H: int, valid_steps=None,
                     elem_bytes: int = 4):
    """Least time (ms) the card needs for one int8 layer scan: each input
    read once (x_proj, state and mask in the I/O dtype of `elem_bytes`
    bytes, 4 for float32 and 2 for bf16; w_hh int8, its scale float32),
    each output written once, the recurrent products at the int8
    tensor-core rate; with `valid_steps`, only the valid steps' products
    and x_proj rows. Returns (bound_ms, bound_by, ops, bytes)."""
    steps = T * B if valid_steps is None else valid_steps
    ops = n_dir * steps * 2.0 * H * 4 * H
    nbytes = n_dir * (elem_bytes * (steps * 4 * H    # x_proj
                                    + 2 * B * H      # h0, c0
                                    + T * B * H      # ys
                                    + 2 * B * H)     # h_T, c_T
                      + 4.0 * 4 * H                  # w_scale, float32
                      + H * 4 * H)                   # w_hh, int8
    if valid_steps is not None:
        nbytes += elem_bytes * T * B  # mask, shared by the directions
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT8_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def no_stack_no_spill(report) -> bool:
    """Whether every function of a `ptxas_by_function` report has no
    stack frame and no spills."""
    lines = [ln for fn in report.values() for ln in fn if "spill" in ln]
    return bool(lines) and all(
        ln.startswith("0 bytes stack frame") and "0 bytes spill stores" in ln
        and "0 bytes spill loads" in ln for ln in lines)


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
    dequantized weights. Each shape prints its cluster geometry (the
    masked entries' from the masked instantiation) and the ptxas report of
    its instantiation, which must show no stack and no spill; for the
    full-length scans (#4, #6) the masked entry runs the same inputs under
    an all-ones mask: it is the masked variant of the same body, with the
    same exact sums and the same roundings, so the difference must be
    exactly 0.0."""
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
        geo = lstm_cuda.scan_geometry(n_dir, B, H, torch.device("cuda", 0),
                                      masked=masked, int8=True)
        held = lstm_cuda.max_active_clusters(H, geo.rows, 0, masked=masked,
                                             int8=True)
        kernel = ("lstm_scan_masked_int8_kernel" if masked
                  else "lstm_scan_int8_kernel")
        ptxas = ptxas_by_function("lstm_scan_int8.cu",
                                  f"{kernel}ILi{geo.m_tiles}E")
        spill_free = no_stack_no_spill(ptxas)
        emit({"phase": "int8_scan_geometry", "name": name, "T": T,
              "B": B, "H": H, "rows_per_cluster": geo.rows,
              "m_tiles": geo.m_tiles, "clusters": geo.clusters,
              "ctas_per_cluster": geo.cluster,
              "max_active_clusters": held,
              "waves": math.ceil(geo.clusters / held),
              "smem_per_cta": geo.smem, "ptxas": ptxas})
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
        extra = {"rows_per_cluster": geo.rows,
                 "perf_md_ms": PERF_MD_INT8_MS.get((name, H, B))}
        if not masked:
            # the same inputs through the masked entry, every frame valid
            ones = torch.ones(T, B, device="cuda")
            masked_kern = fns[name.replace("scan_int8", "scan_masked_int8")][0]
            ref = flat(masked_kern(*full, ones))
            extra["masked_vs_full_length_max_abs_diff"] = max(
                float((g - w).abs().max()) for g, w in zip(got, ref))
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
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms,
               **extra}
        if masked:
            # the steps each cluster runs: its rows' longest length
            steps = [int(lengths[b:b + geo.rows].max())
                     for b in range(0, B, geo.rows)]
            rec["lengths_min_max_sum"] = [int(lengths.min()),
                                          int(lengths.max()),
                                          int(lengths.sum())]
            rec["us_per_step"] = 1e3 * kernel_ms / max(max(steps), 1)
        emit(rec)
        results.append(rec)
        tag = f"{name} H={H} B={B} T={T}"
        if not spill_free:
            failures.append(f"{tag}: the ptxas report of {kernel}<"
                            f"{geo.m_tiles}> shows a stack frame or spills")
        diff = extra.get("masked_vs_full_length_max_abs_diff", 0.0)
        if diff != 0.0:
            failures.append(f"{tag}: differs from the masked entry under an "
                            f"all-ones mask by {diff}")
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


def train_bounds(T: int, B: int, H: int, valid_steps: int,
                 res_bytes: int = 4, io_bytes: int = 4, w_bytes: int = 4):
    """Least time (ms) the card needs for kernel #7, for kernel #8 with its
    dW reduction, for the dW reduction alone and for #8's scan alone, on
    one layer-direction: each input read once, each output written once,
    the products of this run's valid steps at the peak rate of their
    operands' type (masked steps need no product, but every residual and
    gradient row is written). The residuals (acts, hseq and cseq written
    by #7; acts, c_new, h_prev and c_prev read by #8) take `res_bytes`
    bytes a value, 4 for float32 and 2 for bf16; x_proj, h0, c0, the mask,
    ys, h_T, c_T, dy, dh_T, dc_T, dx_proj, dh0 and dc0 take `io_bytes`,
    w_hh and dw_hh `w_bytes`. The recurrent product of #7 multiplies h
    rounded to the I/O type by w_hh, at the bf16 tensor cores' rate when
    both are bf16; #8's dh product multiplies dgates rounded to w_hh's
    type by w_hh (the bf16 rate for bf16 w_hh); dW sums float32 products
    (h_prev widened, the float32 dgates). "dw_all_rows" is the dW
    reduction over all T*B rows, which the kernel and torch.matmul both
    compute. Returns {"fwd", "bwd", "dw", "dw_all_rows", "scan"}, each
    (bound_ms, bound_by, flops, bytes)."""
    H4 = 4 * H
    seq, hc = T * B * H, B * H
    prod = 2.0 * valid_steps * H * H4
    fwd_rate = float_peak(max(io_bytes, w_bytes))
    dh_rate = float_peak(w_bytes)
    # (I/O values, w_hh values, residual values) each moves
    fwd_vals = (valid_steps * H4 + 2 * hc + T * B       # x_proj, h0c0, mask
                + seq + 2 * hc,                         # ys, h_T c_T
                H * H4,                                 # w_hh
                2 * seq + T * B * H4)                   # hseq cseq, acts
    bwd_vals = (seq + 2 * hc + T * B                    # dy, dh_T dc_T, mask
                + T * B * H4 + 2 * hc,                  # dx_proj, dh0 dc0
                2 * H * H4,                             # w_hh, dw_hh
                T * B * H4 + 3 * seq)                   # acts, c/h_prev/c_prev
    dw_vals = (0, H * H4, seq)                          # dw_hh; h_prev
    scan_vals = (bwd_vals[0], H * H4, bwd_vals[2] - seq)
    out = {}
    for name, t_ops, flops, (ios, ws, res), extra in (
            ("fwd", prod / fwd_rate, prod, fwd_vals, 0),
            ("bwd", prod / dh_rate + prod / F32_FLOPS_PER_S, 2 * prod,
             bwd_vals, 0),
            ("dw", prod / F32_FLOPS_PER_S, prod, dw_vals, 4 * T * B * H4),
            ("dw_all_rows", 2.0 * T * B * H * H4 / F32_FLOPS_PER_S,
             2.0 * T * B * H * H4, dw_vals, 4 * T * B * H4),
            ("scan", prod / dh_rate, prod, scan_vals, 0)):
        # the dW reduction alone reads the float32 dgates
        nbytes = io_bytes * ios + w_bytes * ws + res_bytes * res + extra
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     nbytes)
    return out


def phase_train_kernels(torch, train_cuda, ptxas,
                        shapes=((256, 256), (64, 256), (256, 37), (160, 37))):
    """Kernels #7 and #8 (with the dW kernel) against their plain versions
    at the training shape, T = 125 and B = 256 (a batch of `TrainHypers`),
    at H = 256 and 64, plus a ragged batch edge (B = 37) at H = 256 and at
    H = 160 (a cluster of five CTAs); `shapes` ((H, B), ...) replaces them
    (phase 4k's per-rank shapes). Nonzero h0/c0, random dy/dh_T/dc_T,
    and a seeded ragged mask with an empty row, a full row and rows in
    between. The plain backward gets the same residuals as the kernel (the
    kernel's forward outputs). `ptxas` is the build log's report of
    `lstm_train.cu`."""
    import numpy as np
    results = []
    failures = []
    for H, B in shapes:
        T = 125
        geo = train_cuda.train_geometry(B, H, torch.device("cuda", 0))
        emit({"phase": "train_geometry", "T": T, "B": B, "H": H,
              "max_active_clusters": train_cuda.max_active_clusters(H, 0),
              "clusters": math.ceil(B / geo.rows),
              "ctas_per_cluster": geo.cluster, "rows_per_cluster": geo.rows,
              "smem_per_cta": {"fwd": geo.fwd_smem, "bwd": geo.bwd_smem},
              "ptxas": ptxas})
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
        dw_tile = [train_cuda._dw_tile_rows(H), train_cuda._DW_TILE_N]
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
        scan_args = (dy, dh_t, dc_t, acts, cseq, c_prev, w_hh, mask)
        scan_ms = time_ms(lambda: train_cuda._bwd_scan(*scan_args), 10)
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
                  "scan_ms": scan_ms, "scan_bound_ms": bounds["scan"][0],
                  "scan_bound_by": bounds["scan"][1],
                  "dw_hh_max_abs": dw_scale, "dw_hh_rel_err": dw_rel,
                  "tol": TRAIN_TOL, "dw_rel_tol": DW_REL_TOL,
                  "dw_repeatable": dw_repeatable}),
                ("lstm_train_dw_f32", {"dw_hh": bwd_err["dw_hh"]}, dw_ms,
                 dw_plain_ms, dw_lib_ms,
                 "torch.matmul(h_prev^T, dgates) over the T*B rows "
                 "(cuBLAS, TF32 off)",
                 {"dw_hh_rel_err": dw_rel, "dw_rel_tol": DW_REL_TOL,
                  "tile": dw_tile, "slabs": [n_slabs, rows],
                  "ptxas": ptxas_by_function(
                      "lstm_train.cu",
                      f"lstm_train_dw_kernelILi{dw_tile[0] // 64}E"),
                  "tflops_all_rows": 2.0 * T * B * H * 4 * H / dw_ms / 1e9,
                  "library_tflops_all_rows":
                      2.0 * T * B * H * 4 * H / dw_lib_ms / 1e9,
                  "bound_all_rows_ms": bounds["dw_all_rows"][0],
                  "bound_all_rows_by": bounds["dw_all_rows"][1],
                  "note": "its time excludes the slab sum; the kernel and "
                          "torch.matmul both take all T*B rows, the bound "
                          "only the valid ones (bound_all_rows_ms: all)"})):
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


def train_stack_spill() -> dict:
    """The ptxas report of every kernel instantiation of `lstm_train.cu`,
    by its type arguments as c++filt prints them, (Res, IO, W) for the
    scans (the forward's W is its IO) and (Res,) for dW: {types: {"fwd<R>",
    "bwd<R>" or "dw<MI>": [stack frame, spill stores, spill loads] in
    bytes}}. The shared f32
    body has a stack frame and spills at #7's R >= 12 and at #8's scan's
    R = 18, as it had before the bf16res entries; any
    other instantiation, the same body with other loads and stores (and
    for bf16 I/O a float32 h kept in a register), is held to its f32
    twin's numbers (`spill_beyond`)."""
    import re
    import shutil
    funcs = ptxas_by_function("lstm_train.cu", "lstm_train_", bf16=None)
    names = list(funcs)
    filt = shutil.which("c++filt") or shutil.which("cu++filt") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cu++filt")
    plain = subprocess.run([filt], input="\n".join(names), text=True,
                           capture_output=True, check=True,
                           timeout=60).stdout.splitlines()
    out = {}
    for name, dem in zip(names, plain):
        m = re.search(r"lstm_train_(fwd|bwd|dw)_kernel<(\d+), ([^>]*)>", dem)
        line = next((ln for ln in funcs[name] if "spill" in ln), None)
        if m and line:
            types = tuple(t.strip() for t in m.group(3).split(","))
            if m.group(1) == "fwd":     # w_hh in the I/O type
                types += types[-1:]
            out.setdefault(types, {})[f"{m.group(1)}<{m.group(2)}>"] = [
                int(x) for x in re.findall(r"(\d+) bytes", line)]
    return out


F32_T, BF16_T = "float", "__nv_bfloat16"


def spill_of(spills: dict, res: str, io: str = F32_T, w: str = F32_T):
    """One instantiation family's report from `train_stack_spill`: the
    scans on (res, io, w) and the dW reduction on res."""
    return {**spills.get((res, io, w), {}), **spills.get((res,), {})}


def spill_beyond(got: dict, twin: dict) -> dict:
    """The entries of `got` with more stack or spills than the same
    kernel in `twin` (any at all for a dW kernel)."""
    return {k: v for k, v in got.items()
            if any(a > b for a, b in zip(v, twin.get(k, [0, 0, 0])))
            or (k.startswith("dw") and any(v))}


def phase_train_bf16res_kernels(torch, train_cuda):
    """The bf16res entries of #7, #8's scan and #8's dW (residual_dtype
    bf16) at phase 3c's shapes, inputs and seeds: the forward's ys, h_T
    and c_T equal the f32 entry's, and its acts, hseq and cseq the f32
    entry's rounded to bf16 (0.0); the backward on the bf16 residuals
    equals the f32 entry on the same residuals widened (0.0, dx_proj, dW,
    dh0, dc0); against the plain bf16res versions, the forward within
    TRAIN_TOL (its residuals within BF16RES_ULPS on at most
    BF16RES_DIFFER_SHARE of them) and the backward on the kernel's
    residuals within TRAIN_TOL and DW_REL_TOL; dW the same from run to
    run; each bf16res instantiation with the stack frame and spills of its
    f32 twin (`train_stack_spill`), the dW reduction's without any, and
    the residency equal to the f32 one's. Times beside the f32 entries' in
    the same run, the bounds with 2-byte residuals."""
    import numpy as np
    bf16 = torch.bfloat16
    results, failures = [], []
    spills = train_stack_spill()
    f32_spill = spill_of(spills, F32_T)
    bf16_spill = spill_of(spills, BF16_T)
    added = {k: v for k, v in bf16_spill.items()
             if v != f32_spill.get(k) or (k.startswith("dw") and any(v))}
    emit({"phase": "train_bf16res_ptxas", "instantiations": len(bf16_spill),
          "stack_spill_bytes_f32": {k: v for k, v in f32_spill.items()
                                    if any(v)},
          "stack_spill_bytes_bf16res": {k: v for k, v in bf16_spill.items()
                                        if any(v)},
          "bf16res_beyond_f32_twin": added})
    if len(bf16_spill) != len(f32_spill) or len(bf16_spill) != 22 or added:
        failures.append(f"bf16res instantiations with a stack frame or "
                        f"spills their f32 twins lack: {added}")
    for H, B in ((256, 256), (64, 256), (256, 37), (160, 37)):
        T = 125
        residency = {"f32": train_cuda.max_active_clusters(H, 0),
                     "bf16res": train_cuda.max_active_clusters(H, 0, bf16)}
        rng = np.random.RandomState(7 + H + B)  # phase 3c's inputs

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
        g32 = train_cuda.lstm_train_fwd(*fwd_args)
        g16 = train_cuda.lstm_train_fwd(*fwd_args, residual_dtype=bf16)
        torch.cuda.synchronize()
        want = train_cuda.lstm_train_fwd_plain(*fwd_args,
                                               residual_dtype=bf16)
        names = ("ys", "acts", "hseq", "cseq", "h_T", "c_T")
        res = (1, 2, 3)
        fwd_vs_f32 = {n: float((g.float() - (w.to(bf16).float() if i in res
                                              else w)).abs().max())
                      for i, (n, g, w) in enumerate(zip(names, g16, g32))}
        fwd_err = {n: float((g - w).abs().max())
                   for i, (n, g, w) in enumerate(zip(names, g16, want))
                   if i not in res}
        res_ulps = ulps_apart([g16[i] for i in res], [want[i] for i in res])
        res_share = max(float((g16[i] != want[i]).float().mean())
                        for i in res)
        finite = all(bool(torch.isfinite(g.float()).all()) for g in g16)

        _, acts, hseq, cseq, _, _ = g16
        h_prev = torch.cat([h0.to(bf16)[None], hseq[:-1]])
        c_prev = torch.cat([c0.to(bf16)[None], cseq[:-1]])
        bwd16 = (dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w_hh, mask)
        bwd32 = (dy, dh_t, dc_t, acts.float(), cseq.float(), h_prev.float(),
                 c_prev.float(), w_hh, mask)
        gb = train_cuda.lstm_train_bwd(*bwd16, residual_dtype=bf16)
        gb32 = train_cuda.lstm_train_bwd(*bwd32)
        torch.cuda.synchronize()
        wb = train_cuda.lstm_train_bwd_plain(*bwd16)
        bnames = ("dx_proj", "dw_hh", "dh0", "dc0")
        bwd_vs_f32 = {n: float((g - w).abs().max())
                      for n, g, w in zip(bnames, gb, gb32)}
        bwd_err = {n: float((g - w).abs().max())
                   for n, g, w in zip(bnames, gb, wb)}
        dw_rel = bwd_err["dw_hh"] / float(wb[1].abs().max())
        finite = finite and all(bool(torch.isfinite(g).all()) for g in gb)
        dw_repeatable = bool(torch.equal(train_cuda.lstm_train_bwd(
            *bwd16, residual_dtype=bf16)[1], gb[1]))

        # times: each bf16res entry beside the f32 one, in this run
        n_slabs, rows = train_cuda._dw_slabs(T * B, H)
        slabs = torch.empty((n_slabs, H, 4 * H), device="cuda")
        dx = gb[0]
        ms = {}
        for rdt, suffix, bargs in ((torch.float32, "f32", bwd32),
                                   (bf16, "bf16res", bwd16)):
            ms[suffix] = {
                "fwd": time_ms(lambda: train_cuda.lstm_train_fwd(
                    *fwd_args, residual_dtype=rdt), 10),
                "bwd": time_ms(lambda: train_cuda.lstm_train_bwd(
                    *bargs, residual_dtype=rdt), 10),
                "scan": time_ms(lambda: train_cuda._bwd_scan(
                    *bargs[:5], bargs[6], w_hh, mask), 10),
                "dw": time_ms(lambda: train_cuda._call(
                    f"lstm_train_dw_{suffix}", bargs[5], dx, slabs, T * B,
                    H, n_slabs, rows), 10)}
        plain_ms = {
            "fwd": time_ms(lambda: train_cuda.lstm_train_fwd_plain(
                *fwd_args, residual_dtype=bf16), 1, warmup=1),
            "bwd": time_ms(lambda: train_cuda.lstm_train_bwd_plain(*bwd16),
                           1, warmup=1),
            "dw": time_ms(lambda: train_cuda.lstm_train_dw_plain(h_prev, dx),
                          1, warmup=1)}
        # library yardsticks: cuDNN training mode (forward, backward), and
        # torch.matmul on h_prev widened (the widening included) for dW
        lstm = torch.nn.LSTM(H, H, num_layers=1).cuda().train()
        x_lib = t(T, B, H).requires_grad_(True)
        hc_lib = (t(1, B, H, scale=0.5), t(1, B, H, scale=0.5))
        y_lib, _ = lstm(x_lib, hc_lib)
        g_lib = torch.randn_like(y_lib)
        lib_ms = {
            "fwd": time_ms(lambda: lstm(x_lib, hc_lib), 10),
            "bwd": time_ms(lambda: torch.autograd.grad(
                y_lib, [x_lib, *lstm.parameters()], g_lib,
                retain_graph=True), 10),
            "dw": time_ms(lambda: torch.matmul(
                h_prev.reshape(-1, H).float().t(), dx.reshape(-1, 4 * H)),
                10)}
        bounds = train_bounds(T, B, H, int(lengths.sum()), res_bytes=2)
        common = {"T": T, "B": B, "H": H,
                  "lengths_min_max_sum": [int(lengths.min()),
                                          int(lengths.max()),
                                          int(lengths.sum())],
                  "residency": residency}
        for name, key, err, extra, lib in (
                ("lstm_train_fwd_bf16res", "fwd", fwd_err,
                 {"vs_f32_entry": fwd_vs_f32, "residual_ulps": res_ulps,
                  "residual_differ_share": res_share},
                 LIB_TRAIN + "forward"),
                ("lstm_train_bwd_bf16res", "bwd", bwd_err,
                 {"vs_f32_entry_on_widened": bwd_vs_f32,
                  "includes": "the scan, the dW kernel, the slab sum",
                  "scan_ms": ms["bf16res"]["scan"],
                  "scan_f32_entry_ms": ms["f32"]["scan"],
                  "scan_bound_ms": bounds["scan"][0],
                  "dw_hh_rel_err": dw_rel, "dw_repeatable": dw_repeatable},
                 LIB_TRAIN + "backward (autograd.grad)"),
                ("lstm_train_dw_bf16res", "dw", {"dw_hh": bwd_err["dw_hh"]},
                 {"dw_hh_rel_err": dw_rel,
                  "vs_f32_entry_on_widened": bwd_vs_f32["dw_hh"],
                  "note": "its time excludes the slab sum"},
                 "torch.matmul(h_prev.float()^T, dgates) over the T*B rows "
                 "(cuBLAS, TF32 off, the widening included)")):
            b_ms, b_by, flops, nbytes = bounds[key]
            rec = {"phase": "train_bf16res_kernel", "name": name, **common,
                   "max_abs_err": err, **extra, "tol": TRAIN_TOL,
                   "dw_rel_tol": DW_REL_TOL,
                   "kernel_ms": ms["bf16res"][key],
                   "f32_entry_ms": ms["f32"][key],
                   "over_f32_entry": ms["bf16res"][key] / ms["f32"][key],
                   "plain_ms": plain_ms[key], "library_ms": lib_ms[key],
                   "library": lib, "bound_ms": b_ms, "bound_by": b_by,
                   "flops": flops, "bytes": nbytes,
                   "pct_of_bound": 100.0 * b_ms / ms["bf16res"][key]}
            emit(rec)
            results.append(rec)
        tag = f"H={H} B={B}"
        if not finite:
            failures.append(f"{tag}: non-finite output")
        if residency["bf16res"] != residency["f32"]:
            failures.append(f"{tag}: residency {residency}")
        if max(fwd_vs_f32.values()) != 0.0:
            failures.append(f"{tag}: forward vs f32 entry {fwd_vs_f32}")
        if max(bwd_vs_f32.values()) != 0.0:
            failures.append(f"{tag}: backward vs f32 entry on the widened "
                            f"residuals {bwd_vs_f32}")
        if max(fwd_err.values()) > TRAIN_TOL:
            failures.append(f"{tag}: forward err {fwd_err} > {TRAIN_TOL}")
        if res_ulps > BF16RES_ULPS or res_share > BF16RES_DIFFER_SHARE:
            failures.append(f"{tag}: residuals {res_ulps} ulps apart on "
                            f"{res_share} of them")
        if max(v for k, v in bwd_err.items() if k != "dw_hh") > TRAIN_TOL:
            failures.append(f"{tag}: backward err {bwd_err} > {TRAIN_TOL}")
        if dw_rel > DW_REL_TOL:
            failures.append(f"{tag}: dw_hh rel err {dw_rel} > {DW_REL_TOL}")
        if not dw_repeatable:
            failures.append(f"{tag}: dw_hh differs between two runs")
    require(not failures, "; ".join(failures))
    return results


def phase_train_bf16_kernels(torch, train_cuda):
    """Phase 3i: the training kernels' entries for bf16 params at phase
    3c's shapes, inputs and seeds (TF32 off), each residual dtype: the
    bf16-I/O entries (`*_bf16`, x_proj, w_hh, the state, the mask, dy and
    every output but the residuals in bf16) and the wbf16 backward (w_hh
    bf16, the rest float32, on the residuals of the f32 forward on the
    widened w_hh, which is the float32 input's forward on bf16 params).
    Each against its plain version on the same inputs, the backward on the
    kernel's own residuals: every bf16 output within BF16_ULPS bf16 ulps of
    its largest magnitude (a product's h or dgates rounded to bf16 lands a
    float32 last bit on the other side of a rounding boundary now and then,
    as in phase 3f), the wbf16 backward's float32 outputs within
    WBF16_REL_L2, which the same scan without the dgates rounding (the f32
    entry on the widened w_hh) must fail, the masked ys exactly zero. Every
    instantiation's ptxas stack and spills no more than its f32 twin's,
    and its residency equal to the f32 one's. Times beside the f32 entry's
    at the same shape in this run, the plain versions' and cuDNN's
    (`torch.nn.LSTM`, training mode, in bf16 for the bf16 entries, float32
    for the wbf16 ones), bounds with the entries' own bytes and rates
    (`train_bounds`)."""
    import numpy as np
    bf16, f32 = torch.bfloat16, torch.float32
    results, failures = [], []
    spills = train_stack_spill()
    f32_spill = spill_of(spills, F32_T)
    beyond = {}
    for res in (F32_T, BF16_T):
        twin = spill_of(spills, res)
        # the bf16-I/O forward and backward scans, and the wbf16 backward
        for io, w, n in ((BF16_T, BF16_T, 20), (F32_T, BF16_T, 10)):
            fam = {k: v for k, v in spill_of(spills, res, io, w).items()
                   if not k.startswith("dw")}
            key = f"{res},{io},{w}"
            if len(fam) != n:
                failures.append(f"{key}: {len(fam)} scan instantiations")
            more = spill_beyond(fam, twin)
            if more:
                beyond[key] = more
    emit({"phase": "train_bf16_ptxas", "families": len(spills),
          "stack_spill_bytes_f32": {k: v for k, v in f32_spill.items()
                                    if any(v)},
          "stack_spill_bytes": {",".join(t): {k: v for k, v in fam.items()
                                              if any(v)}
                                for t, fam in spills.items()},
          "beyond_f32_twin": beyond})
    if beyond:
        failures.append(f"instantiations with a stack frame or spills "
                        f"their f32 twins lack: {beyond}")

    def rel_l2(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    for H, B in ((256, 256), (64, 256), (256, 37), (160, 37)):
        T = 125
        rng = np.random.RandomState(7 + H + B)  # phase 3c's inputs

        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).cuda()

        bound = 1.0 / math.sqrt(H)
        x_proj = t(T, B, 4 * H)
        w32 = torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H))
                               .astype(np.float32)).cuda()
        w16 = w32.to(bf16)
        h0, c0 = t(B, H, scale=0.5), t(B, H, scale=0.5)
        lengths = rng.randint(1, T, size=B)
        lengths[0], lengths[1] = 0, T
        mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None, :]
                ).float().cuda()
        dy, dh_t, dc_t = t(T, B, H), t(B, H), t(B, H)
        # cuDNN yardsticks, float32 and bf16, training mode
        lib_ms = {}
        for dt in (f32, bf16):
            lstm = torch.nn.LSTM(H, H, num_layers=1).cuda().to(dt).train()
            x_lib = t(T, B, H).to(dt).requires_grad_(True)
            hc_lib = (t(1, B, H, scale=0.5).to(dt),
                      t(1, B, H, scale=0.5).to(dt))
            y_lib, _ = lstm(x_lib, hc_lib)
            g_lib = torch.randn_like(y_lib)
            lib_ms[dt] = {
                "fwd": time_ms(lambda: lstm(x_lib, hc_lib), 10),
                "bwd": time_ms(lambda: torch.autograd.grad(
                    y_lib, [x_lib, *lstm.parameters()], g_lib,
                    retain_graph=True), 10)}
        for rdt in (f32, bf16):
            # the f32 entry at this shape, for the times
            ref = train_cuda.lstm_train_fwd(x_proj, w32, h0, c0, mask, rdt)
            f32_ms = {
                "fwd": time_ms(lambda: train_cuda.lstm_train_fwd(
                    x_proj, w32, h0, c0, mask, rdt), 10),
                "bwd": time_ms(lambda: train_cuda.lstm_train_bwd(
                    dy, dh_t, dc_t, ref[1], ref[3],
                    torch.cat([h0.to(rdt)[None], ref[2][:-1]]),
                    torch.cat([c0.to(rdt)[None], ref[3][:-1]]), w32, mask,
                    rdt), 10)}
            for io in (bf16, f32):
                suffix = train_cuda.SCAN_ENTRY[(io, bf16, rdt)]
                fwd_args = (x_proj.to(io), w16, h0.to(io), c0.to(io),
                            mask.to(io))
                # under float32 I/O the f32 entry on the widened w_hh
                got = train_cuda.lstm_train_fwd(*fwd_args, rdt)
                torch.cuda.synchronize()
                want = train_cuda.lstm_train_fwd_plain(*fwd_args, rdt)
                names = ("ys", "acts", "hseq", "cseq", "h_T", "c_T")
                fwd_ulps = {n: ulps_apart([g], [w])
                            for n, g, w in zip(names, got, want)}
                fwd_abs = {n: float((g.float() - w.float()).abs().max())
                           for n, g, w in zip(names, got, want)}
                masked_nonzero = int((got[0][mask == 0] != 0).sum())
                _, acts, hseq, cseq, _, _ = got
                h_prev = torch.cat([fwd_args[2].to(rdt)[None], hseq[:-1]])
                c_prev = torch.cat([fwd_args[3].to(rdt)[None], cseq[:-1]])
                bwd_args = (dy.to(io), dh_t.to(io), dc_t.to(io), acts, cseq,
                            h_prev, c_prev, w16, mask.to(io))
                gb = train_cuda.lstm_train_bwd(*bwd_args, residual_dtype=rdt)
                torch.cuda.synchronize()
                wb = train_cuda.lstm_train_bwd_plain(*bwd_args)
                bnames = ("dx_proj", "dw_hh", "dh0", "dc0")
                bwd_ulps = {n: ulps_apart([g], [w])
                            for n, g, w in zip(bnames, gb, wb)}
                bwd_abs = {n: float((g.float() - w.float()).abs().max())
                           for n, g, w in zip(bnames, gb, wb)}
                # float32 outputs: the kernel, and the scan without the
                # dgates rounding, against the plain version
                bwd_rel = unrounded_rel = None
                if io == f32:
                    unrounded = train_cuda.lstm_train_bwd(
                        *bwd_args[:7], w16.float(), bwd_args[8],
                        residual_dtype=rdt)
                    bwd_rel = {n: rel_l2(g, w) for n, g, w in
                               zip(bnames, gb, wb) if n in WBF16_REL_L2}
                    unrounded_rel = {n: rel_l2(g, w) for n, g, w in
                                     zip(bnames, unrounded, wb)
                                     if n in WBF16_REL_L2}
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in (*got, *gb))
                dtypes_ok = (got[0].dtype == gb[0].dtype == io
                             and got[1].dtype == rdt
                             and gb[1].dtype == bf16)
                residency = {
                    "f32": train_cuda.max_active_clusters(H, 0),
                    suffix: train_cuda.max_active_clusters(H, 0, rdt, io,
                                                           bf16)}
                ms = {"fwd": time_ms(lambda: train_cuda.lstm_train_fwd(
                          *fwd_args, rdt), 10),
                      "bwd": time_ms(lambda: train_cuda.lstm_train_bwd(
                          *bwd_args, residual_dtype=rdt), 10),
                      "scan": time_ms(lambda: train_cuda._bwd_scan(
                          *bwd_args[:5], c_prev, w16, bwd_args[8]), 10)}
                plain_ms = {
                    "fwd": time_ms(lambda: train_cuda.lstm_train_fwd_plain(
                        *fwd_args, rdt), 1, warmup=1),
                    "bwd": time_ms(lambda: train_cuda.lstm_train_bwd_plain(
                        *bwd_args), 1, warmup=1)}
                io_bytes = 2 if io == bf16 else 4
                bounds = train_bounds(T, B, H, int(lengths.sum()),
                                      res_bytes=2 if rdt == bf16 else 4,
                                      io_bytes=io_bytes, w_bytes=2)
                common = {"T": T, "B": B, "H": H,
                          "lengths_min_max_sum": [int(lengths.min()),
                                                  int(lengths.max()),
                                                  int(lengths.sum())],
                          "residency": residency, "ulps_tol": BF16_ULPS}
                lib_dt = bf16 if io == bf16 else f32
                lib_name = (f"torch.nn.LSTM 1 layer, training mode, full "
                            f"length (cuDNN, {str(lib_dt)[6:]}, TF32 off, its "
                            f"input projection included), ")
                entries = [("bwd", bwd_ulps, bwd_abs,
                            {"includes": "the scan, the dW kernel on the "
                                         "float32 dgates, the slab sum",
                             "scan_ms": ms["scan"],
                             "scan_bound_ms": bounds["scan"][0],
                             "scan_bound_by": bounds["scan"][1],
                             "float32_rel_l2": bwd_rel,
                             "float32_rel_l2_tol": WBF16_REL_L2
                             if io == f32 else None,
                             "without_dgates_rounding_rel_l2":
                                 unrounded_rel})]
                if io == bf16:
                    entries.insert(0, ("fwd", fwd_ulps, fwd_abs,
                                       {"masked_steps_nonzero":
                                        masked_nonzero}))
                for key, ulps, err, extra in entries:
                    b_ms, b_by, flops, nbytes = bounds[key]
                    rec = {"phase": "train_bf16_kernel",
                           "name": f"lstm_train_{key}_{suffix}", **common,
                           "max_err_ulps": ulps, "max_abs_err": err,
                           **extra, "kernel_ms": ms[key],
                           "f32_entry_ms": f32_ms[key],
                           "over_f32_entry": ms[key] / f32_ms[key],
                           "plain_ms": plain_ms[key],
                           "library_ms": lib_ms[lib_dt][key],
                           "library": lib_name + (
                               "forward" if key == "fwd"
                               else "backward (autograd.grad)"),
                           "bound_ms": b_ms, "bound_by": b_by,
                           "flops": flops, "bytes": nbytes,
                           "pct_of_bound": 100.0 * b_ms / ms[key]}
                    emit(rec)
                    results.append(rec)
                tag = f"{suffix} H={H} B={B}"
                if not finite:
                    failures.append(f"{tag}: non-finite output")
                if not dtypes_ok:
                    failures.append(f"{tag}: output dtypes")
                if masked_nonzero:
                    failures.append(f"{tag}: {masked_nonzero} masked ys "
                                    "not zero")
                if io == bf16 and max(fwd_ulps.values()) > BF16_ULPS:
                    failures.append(f"{tag}: forward {fwd_ulps} ulps")
                if bwd_ulps["dw_hh"] > BF16_ULPS or (
                        io == bf16 and max(bwd_ulps.values()) > BF16_ULPS):
                    failures.append(f"{tag}: backward {bwd_ulps} ulps")
                if io == f32:
                    for n, tol in WBF16_REL_L2.items():
                        if bwd_rel[n] > tol:
                            failures.append(f"{tag}: {n} relative L2 "
                                            f"{bwd_rel[n]} > {tol}")
                        if unrounded_rel[n] <= tol:
                            failures.append(
                                f"{tag}: {n} without the dgates rounding "
                                f"{unrounded_rel[n]} within {tol}")
                if residency[suffix] != residency["f32"]:
                    failures.append(f"{tag}: residency {residency}")
    require(not failures, "; ".join(failures))
    return results


def multicell_bound(T: int, B: int, hidden_sizes, elem_bytes: int = 4):
    """Least time (ms) the card needs for one multicell scan: the cells'
    operations and bytes, each counted as `layer_bound` counts one
    direction (`elem_bytes` the I/O dtype's size), summed over the cells.
    Returns (bound_ms, bound_by, flops, bytes)."""
    parts = [layer_bound(1, T, B, H, elem_bytes=elem_bytes)
             for H in hidden_sizes]
    flops, nbytes = sum(p[2] for p in parts), sum(p[3] for p in parts)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / float_peak(elem_bytes)
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_multicell(torch, multicell_cuda, lstm_cuda):
    """Kernel #9 against its plain version at the fused path's shapes:
    T = 45, the trio's five cells (`models.fused._ROW_H`), B = 256 windows
    and B = 8; at B = 8 also threaded through chunks of 4 steps. The
    yardstick is the per-module layer kernels on the same five cells (a
    bidirectional launch at H = 256, one at H = 64, a unidirectional one
    at H = 256), timed in turns with the multicell kernel. Both run the
    float cluster body, so they must give the same bits: the difference
    must be exactly 0.0. Each B prints the multicell cluster geometry and
    the ptxas report of its instantiation, which must show no stack and no
    spill."""
    import numpy as np
    from mobileposer_tpu_torch.models.fused import _ROW_H
    T, hs = 45, _ROW_H
    offs = [sum(4 * h for h in hs[:i]) for i in range(len(hs))]
    results, failures = [], []
    for B in (256, 8):
        geo = multicell_cuda.multicell_geometry(B, hs, torch.device("cuda", 0))
        held = multicell_cuda.max_active_clusters(tuple(hs), geo.rows,
                                                  geo.h_buffers, 0)
        ptxas = ptxas_by_function(
            "multicell_scan.cu",
            f"multicell_scan_kernelILi{geo.lane_rows}ELi{geo.lane_cols}"
            f"ELi{geo.row_groups}ELb{int(geo.h_buffers == 1)}E")
        emit({"phase": "multicell_geometry", "B": B, "T": T, "H": list(hs),
              "rows_per_group": geo.rows, "groups_per_cluster": geo.groups,
              "rows_per_lane": geo.lane_rows, "cols_per_lane": geo.lane_cols,
              "row_groups": geo.row_groups,
              "h_buffers": geo.h_buffers, "clusters": geo.clusters,
              "ctas_per_cluster": geo.cluster, "max_active_clusters": held,
              "waves": math.ceil(geo.clusters / held),
              "smem_per_cta": geo.smem, "ptxas": ptxas})
        if not no_stack_no_spill(ptxas):
            failures.append(f"multicell B={B}: the ptxas report of "
                            f"multicell_scan_kernel<{geo.lane_rows}, "
                            f"{geo.lane_cols}, {geo.row_groups}, "
                            f"{str(geo.h_buffers == 1).lower()}> shows a "
                            "stack frame or spills")
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
               "perf_md_ms": PERF_MD_MULTICELL_MS.get(B),
               "rows_per_group": geo.rows, "clusters": geo.clusters,
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
        for what, e in (("max abs err", err), ("chunked err", chunk_err)):
            if e is not None and e > KERNEL_TOL:
                failures.append(f"{tag}: {what} {e} > {KERNEL_TOL}")
        if per_module_diff != 0.0:
            failures.append(f"{tag}: differs from the per-module kernels by "
                            f"{per_module_diff}")
    require(not failures, "; ".join(failures))
    return results


def bf16_ulp(x) -> float:
    """One bf16 ulp at the largest magnitude of x."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def ulps_apart(got, want) -> float:
    """The largest difference of the outputs `got` and `want` (lists of
    bf16 tensors), in bf16 ulps of each output's largest magnitude."""
    return max(float((g.float().cpu() - w.float().cpu()).abs().max())
               / bf16_ulp(w) for g, w in zip(got, want))


def _flat(out):
    return [x for o in out for x in (o if isinstance(o, (tuple, list))
                                     else (o,))]


def _lstm_library_ms(torch, H, B, T, bi, dtype, lengths=None):
    """One torch.nn.LSTM layer (cuDNN) in `dtype` on a [T, B, H] input
    (with `lengths`, on `pack_padded_sequence`), ms per call; None and
    the error's first line where the card's PyTorch refuses the dtype."""
    from torch.nn.utils.rnn import pack_padded_sequence
    n_dir = 2 if bi else 1
    try:
        lstm = torch.nn.LSTM(H, H, num_layers=1, bidirectional=bi).to(
            device="cuda", dtype=dtype)
        x = torch.randn(T, B, H, device="cuda", dtype=dtype)
        if lengths is not None:
            x = pack_padded_sequence(
                x, torch.from_numpy(lengths).clamp(min=1),
                enforce_sorted=False)
        hc = (torch.zeros(n_dir, B, H, device="cuda", dtype=dtype),
              torch.zeros(n_dir, B, H, device="cuda", dtype=dtype))
        with torch.no_grad():
            return time_ms(lambda: lstm(x, hc), 5), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def phase_bf16_kernels(torch, lstm_cuda, multicell_cuda):
    """The bf16-I/O entries of #1, #2, #3 and #9 against their bf16 plain
    versions on the card: the full-length scans at the streaming shapes
    (T = 45: bi B = 256 at H = 256 and 64, uni B = 256 and 8), the masked
    ones at the evaluation shape (T = 512, B = 64, a seeded ragged bf16
    mask with an empty and a full row, exact zeros at masked steps), the
    multicell scan on the trio's five cells at T = 45, B = 256 (its
    difference to the bf16 layer entries on the same cells exactly 0.0).
    Each shape: one step from h0 within BF16_STEP_ULPS, the whole shape
    within BF16_ULPS, the ptxas report of its bf16 instantiation (no stack,
    no spill), the kernel's time beside the float32 entry's on the same
    values, the plain version's, cuDNN's in bf16 where the card's PyTorch
    takes it, and the bound at the float32 rate with bf16 bytes."""
    import numpy as np
    from mobileposer_tpu_torch.models.fused import _ROW_H
    BF = torch.bfloat16
    dev = torch.device("cuda", 0)
    cases = [("bilstm_scan_bf16", 256, 256, 45),
             ("bilstm_scan_bf16", 64, 256, 45),
             ("lstm_scan_bf16", 256, 256, 45),
             ("lstm_scan_bf16", 256, 8, 45),
             ("bilstm_scan_masked_bf16", 256, 64, 512),
             ("bilstm_scan_masked_bf16", 64, 64, 512),
             ("lstm_scan_masked_bf16", 256, 64, 512)]
    results, failures = [], []

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=dev, dtype=BF)

    for name, H, B, T in cases:
        bi, masked = name.startswith("bi"), "masked" in name
        n_dir = 2 if bi else 1
        geo = lstm_cuda.scan_geometry(n_dir, B, H, dev, masked=masked)
        kernel = "lstm_scan_masked_kernel" if masked else "lstm_scan_kernel"
        ptxas = ptxas_by_function(
            "lstm_scan.cu", f"{kernel}ILi{geo.lane_rows}ELi{geo.lane_cols}E",
            bf16=True)
        rng = np.random.RandomState(H + B + T + 3)
        bound = 1.0 / math.sqrt(H)
        dirs = [(bf(rng.randn(T, B, 4 * H)),
                 bf(rng.uniform(-bound, bound, (H, 4 * H))),
                 bf(np.tanh(rng.randn(B, H))), bf(rng.randn(B, H) * 0.5))
                for _ in range(n_dir)]
        lengths = None
        if masked:
            lengths = rng.randint(1, T, size=B)
            lengths[0], lengths[1] = 0, T
            mask = (torch.arange(T)[:, None]
                    < torch.from_numpy(lengths)[None, :]).to(
                        device=dev, dtype=BF)
        prefix = {"lstm_scan_bf16": "lstm_layer",
                  "bilstm_scan_bf16": "bilstm_layer",
                  "lstm_scan_masked_bf16": "lstm_layer_masked",
                  "bilstm_scan_masked_bf16": "bilstm_layer_masked"}[name]
        kern = getattr(lstm_cuda, prefix)
        plain = getattr(lstm_cuda, prefix + "_plain")

        def arguments(steps):
            ds = [(x[:steps].contiguous(), *rest) for x, *rest in dirs]
            if bi:
                (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = ds
                args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b)
            else:
                args = tuple(ds[0])
            return args + ((mask[:steps].contiguous(),) if masked else ())

        step_args, args = arguments(1), arguments(T)
        step_ulps = ulps_apart(_flat(kern(*step_args)),
                               _flat(plain(*step_args)))
        got = _flat(kern(*args))
        torch.cuda.synchronize()
        want = _flat(plain(*args))
        ulps = ulps_apart(got, want)
        err = max(float((g.float().cpu() - w.float().cpu()).abs().max())
                  for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        masked_nonzero = (sum(int((y[mask == 0] != 0).sum())
                              for y in got[:n_dir]) if masked else 0)
        args32 = tuple(a.float() for a in args)
        library_ms, library_refused = _lstm_library_ms(
            torch, H, B, T, bi, BF, lengths)
        with torch.no_grad():
            kernel_ms = time_ms(lambda: kern(*args), 10)
            float_ms = time_ms(lambda: kern(*args32), 10)
            plain_ms = time_ms(lambda: plain(*args), 1, warmup=1)
        bound_ms, bound_by, flops, nbytes = layer_bound(
            n_dir, T, B, H, valid_steps=(int(lengths.sum()) if masked
                                         else None), elem_bytes=2)
        rec = {"phase": "bf16_kernel", "name": name, "T": T, "B": B, "H": H,
               "rows_per_cluster": geo.rows, "clusters": geo.clusters,
               "ptxas": ptxas, "step_err_ulps": step_ulps,
               "max_err_ulps": ulps, "max_abs_err": err,
               "step_tol_ulps": BF16_STEP_ULPS, "tol_ulps": BF16_ULPS,
               "masked_steps_nonzero": masked_nonzero,
               "kernel_ms": kernel_ms, "float_kernel_ms": float_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": ("torch.nn.LSTM 1 layer in bf16 (cuDNN; includes "
                           "its input projection)"
                           + (" on pack_padded_sequence" if masked else "")),
               "library_refused": library_refused,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        results.append(rec)
        tag = f"{name} H={H} B={B} T={T}"
        if not no_stack_no_spill(ptxas):
            failures.append(f"{tag}: the ptxas report of its bf16 "
                            f"instantiation shows a stack frame or spills")
        if not finite:
            failures.append(f"{tag}: non-finite output")
        if masked_nonzero:
            failures.append(f"{tag}: {masked_nonzero} masked outputs are "
                            "not zero")
        if step_ulps > BF16_STEP_ULPS:
            failures.append(f"{tag}: one step {step_ulps} ulps > "
                            f"{BF16_STEP_ULPS}")
        if ulps > BF16_ULPS:
            failures.append(f"{tag}: {ulps} ulps > {BF16_ULPS}")

    # #9 on the trio's cells, and the bf16 layer entries on the same cells
    T, B, hs = 45, 256, _ROW_H
    offs = [sum(4 * h for h in hs[:i]) for i in range(len(hs))]
    geo = multicell_cuda.multicell_geometry(B, hs, dev)
    ptxas = ptxas_by_function(
        "multicell_scan.cu",
        f"multicell_scan_kernelILi{geo.lane_rows}ELi{geo.lane_cols}"
        f"ELi{geo.row_groups}ELb{int(geo.h_buffers == 1)}E", bf16=True)
    rng = np.random.RandomState(B + 11)
    x = bf(rng.randn(T, B, 4 * sum(hs)))
    ws = [bf(rng.uniform(-1 / math.sqrt(H), 1 / math.sqrt(H), (H, 4 * H)))
          for H in hs]
    h0s = [bf(np.tanh(rng.randn(B, H))) for H in hs]
    c0s = [bf(rng.randn(B, H) * 0.5) for H in hs]
    args = (x, ws, h0s, c0s, hs)
    step = (x[:1].contiguous(), ws, h0s, c0s, hs)
    step_ulps = ulps_apart(_flat(multicell_cuda.multicell_lstm(*step)),
                           _flat(multicell_cuda.multicell_lstm_plain(*step)))
    got = _flat(multicell_cuda.multicell_lstm(*args))
    torch.cuda.synchronize()
    want = _flat(multicell_cuda.multicell_lstm_plain(*args))
    ulps = ulps_apart(got, want)
    err = max(float((g.float().cpu() - w.float().cpu()).abs().max())
              for g, w in zip(got, want))
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

    per_module_diff = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(per_module(), got))
    args32 = (x.float(), [w.float() for w in ws], [h.float() for h in h0s],
              [c.float() for c in c0s], hs)
    with torch.no_grad():
        kernel_ms = time_ms(lambda: multicell_cuda.multicell_lstm(*args), 10)
        float_ms = time_ms(lambda: multicell_cuda.multicell_lstm(*args32),
                           10)
        per_module_ms = time_ms(per_module, 10)
        plain_ms = time_ms(lambda: multicell_cuda.multicell_lstm_plain(
            *args), 1, warmup=1)
    bound_ms, bound_by, flops, nbytes = multicell_bound(T, B, hs,
                                                        elem_bytes=2)
    rec = {"phase": "bf16_multicell_kernel", "name": "multicell_scan_bf16",
           "T": T, "B": B, "H": list(hs), "rows_per_group": geo.rows,
           "h_buffers": geo.h_buffers, "clusters": geo.clusters,
           "ptxas": ptxas, "step_err_ulps": step_ulps, "max_err_ulps": ulps,
           "max_abs_err": err, "step_tol_ulps": BF16_STEP_ULPS,
           "tol_ulps": BF16_ULPS, "per_module_max_abs_diff": per_module_diff,
           "kernel_ms": kernel_ms, "float_kernel_ms": float_ms,
           "per_module_kernels_ms": per_module_ms,
           "per_module": "bilstm_scan_bf16 H=256 + bilstm_scan_bf16 H=64 + "
                         "lstm_scan_bf16 H=256, one launch each",
           "plain_ms": plain_ms, "library_ms": None,
           "library": "none: no single PyTorch call computes five LSTM "
                      "cells of different H",
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
    emit(rec)
    results.append(rec)
    tag = f"multicell_scan_bf16 B={B}"
    if not no_stack_no_spill(ptxas):
        failures.append(f"{tag}: the ptxas report of its bf16 "
                        "instantiation shows a stack frame or spills")
    if step_ulps > BF16_STEP_ULPS or ulps > BF16_ULPS:
        failures.append(f"{tag}: {step_ulps} / {ulps} ulps")
    if per_module_diff != 0.0:
        failures.append(f"{tag}: differs from the bf16 layer entries by "
                        f"{per_module_diff}")
    # every bf16 instantiation of both libraries, whatever shape runs it
    spilled = {src: sorted(fn for fn, lines in ptxas_by_function(
                   src, "_kernel", bf16=True).items()
                   if not no_stack_no_spill({fn: lines}))
               for src in ("lstm_scan.cu", "multicell_scan.cu")}
    emit({"phase": "bf16_ptxas", "instantiations_with_stack_or_spill":
          spilled})
    if any(spilled.values()):
        failures.append(f"bf16 instantiations with a stack or spills: "
                        f"{spilled}")
    require(not failures, "; ".join(failures))
    return results


def phase_int8_bf16_kernels(torch, lstm_cuda):
    """The bf16-I/O entries of the W8A8 scans #4, #5 and #6 against their
    bf16 plain versions on the card, at the main path's shapes: #6 at T =
    45, B = 256 (H = 256 and 64), #4 at T = 45, B = 256 and 8, #5 at T =
    512, B = 64 (bi at H = 256 and 64, uni at 256) under a seeded ragged
    bf16 mask with an empty and a full row. Weights drawn like torch's
    init and quantized per column; inputs drawn in float32 and rounded to
    bf16. Three gates a shape: the outputs within INT8_BF16_ULPS bf16 ulp
    of the plain version's with at most INT8_BF16_DIFFER_SHARE of them
    differing; the bf16 entry's outputs equal to the float32 entry's on
    the same inputs widened, then rounded to bf16 (exactly 0.0: the same
    body, only the loads and stores differ); no stack and no spill in the
    ptxas report of the shape's bf16 instantiation (and, at the end, of
    every bf16 instantiation of the int8 source). Each shape also prints
    the residency of its bf16 instantiation beside the float32 one's (the
    wrappers take the float32 one's rows for both); the times of the
    kernel, the float32 int8 entry on the widened inputs, the float bf16
    entry on the dequantized bf16 weights (no PyTorch call computes a
    W8A8 scan, so these are the yardsticks), the plain version; and the
    bound with bf16 bytes at the int8 rate."""
    import numpy as np
    from mobileposer_tpu_torch.ops.quant import quantize_weight_int8
    L = lstm_cuda
    BF = torch.bfloat16
    dev = torch.device("cuda", 0)
    prefix = {"bilstm_scan_int8_bf16": "bilstm_layer",
              "lstm_scan_int8_bf16": "lstm_layer",
              "bilstm_scan_masked_int8_bf16": "bilstm_layer_masked",
              "lstm_scan_masked_int8_bf16": "lstm_layer_masked"}
    cases = [("bilstm_scan_int8_bf16", 256, 256, 45),
             ("bilstm_scan_int8_bf16", 64, 256, 45),
             ("lstm_scan_int8_bf16", 256, 256, 45),
             ("lstm_scan_int8_bf16", 256, 8, 45),
             ("bilstm_scan_masked_int8_bf16", 256, 64, 512),
             ("bilstm_scan_masked_int8_bf16", 64, 64, 512),
             ("lstm_scan_masked_int8_bf16", 256, 64, 512)]
    results, failures = [], []

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=dev, dtype=BF)

    for name, H, B, T in cases:
        bi, masked = name.startswith("bi"), "masked" in name
        n_dir = 2 if bi else 1
        kern = getattr(L, prefix[name] + "_int8")
        plain = getattr(L, prefix[name] + "_int8_plain")
        kern_float = getattr(L, prefix[name])
        geo = L.scan_geometry(n_dir, B, H, dev, masked=masked, int8=True)
        held = {"float32": L.max_active_clusters(H, geo.rows, 0, masked,
                                                 int8=True),
                "bf16": L.int8_bf16_max_active_clusters(H, geo.rows, 0,
                                                        masked)}
        kernel = ("lstm_scan_masked_int8_kernel" if masked
                  else "lstm_scan_int8_kernel")
        ptxas = ptxas_by_function("lstm_scan_int8.cu",
                                  f"{kernel}ILi{geo.m_tiles}E", bf16=True)
        rng = np.random.RandomState(H + B + T + 7)
        bound = 1.0 / math.sqrt(H)
        dirs = []
        for _ in range(n_dir):
            w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound,
                                                        (H, 4 * H)))
            dirs.append({"x": bf(rng.randn(T, B, 4 * H)),
                         "w": torch.from_numpy(w_q).to(dev),
                         "s": torch.from_numpy(w_s).to(dev),
                         "w_bf16": bf(w_q.astype(np.float32) * w_s),
                         "h0": bf(np.tanh(rng.randn(B, H))),
                         "c0": bf(rng.randn(B, H) * 0.5)})
        lengths = None
        if masked:
            lengths = rng.randint(1, T, size=B)
            lengths[0], lengths[1] = 0, T
            mask = (torch.arange(T)[:, None]
                    < torch.from_numpy(lengths)[None, :]).to(device=dev,
                                                            dtype=BF)

        def arguments(int8=True, widen=False):
            """The int8 kernel's arguments (widened to float32 with
            `widen`), or with int8=False the float bf16 kernel's."""
            def io(t):
                return t.float() if widen else t
            xs = [io(d["x"]) for d in dirs]
            ws = [d["w"] if int8 else d["w_bf16"] for d in dirs]
            scales = [d["s"] for d in dirs] if int8 else []
            state = [io(v) for d in dirs for v in (d["h0"], d["c0"])]
            m = [io(mask)] if masked else []
            return (*xs, *ws, *scales, *state, *m)

        args = arguments()
        got = _flat(kern(*args))
        torch.cuda.synchronize()
        want = _flat(plain(*args))
        ulps = ulps_apart(got, want)
        differ = sum(int((g != w).sum()) for g, w in zip(got, want))
        share = differ / sum(g.numel() for g in got)
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        widened = _flat(kern(*arguments(widen=True)))
        identity = max(float((g.float() - w.to(BF).float()).abs().max())
                       for g, w in zip(got, widened))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        masked_nonzero = (sum(int((y[mask == 0] != 0).sum())
                              for y in got[:n_dir]) if masked else 0)
        n = 5 if masked else 20
        with torch.no_grad():
            kernel_ms = time_ms(lambda: kern(*args), n)
            args32 = arguments(widen=True)
            int8_f32_ms = time_ms(lambda: kern(*args32), n)
            args_float = arguments(int8=False)
            float_ms = time_ms(lambda: kern_float(*args_float), n)
            plain_ms = time_ms(lambda: plain(*args), 1, warmup=1)
        bound_ms, bound_by, ops, nbytes = int8_layer_bound(
            n_dir, T, B, H, int(lengths.sum()) if masked else None,
            elem_bytes=2)
        rec = {"phase": "int8_bf16_kernel", "name": name, "T": T, "B": B,
               "H": H, "rows_per_cluster": geo.rows, "m_tiles": geo.m_tiles,
               "clusters": geo.clusters, "max_active_clusters": held,
               "ptxas": ptxas, "max_err_ulps": ulps,
               "tol_ulps": INT8_BF16_ULPS, "share_differing": share,
               "share_tol": INT8_BF16_DIFFER_SHARE, "max_abs_err": err,
               "vs_f32_entry_rounded_max_abs": identity,
               "masked_steps_nonzero": masked_nonzero,
               "kernel_ms": kernel_ms, "int8_f32_kernel_ms": int8_f32_ms,
               "float_kernel_ms": float_ms, "plain_ms": plain_ms,
               "library_ms": None,
               "library": "none: no single PyTorch call computes a W8A8 "
                          "LSTM scan; yardsticks: the float32 int8 entry "
                          "on the widened inputs, the float bf16 entry on "
                          "the dequantized bf16 weights",
               "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        results.append(rec)
        tag = f"{name} H={H} B={B} T={T}"
        if not no_stack_no_spill(ptxas):
            failures.append(f"{tag}: the ptxas report of its bf16 "
                            "instantiation shows a stack frame or spills")
        if held["bf16"] != held["float32"]:
            failures.append(f"{tag}: the bf16 instantiation holds "
                            f"{held['bf16']} clusters, the float32 one "
                            f"{held['float32']}")
        if not finite:
            failures.append(f"{tag}: non-finite output")
        if masked_nonzero:
            failures.append(f"{tag}: {masked_nonzero} masked outputs are "
                            "not zero")
        if ulps > INT8_BF16_ULPS or share > INT8_BF16_DIFFER_SHARE:
            failures.append(f"{tag}: {ulps} ulps, {share:.4f} of the "
                            "outputs differing from the plain version")
        if identity != 0.0:
            failures.append(f"{tag}: differs from the float32 entry on the "
                            f"widened inputs, rounded, by {identity}")
    # every bf16 instantiation of the int8 source, whatever shape runs it
    spilled = sorted(fn for fn, lines in ptxas_by_function(
        "lstm_scan_int8.cu", "_kernel", bf16=True).items()
        if not no_stack_no_spill({fn: lines}))
    emit({"phase": "int8_bf16_ptxas",
          "instantiations_with_stack_or_spill": spilled})
    if spilled:
        failures.append(f"bf16 int8 instantiations with a stack or spills: "
                        f"{spilled}")
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
        require(max(auto_errs.values()) == 0.0,
                f"fused B={B}: 'fused' differs from 'auto' by {auto_errs}")
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


def _eval_argv(int8: bool, bf16: bool, online_mode: str):
    """`cli.evaluate`'s arguments for one evaluation configuration (the
    trained fixture on the synthetic sequences)."""
    argv = ["--model", str(FIXTURE), "--dataset", "synthetic"]
    if int8:
        argv.append("--int8")
    if bf16:
        argv.append("--bf16")
    if online_mode != "exact":
        argv += ["--online-mode", online_mode]
    return argv


# Run inside a subprocess: one `cli.evaluate` on the CPU (the plain
# versions), its result written as JSON (the drift windows as pairs, since
# JSON keys are strings).
_CPU_EVAL = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from mobileposer_tpu_torch.cli import evaluate as eval_cli
t0 = time.perf_counter()
res = eval_cli.main(json.loads(sys.argv[2]))
with open(sys.argv[3], "w") as f:
    json.dump({"offline": res["offline"].tolist(),
               "online": res["online"].tolist(),
               "tran_errors": [[w, e] for w, e in res["tran_errors"].items()],
               "seconds": time.perf_counter() - t0}, f)
"""


class CpuEvals:
    """The CPU port's evaluation of every configuration phase 4 holds the
    card to, each a `cli.evaluate --online --tran --device cpu` in a
    process of its own, all started together with one torch thread each:
    the plain versions are thousands of small operations, and run one
    after another they took ~200 s of the script. They share one
    directory of synthetic sequences (`MP_PROCESSED`), which the card's
    runs read too. `result` waits for one; `wait` for all; `close` stops
    any still running and removes the directory."""

    CONFIGS = [(False, False, "exact"), (True, False, "exact"),
               (False, False, "carry"), (True, False, "carry"),
               (False, True, "exact"), (True, True, "exact")]

    def __init__(self, torch):
        self.dir = tempfile.TemporaryDirectory()
        write_eval_sequences(torch, Path(self.dir.name) / "synthetic.pt")
        env = {**os.environ, "MP_PROCESSED": self.dir.name,
               "OMP_NUM_THREADS": "1"}
        self.procs = {}
        for cfg in self.CONFIGS:
            out = Path(self.dir.name) / ("cpu_%d_%d_%s" % cfg)
            argv = _eval_argv(*cfg) + ["--online", "--tran", "--device",
                                       "cpu"]
            with open(out.with_suffix(".log"), "w") as log:
                self.procs[cfg] = (subprocess.Popen(
                    [sys.executable, "-c", _CPU_EVAL, str(ROOT),
                     json.dumps(argv), str(out.with_suffix(".json"))],
                    env=env, stdout=subprocess.DEVNULL, stderr=log), out)
        self.results = {}

    def result(self, int8: bool, bf16: bool, online_mode: str) -> dict:
        """The CPU result of one configuration: tables as arrays, drift
        windows as a dict, and the seconds its evaluation took."""
        import numpy as np
        cfg = (int8, bf16, online_mode)
        if cfg not in self.results:
            proc, out = self.procs[cfg]
            proc.wait(timeout=900)
            require(proc.returncode == 0, f"CPU evaluation {cfg} failed:\n"
                    f"{out.with_suffix('.log').read_text()[-3000:]}")
            res = json.loads(out.with_suffix(".json").read_text())
            self.results[cfg] = {
                "offline": np.asarray(res["offline"]),
                "online": np.asarray(res["online"]),
                "tran_errors": {w: e for w, e in res["tran_errors"]},
                "seconds": res["seconds"]}
        return self.results[cfg]

    def wait(self) -> None:
        for cfg in self.procs:
            self.result(*cfg)

    def close(self) -> None:
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.dir.cleanup()


def phase_eval(torch, lstm_cuda, cpu_evals, int8: bool = False,
               online_mode: str = "exact", bf16: bool = False):
    """The evaluation entry point on the card (with `--int8`: on W8A8
    params; with `--bf16`: on bf16 params, the tables and the drift
    windows held to the CPU port's within BF16_EVAL_ATOL,
    BF16_JITTER_ATOL and BF16_DRIFT_ATOL; with both, int8 on bf16 params
    (the int8 kernels' bf16 entries), within the sum of the bf16 and the
    int8 bounds, the two sources of a card-against-CPU difference; with
    online_mode='carry': `--online-mode carry`, whose ONLINE pass launches
    no LSTM kernel), held to the CPU port's result from `cpu_evals`
    (`CpuEvals`). Returns (the offline pass's launch counts, the online
    pass's, the card's result dict)."""
    import numpy as np
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.evaluation.pose_eval import _BUCKET, _groups

    suffix = ("int8_bf16" if int8 and bf16 else "int8" if int8
              else "bf16" if bf16 else "f32")
    n_groups = len(_groups(EVAL_LENGTHS, _BUCKET, 64))
    os.environ["MP_PROCESSED"] = cpu_evals.dir.name
    try:
        argv = _eval_argv(int8, bf16, "exact")
        expect = dict.fromkeys(lstm_cuda.launches, 0)
        expect[f"bilstm_scan_masked_{suffix}"] = 6 * n_groups
        expect[f"lstm_scan_masked_{suffix}"] = 2 * n_groups

        if online_mode == "exact":
            # offline alone: the main-path run the masked counters are
            # read on
            lstm_cuda.reset_launches()
            eval_cli.main(argv)
            torch.cuda.synchronize()
            offline = dict(lstm_cuda.launches)
            emit({"phase": "eval_offline_launches", "int8": int8,
                  "bf16": bf16,
                  "lengths": EVAL_LENGTHS,
                  "bucket_groups": n_groups, "launches": offline,
                  "expected_launches": expect})
            require(offline == expect,
                    f"offline evaluation launches {offline}, expected "
                    f"{expect}")
        else:
            offline = expect            # held in the exact mode's run
            argv += ["--online-mode", online_mode]

        # offline + ONLINE + drift on the card, against the CPU's
        lstm_cuda.reset_launches()
        t0 = time.perf_counter()
        card = eval_cli.main(argv + ["--online", "--tran"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        both = dict(lstm_cuda.launches)
    finally:
        del os.environ["MP_PROCESSED"]
    cpu = cpu_evals.result(int8, bf16, online_mode)
    cpu_s = cpu["seconds"]

    online = {k: both[k] - offline[k] for k in both}
    # ONLINE: each bucket group is one unfolded stream batch (S < 32) of
    # the group's longest sequence + 5 future frames: 6 bi launches per
    # 25-frame chunk, 2 uni launches per frame; carry mode launches none
    frames = [max(EVAL_LENGTHS[i] + 5 for i in chunk)
              for _, chunk in _groups([n + 5 for n in EVAL_LENGTHS],
                                      _BUCKET, 64)]
    expect_online = dict.fromkeys(lstm_cuda.launches, 0)
    if online_mode == "exact":
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
        if bf16:
            tol = np.full(cpu[k].shape, BF16_EVAL_ATOL)
            tol[6] = BF16_JITTER_ATOL
            if int8:
                tol += INT8_EVAL_RTOL * np.abs(cpu[k])
                tol[6] = BF16_JITTER_ATOL + INT8_JITTER_ATOL
        else:
            tol = EVAL_ATOL + rtol * np.abs(cpu[k])
            if int8:
                tol[6] = INT8_JITTER_ATOL
        errs[k] = float(np.max(np.abs(card[k] - cpu[k]) / tol))
    require(card["tran_errors"].keys() == cpu["tran_errors"].keys(),
            f"drift windows {sorted(card['tran_errors'])} vs "
            f"{sorted(cpu['tran_errors'])}")
    errs["tran_errors"] = max(
        [abs(card["tran_errors"][w] - cpu["tran_errors"][w])
         / (BF16_DRIFT_ATOL + (drift_rtol * abs(cpu["tran_errors"][w])
                               if int8 else 0.0) if bf16 else
            EVAL_ATOL + drift_rtol * abs(cpu["tran_errors"][w]))
         for w in cpu["tran_errors"]], default=0.0)
    emit({"phase": "eval", "int8": int8, "bf16": bf16,
          "online_mode": online_mode,
          "cpu": {"offline": cpu["offline"].tolist(),
                  "online": cpu["online"].tolist()} if bf16 else None,
          "lengths": EVAL_LENGTHS,
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
        require(e <= 1.0, f"eval {k} int8={int8} bf16={bf16} "
                          f"{online_mode}: card vs CPU beyond its "
                          f"tolerance (worst ratio {e})")
    return offline, online, card


def _card_vs_cpu_step(torch, body, batch, backend, init=None, dtype=None,
                      batch_dtype=None):
    """One concurrent train step on `backend` on the CPU port and on the
    card from identical params (the same seeded init on each device, in
    `dtype` when given, or with `init` the modules it names warm-started
    from its JAX-layout trees at the finetune lr), batch (its floating
    tensors cast to `batch_dtype` when given) and draws (one CPU generator
    seeded alike for both runs): {device: (losses, gradients, updated
    params, seconds, the optimizer's moments (mu, nu) per parameter)}."""
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.train.trainer import (
        MODULE_NAMES, _state_from_tree, init_train_state,
        make_multi_train_step, to_device)
    names = tuple(init) if init else MODULE_NAMES
    step = make_multi_train_step(body, backend=backend, module_names=names)
    outs = {}
    for dev in ("cpu", "cuda"):
        if init:
            states = {n: _state_from_tree(n, init[n], C.finetune_hypers.lr,
                                          dev) for n in names}
        else:
            states = {n: init_train_state(
                n, torch.Generator().manual_seed(3), C.train_hypers.lr, dev,
                **({"dtype": dtype} if dtype else {})) for n in names}
        b = to_device(batch, dev)
        if batch_dtype is not None:
            b = {k: v.to(batch_dtype) if v.is_floating_point() else v
                 for k, v in b.items()}
        t0 = time.perf_counter()
        states, losses = step(states, b, torch.Generator().manual_seed(4))
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        params = {n: list(states[n].params.parameters()) for n in names}
        outs[dev] = (
            {n: float(v) for n, v in losses.items()},
            {n: [p.grad.detach().cpu() for p in ps]
             for n, ps in params.items()},
            {n: [p.detach().cpu() for p in ps] for n, ps in params.items()},
            seconds,
            {n: [tuple(st[k].cpu() for k in ("mu", "nu") if k in st)
                 for st in (states[n].opt.state[p] for p in ps)]
             for n, ps in params.items()})
    return outs


def _step_rel_errors(outs):
    """(loss, gradient) errors of the card against the CPU in a
    `_card_vs_cpu_step` result, losses relative, each gradient tensor
    relative to its largest entry."""
    loss = {n: abs(outs["cuda"][0][n] - c) / abs(c)
            for n, c in outs["cpu"][0].items()}
    grad = {n: max(float((g - c).abs().max()) / float(c.abs().max())
                   for g, c in zip(outs["cuda"][1][n], cs))
            for n, cs in outs["cpu"][1].items()}
    return loss, grad


def _step_param_errors(outs, grad_rtol):
    """Max abs differences of the updated params, card against CPU, in a
    `_card_vs_cpu_step` result: over the entries whose CPU gradient
    exceeds `grad_rtol` of its tensor's largest (both devices move them
    alike) and over the others (which may move the other way, at most
    2 lr apart)."""
    errs = {"determined_max_abs": 0.0, "others_max_abs": 0.0}
    for n, grads in outs["cpu"][1].items():
        for gc, pg, pc in zip(grads, outs["cuda"][2][n], outs["cpu"][2][n]):
            big = gc.abs() > grad_rtol * float(gc.abs().max())
            d = (pg - pc).abs()
            if bool(big.any()):
                errs["determined_max_abs"] = max(errs["determined_max_abs"],
                                                 float(d[big].max()))
            if bool((~big).any()):
                errs["others_max_abs"] = max(errs["others_max_abs"],
                                             float(d[~big].max()))
    return errs


def phase_train(torch, lstm_cuda, train_cuda):
    """The training entry point on the card: `cli.train --concurrent
    --fast-dev-run --combine` on synthetic processed data (two steps at
    B = 256, one validation batch, the checkpoints and the combine), then
    `--bf16-residuals` the same way, the combined weights through the
    evaluation CLI, then one concurrent step on the card against the CPU
    port from identical params, batch and draws, on backend 'auto_train'
    and on 'auto_train_bf16res'. Returns the launch counts of the two
    training runs."""
    import numpy as np
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.cli import train as train_cli
    from mobileposer_tpu_torch.data import PoseDataset
    from mobileposer_tpu_torch.data.fixtures import \
        make_synthetic_processed_dataset
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
    from mobileposer_tpu_torch.train.trainer import MODULE_NAMES, \
        _train_val_split

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

        # the same on bf16 residuals (its run: the bf16res counters)
        ckpt16 = Path(tmp) / "ckpt_bf16res"
        lstm_cuda.reset_launches()
        train_cuda.reset_launches()
        t0 = time.perf_counter()
        train_cli.main(["--concurrent", "--fast-dev-run", "--bf16-residuals",
                        "--checkpoint-dir", str(ckpt16)])
        torch.cuda.synchronize()
        train16_s = time.perf_counter() - t0
        train16_launches = dict(train_cuda.launches)
        infer16_launches = dict(lstm_cuda.launches)
        records16 = [json.loads(ln) for ln in
                     (ckpt16 / "metrics.jsonl").read_text().splitlines()]
        n_ckpts16 = {m: len(list((ckpt16 / m).glob("epoch=*.npz")))
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
    steps_out = {b: _card_vs_cpu_step(torch, body, batch, b)
                 for b in ("auto_train", "auto_train_bf16res")}

    outs = steps_out["auto_train"]
    loss_rel, grad_rel = _step_rel_errors(outs)
    outs16 = steps_out["auto_train_bf16res"]
    loss16_rel, grad16_rel = _step_rel_errors(outs16)
    lr = C.train_hypers.lr
    # the updated params: entries whose gradient lies above the gradient
    # bound (relative to their tensor's largest) move alike; the rest at
    # most 2 lr apart (STEP_BF16RES_GRAD_RTOL's note)
    param16 = _step_param_errors(outs16, STEP_BF16RES_GRAD_RTOL)

    n_layer_dirs = sum((2 if cfg.bidirectional else 1) * cfg.n_layers
                       for cfg in MODULE_CONFIGS.values())
    steps = 2
    expect_train = dict.fromkeys(train_cuda.launches, 0)
    expect_train16 = dict(expect_train)
    for k in ("fwd", "bwd", "dw"):
        expect_train[f"lstm_train_{k}_f32"] = n_layer_dirs * steps
        expect_train16[f"lstm_train_{k}_bf16res"] = n_layer_dirs * steps
    # one validation batch on the inference route: the masked kernels,
    # 6 bidirectional layers and 2 velocity layers
    expect_infer = dict.fromkeys(lstm_cuda.launches, 0)
    expect_infer.update(bilstm_scan_masked_f32=6, lstm_scan_masked_f32=2)
    losses_ok = all(math.isfinite(r["train_loss"])
                    and math.isfinite(r["val_loss"])
                    for r in records + records16)
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
          "step_seconds": {d: outs[d][3] for d in outs}})
    emit({"phase": "train_bf16res", "train_cli_seconds": train16_s,
          "records": records16, "checkpoints": n_ckpts16,
          "train_launches": train16_launches,
          "expected_train_launches": expect_train16,
          "validation_launches": infer16_launches,
          "step_loss_rel_err": loss16_rel, "step_loss_rtol": STEP_LOSS_RTOL,
          "step_grad_rel_err": grad16_rel,
          "step_grad_rtol": STEP_BF16RES_GRAD_RTOL,
          "step_param_abs_err": param16,
          "step_param_atol": STEP_PARAM_ATOL,
          "step_param_others_bound": 2 * lr,
          "step_losses_card": outs16["cuda"][0],
          "step_seconds": {d: outs16[d][3] for d in outs16}})
    require(len(records) == 4 and len(records16) == 4 and losses_ok,
            f"training records {records}, {records16}: missing or "
            "non-finite losses")
    require(all(n == 1 for n in (*n_ckpts.values(), *n_ckpts16.values())),
            f"checkpoints per module {n_ckpts}, {n_ckpts16}, expected 1 "
            "each")
    require(train_launches == expect_train,
            f"training launches {train_launches}, expected {expect_train}")
    require(train16_launches == expect_train16,
            f"--bf16-residuals launches {train16_launches}, expected "
            f"{expect_train16}")
    require(infer_launches == expect_infer == infer16_launches,
            f"validation launches {infer_launches}, {infer16_launches}, "
            f"expected {expect_infer}")
    require(table["offline"].shape == (8, 2)
            and bool(np.isfinite(table["offline"]).all()),
            "evaluation of the trained weights: bad table")
    require(max(loss_rel.values()) <= STEP_LOSS_RTOL,
            f"train step losses card vs CPU: {loss_rel}")
    require(max(grad_rel.values()) <= STEP_GRAD_RTOL,
            f"train step gradients card vs CPU: {grad_rel}")
    require(max(loss16_rel.values()) <= STEP_LOSS_RTOL,
            f"bf16res train step losses card vs CPU: {loss16_rel}")
    require(max(grad16_rel.values()) <= STEP_BF16RES_GRAD_RTOL,
            f"bf16res train step gradients card vs CPU: {grad16_rel}")
    require(param16["determined_max_abs"] <= STEP_PARAM_ATOL
            and param16["others_max_abs"] <= 2 * lr * (1 + 1e-3),
            f"bf16res train step params card vs CPU: {param16}")
    return train_launches, train16_launches


def phase_slice(torch, lstm_cuda, int8: bool = False, bf16: bool = False):
    """The trained weights (W8A8-quantized with `int8`, from the same
    float32 weights on each device; with `bf16` too, the int8
    quantization of their bf16 cast, with a bf16 state and bf16 frames)
    through the streaming entry point on the card, against the CPU port;
    with both, carry mode too (no LSTM kernel). Returns the launch counts
    of the exact runs."""
    import numpy as np
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8

    dtype = torch.bfloat16 if bf16 else torch.float32
    tree = load_npz(FIXTURE)
    nets = {d: MobilePoserNet(device=d) for d in ("cuda", "cpu")}
    params = {d: params_from_jax(tree, device=d, dtype=dtype)
              for d in ("cuda", "cpu")}
    if int8:
        params = {d: quantize_params_int8(p) for d, p in params.items()}
    suffix, tol = (("int8_bf16", INT8_BF16_SLICE_TOL) if int8 and bf16
                   else ("int8", INT8_SLICE_TOL) if int8
                   else ("f32", SLICE_TOL))
    rng = np.random.RandomState(1)
    S = 8
    lstm_cuda.reset_launches()
    for mode, N, chunk in (("scan", 6, 25), ("unfolded", 7, 3)):
        states = {d: nets[d].init_online_state_batched(S, dtype)
                  for d in nets}
        for call in ("fresh", "continued"):
            frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
            before = dict(lstm_cuda.launches)
            outs = {}
            for d in ("cuda", "cpu"):
                outs[d], states[d] = nets[d].forward_online_sequence_batched(
                    params[d], states[d],
                    torch.from_numpy(frames).to(device=d, dtype=dtype),
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
                require(bool(torch.isfinite(g.float()).all()),
                        f"{mode} {nm}: non-finite")
                errs[nm] = float((g.float().cpu() - c.float()).abs().max())
            for nm, g, c in zip(states["cuda"]._fields, states["cuda"],
                                states["cpu"]):
                errs["state." + nm] = float(
                    (g.cpu().float() - c.float()).abs().max())
            ortho, ortho_cpu = (
                float((p @ p.transpose(-1, -2)
                       - torch.eye(3, device=p.device)).abs().max())
                for p in (outs[d][0].float() for d in ("cuda", "cpu")))
            emit({"phase": "slice", "int8": int8, "bf16": bf16, "mode": mode,
                  "call": call, "S": S,
                  "N": N, "chunk": chunk if mode == "unfolded" else None,
                  "max_abs_err": errs, "tol": tol,
                  "pose_orthonormal_err": ortho,
                  "cpu_pose_orthonormal_err": ortho_cpu, "launches": moved,
                  "expected_launches": expect})
            require(moved == expect,
                    f"{mode} {call}: launches {moved}, expected {expect}")
            worst = max(errs.values())
            require(worst <= tol,
                    f"{mode} {call} int8={int8} bf16={bf16}: card vs CPU "
                    f"max abs err {worst} > {tol}")
            # a bf16 pose is orthonormal to bf16's rounding of the r6d
            # normalization: as much as the CPU port's, to the slice's
            # tolerance
            require(ortho <= (ortho_cpu + tol if bf16 else 1e-4),
                    f"{mode} {call}: pose not orthonormal ({ortho}; CPU "
                    f"{ortho_cpu})")
    exact_launches = dict(lstm_cuda.launches)
    if bf16:
        # carry mode: the int8 cell steps in bf16, no LSTM kernel
        N = 10
        frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
        lstm_cuda.reset_launches()
        outs = {d: nets[d].forward_carry_sequence_batched(
                    params[d], nets[d].init_carry_state_batched(S, dtype),
                    torch.from_numpy(frames).to(device=d, dtype=dtype))[0]
                for d in ("cuda", "cpu")}
        torch.cuda.synchronize()
        moved = dict(lstm_cuda.launches)
        errs = {nm: float((g.float().cpu() - c.float()).abs().max())
                for nm, g, c in zip(("pose", "joints", "root", "contact"),
                                    outs["cuda"], outs["cpu"])}
        emit({"phase": "slice", "int8": int8, "bf16": bf16, "mode": "carry",
              "S": S, "N": N, "max_abs_err": errs, "tol": tol,
              "dtypes": [str(t.dtype) for t in outs["cuda"]],
              "launches": moved})
        require(not any(moved.values()),
                f"carry mode launched LSTM kernels: {moved}")
        require(all(bool(torch.isfinite(g.float()).all())
                    for g in outs["cuda"]), "carry: non-finite")
        require(max(errs.values()) <= tol,
                f"carry int8={int8} bf16={bf16}: card vs CPU {errs} > "
                f"{tol}")
    return exact_launches


def _serve_lockstep(srv, clients, frames):
    """Drive `srv` in lockstep over frames [T, S, 60]: each tick every
    client sends its frame, the server drains them all and ticks, and
    every client receives its reply. Returns the decoded replies
    [T, S, 77] (axis-angle, translation, contact) in client order."""
    import numpy as np
    T, S = frames.shape[:2]
    out = np.zeros((T, S, 77), np.float32)
    for t in range(T):
        for s, c in enumerate(clients):
            c.send_frame(frames[t, s])
        deadline = time.perf_counter() + 10
        while not srv.has_frame.all():
            srv._drain_requests()
            require(time.perf_counter() < deadline,
                    f"tick {t}: the requests did not arrive")
        srv.tick()
        for s, c in enumerate(clients):
            r = c.recv_pose()
            require(r is not None, f"tick {t}: no reply for stream "
                                   f"{c.stream_id}")
            out[t, s] = np.concatenate(r)
    return out


def _serve_direct(torch, net, params, mode, frames, slots, dtype=None):
    """The server's step and post step called directly on `net`'s device:
    frames [T, S, 60] of S streams in slots `slots`, every slot fed, the
    state and frames in `dtype` (float32 unless given; bf16 for bf16
    params, as the server runs them). Returns (replies [T, S, 77] like
    `_serve_lockstep`, the step's own outputs {pose [T,S,24,3,3], joints
    [T,S,24,3], root [T,S,3], contact [T,S,2]}, as float32), both in
    client order."""
    import numpy as np
    from mobileposer_tpu_torch.kinematics import rotation as R
    dtype = dtype or torch.float32
    T, S = frames.shape[:2]
    if mode == "carry":
        st, step = (net.init_carry_state_batched(S, dtype),
                    net.forward_carry_batched)
    else:
        st, step = (net.init_online_state_batched(S, dtype),
                    net.forward_online_batched)
    replies = np.zeros((T, S, 77), np.float32)
    outs = {"pose": [], "joints": [], "root": [], "contact": []}
    with torch.no_grad():
        for t in range(T):
            x = torch.zeros((S, 60))
            x[slots] = torch.from_numpy(frames[t])
            out, st = step(params, st, x.to(net.device).to(dtype))
            pose, _, root, contact = out
            aa = R.rotation_matrix_to_axis_angle(
                pose.reshape(-1, 3, 3)).reshape(S, 72)
            replies[t] = torch.cat([aa.float(), root.float(),
                                    contact.float()], 1).cpu().numpy()[slots]
            for k, v in zip(outs, out):
                outs[k].append(v.float().cpu().numpy()[slots])
    return replies, {k: np.stack(v) for k, v in outs.items()}


def _serve_paced(torch, net, params, smi, streams, mode, quantize,
                 pipelined, mesh=None):
    """The server at 30 Hz in its own thread (`run`), driven by a load
    generator that sends every stream's request each period from one
    socket and counts replies, both through the native batched UDP
    calls; after SERVE_WARMUP_S, a window of SERVE_SECONDS. Returns the
    window's rates and the server's percentiles over its ticks. With a
    `mesh`, the slots are sharded over it (phase 4k)."""
    import socket
    import threading

    import numpy as np
    from mobileposer_tpu_torch.native import ServingUDP
    from mobileposer_tpu_torch.stream import REQUEST_STRUCT, PoseServer

    srv = PoseServer(net, params, host="127.0.0.1", port=0,
                     max_streams=streams, tick_hz=30.0, mode=mode,
                     quantize=quantize, pipelined=pipelined, mesh=mesh)
    require(srv.stats()["native_udp"], "the server has no native UDP")
    thread = threading.Thread(target=srv.run, daemon=True)
    thread.start()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setblocking(False)
    for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
        sock.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
    udp = ServingUDP()
    rng = np.random.RandomState(0)
    burst = b"".join(REQUEST_STRUCT.pack(
        i, *(rng.randn(60) * 0.1).astype(np.float32).tolist())
        for i in range(streams))
    tokens = np.full(streams, ServingUDP.addr_token("127.0.0.1", srv.port),
                     np.uint64)
    period = 1.0 / 30.0

    def drive(seconds):
        sent = recv = 0
        t0 = time.perf_counter()
        next_t = t0
        while time.perf_counter() - t0 < seconds:
            if time.perf_counter() >= next_t:
                sent += udp.send(sock.fileno(), burst, streams,
                                 REQUEST_STRUCT.size, tokens)
                next_t += period
            recv += udp.drain_count(sock.fileno(), streams * 64)
            time.sleep(max(0.0, min(next_t - time.perf_counter(), 0.002)))
        return sent, recv, time.perf_counter() - t0

    try:
        drive(SERVE_WARMUP_S)
        time.sleep(0.5)
        udp.drain_count(sock.fileno(), streams * 1024)
        n0, f0 = srv._tick_n, srv._fetch_n
        sent, recv, elapsed = drive(SERVE_SECONDS)
        n1, f1 = srv._tick_n, srv._fetch_n
        time.sleep(0.5)              # replies to requests of the window
        recv += udp.drain_count(sock.fileno(), streams * 1024)
        stats = srv.stats()
    finally:
        srv.stop()
        thread.join(timeout=10)
        srv.close()
        sock.close()
    # the run holds fewer ticks than the rings, so they did not wrap
    require(n1 <= srv._tick_ms.size and f1 <= srv._fetch_ms.size,
            "the run outgrew the server's latency rings")
    tick = np.percentile(srv._tick_ms[n0:n1] if n1 > n0 else np.zeros(1),
                         [50, 90, 99])
    rec = {"phase": "serving_rate", "nvidia_smi": smi, "streams": streams,
           "shards": stats["shards"],
           "mode": mode, "int8": quantize == "int8",
           "pipelined": pipelined, "seconds": elapsed,
           "sustained_tick_hz": (n1 - n0) / elapsed,
           "requests_sent": sent, "replies_received": recv,
           "reply_rate": recv / max(sent, 1),
           "tick_ms_p50": float(tick[0]), "tick_ms_p90": float(tick[1]),
           "tick_ms_p99": float(tick[2]),
           "tick_budget_ms": stats["tick_budget_ms"]}
    if pipelined:
        fetch = np.percentile(srv._fetch_ms[f0:f1] if f1 > f0
                              else np.zeros(1), [50, 99])
        rec.update({"fetch_ms_p50": float(fetch[0]),
                    "fetch_ms_p99": float(fetch[1]),
                    "reply_lag_ms_p50": stats["reply_lag_ms_p50"],
                    "reply_lag_ms_p99": stats["reply_lag_ms_p99"],
                    "dropped_replies": stats["dropped_replies"],
                    "deferred_copies": stats["deferred_copies"],
                    "fetch_errors": stats["fetch_errors"]})
        require(stats["fetch_errors"] == 0,
                f"fetch errors: {stats.get('last_fetch_error')}")
    return rec


def _serve_tick_parts(torch, net, params, smi, streams, mode):
    """Host and host-plus-device ms per call, in back-to-back loops, of
    the server's step alone, its post step alone, and a whole pipelined
    tick of `streams` fed slots with no datagram to drain or send (the
    fetcher waits for each tick before the next)."""
    from mobileposer_tpu_torch.kinematics import rotation as R
    from mobileposer_tpu_torch.stream import PoseServer

    def host_and_total(fn, n=30):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"host_ms": (t1 - t0) / n * 1e3,
                "total_ms": (t2 - t0) / n * 1e3}

    frames = torch.randn(streams, 60, device=net.device) * 0.1
    if mode == "carry":
        state = [net.init_carry_state_batched(streams)]
        step = net.forward_carry_batched
    else:
        state = [net.init_online_state_batched(streams)]
        step = net.forward_online_batched

    def run_step():
        with torch.no_grad():
            out, state[0] = step(params, state[0], frames)

    pose = R.axis_angle_to_rotation_matrix(
        torch.randn(streams * 24, 3, device=net.device))
    srv = PoseServer(net, params, host="127.0.0.1", port=0,
                     max_streams=streams, mode=mode, pipelined=True)
    for s in range(streams):
        srv.id_of[s] = srv.slot_of[s] = s
        srv.addr_of[s] = 0
    srv._send_replies = lambda *a: 0

    def tick():
        srv.has_frame[:] = True
        srv.tick()
        while srv._fetch_q.qsize():
            time.sleep(0)

    try:
        rec = {"phase": "serving_tick_parts", "nvidia_smi": smi,
               "streams": streams, "mode": mode,
               "step": host_and_total(run_step),
               "post": host_and_total(
                   lambda: R.rotation_matrix_to_axis_angle(pose)),
               "tick": host_and_total(tick)}
    finally:
        srv.stop()
        srv.close()
    return rec


def serving_frames(seed: int):
    """The lockstep runs' frames [SERVE_TICKS, SERVE_STREAMS, 60]."""
    import numpy as np
    return (np.random.RandomState(seed).randn(SERVE_TICKS, SERVE_STREAMS, 60)
            * 0.1).astype(np.float32)


def serving_steps(torch, device: str, mode: str, quantize, slots):
    """The direct serving step of phase 4e's variant (mode, quantize) on
    `device`, the streams of `serving_frames(9)` in `slots`: its replies
    and step outputs (`_serve_direct`), and with int8 the step outputs on
    the trained fixture too (`trained_<output>`), as float32 arrays."""
    from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    net = MobilePoserNet(device=device)
    params = init_all_modules(torch.Generator().manual_seed(0),
                              device=device)
    frames = serving_frames(9)
    p = quantize_params_int8(params) if quantize else params
    replies, steps = _serve_direct(torch, net, p, mode, frames, slots)
    out = {"replies": replies, **steps}
    if quantize:
        p = quantize_params_int8(params_from_jax(load_npz(FIXTURE),
                                                 device=device))
        out.update({f"trained_{k}": v for k, v in _serve_direct(
            torch, net, p, mode, frames, slots)[1].items()})
    return out


_CPU_SERVE = """
import os, sys, time
os.nice(19)
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
t0 = time.perf_counter()
out = chip_smoke.serving_steps(torch, "cpu", sys.argv[2], sys.argv[3] or None,
                               list(range(chip_smoke.SERVE_STREAMS)))
np.savez(sys.argv[4], seconds=time.perf_counter() - t0, **out)
"""


class CpuServing:
    """The CPU port's direct serving steps that phase 4e holds the card's
    to (`serving_steps`, stream s in slot s), one process per variant with
    one torch thread each, started at the lowest priority right after the
    build so that they run on the cores the card's phases leave idle: in
    the script's own process they took ~130 s of phase 4e. `result` waits
    for one; `close` stops any still running and removes their files."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.procs = {}
        for mode, quantize in SERVE_VARIANTS:
            out = Path(self.dir.name) / f"{mode}_{quantize or 'f32'}"
            with open(out.with_suffix(".log"), "w") as log:
                self.procs[(mode, quantize)] = (subprocess.Popen(
                    [sys.executable, "-c", _CPU_SERVE, str(ROOT), mode,
                     quantize or "", str(out.with_suffix(".npz"))],
                    env=env, stdout=subprocess.DEVNULL, stderr=log), out)

    def result(self, mode: str, quantize) -> dict:
        import numpy as np
        proc, out = self.procs[(mode, quantize)]
        proc.wait(timeout=900)
        require(proc.returncode == 0, f"CPU serving {mode} {quantize} "
                f"failed:\n{out.with_suffix('.log').read_text()[-3000:]}")
        with np.load(out.with_suffix(".npz")) as f:
            return {k: f[k] for k in f.files}

    def close(self) -> None:
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.dir.cleanup()


def phase_serving(torch, lstm_cuda, smi, cpu_serving):
    """`PoseServer` on the card over loopback UDP with the full model
    (random weights from seed 0): SERVE_STREAMS `PoseClient`s in lockstep
    for SERVE_TICKS ticks in four variants (exact and carry, float32 and
    int8), each synchronous and pipelined. Replies must equal the direct
    step on the card exactly, pipelined must equal synchronous exactly,
    the card must match the CPU port (`cpu_serving`, a `CpuServing`)
    within the slice's gates, and the exact ticks must launch the layer
    kernels at their per-tick counts (carry: no LSTM kernel); the int8
    pose is held to the CPU on the trained fixture (see below). Then the
    paced rates, and `cli.serve` on the card. Returns the launch counts of
    the exact float32 and int8 runs."""
    import numpy as np
    from mobileposer_tpu_torch.cli import serve as serve_cli
    from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
    from mobileposer_tpu_torch.stream import PoseClient, PoseServer

    net = MobilePoserNet(device="cuda")
    params = init_all_modules(torch.Generator().manual_seed(0),
                              device="cuda")
    S, T = SERVE_STREAMS, SERVE_TICKS
    frames = serving_frames(9)
    serving_launches = {}
    for mode, quantize in SERVE_VARIANTS:
        suffix = "int8" if quantize else "f32"
        tol = INT8_SLICE_TOL if quantize else SLICE_TOL
        replies = {}
        for pipelined in (False, True):
            srv = PoseServer(net, params, host="127.0.0.1",
                             port=0, max_streams=S, mode=mode,
                             quantize=quantize, pipelined=pipelined)
            clients = [PoseClient(stream_id=1000 + s, port=srv.port,
                                  timeout=10.0) for s in range(S)]
            try:
                lstm_cuda.reset_launches()
                t0 = time.perf_counter()
                replies[pipelined] = _serve_lockstep(srv, clients, frames)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                moved = dict(lstm_cuda.launches)
                stats = srv.stats()
                slots = [srv.slot_of[c.stream_id] for c in clients]
            finally:
                for c in clients:
                    c.close()
                srv.stop()
                srv.close()
            expect = dict.fromkeys(lstm_cuda.launches, 0)
            if mode == "exact":
                expect[f"bilstm_scan_{suffix}"] = 6 * T
                expect[f"lstm_scan_{suffix}"] = 2 * T
                if not pipelined:
                    serving_launches[suffix] = moved
            emit({"phase": "serving_lockstep", "mode": mode,
                  "int8": quantize == "int8", "pipelined": pipelined,
                  "streams": S, "ticks": T, "seconds": seconds,
                  "launches": moved, "expected_launches": expect,
                  "native_udp": stats["native_udp"],
                  "tick_ms_p50": stats["tick_ms_p50"],
                  "tick_ms_p99": stats["tick_ms_p99"]})
            require(moved == expect, f"serving {mode} int8={quantize} "
                    f"pipelined={pipelined}: launches {moved}, expected "
                    f"{expect}")
            require(stats["native_udp"], "the server has no native UDP")
            require(bool(np.isfinite(replies[pipelined]).all()),
                    "non-finite replies")
        # the direct step on the card, and the CPU port's: the replies
        # equal the card's step bit for bit, and the card's step is held
        # to the CPU's on the step's own outputs, as phase 4 holds them
        # (an axis-angle reply passes through the log map, whose axis is
        # ill-conditioned near pi). The CPU fed stream s in slot s, the
        # card the server's slots: a row's arithmetic is the same in any
        # slot but for float32 rounding.
        card = serving_steps(torch, "cuda", mode, quantize, slots)
        cpu = cpu_serving.result(mode, quantize)
        outputs = ("pose", "joints", "root", "contact")
        vs_step = float(abs(replies[False] - card["replies"]).max())
        vs_sync = float(abs(replies[True] - replies[False]).max())
        vs_cpu = {k: float(abs(card[k] - cpu[k]).max()) for k in outputs}
        gated = dict(vs_cpu)
        trained = None
        if quantize:
            # A flip (tests/test_torch_quant.py) moves the poser's r6d by
            # ~1e-4, and the r6d -> rotation normalization divides by the
            # r6d columns' norms: random weights give small, ill-
            # conditioned columns, trained ones do not. So the int8 pose
            # is held to the CPU port on the trained fixture, the weights
            # INT8_SLICE_TOL was argued for (phase 4); the random-weight
            # pose difference is reported beside it.
            gated.pop("pose")
            trained = {k: float(abs(card[f"trained_{k}"]
                                    - cpu[f"trained_{k}"]).max())
                       for k in outputs}
            gated.update({f"trained_{k}": v for k, v in trained.items()})
        emit({"phase": "serving", "mode": mode, "int8": quantize == "int8",
              "streams": S, "ticks": T,
              "replies_vs_direct_step_max_abs": vs_step,
              "pipelined_vs_sync_max_abs": vs_sync,
              "card_vs_cpu_max_abs": vs_cpu,
              "card_vs_cpu_trained_fixture_max_abs": trained,
              "gated": sorted(gated), "tol": tol,
              "reply_vs_cpu_reply_max_abs": float(
                  abs(replies[False] - cpu["replies"]).max()),
              "cpu_seconds": float(cpu["seconds"])})
        require(vs_step == 0.0, f"serving {mode} int8={quantize}: replies "
                                f"differ from the direct step by {vs_step}")
        require(vs_sync == 0.0, f"serving {mode} int8={quantize}: "
                                f"pipelined differs from sync by {vs_sync}")
        require(max(gated.values()) <= tol,
                f"serving {mode} int8={quantize}: card vs CPU {gated} > "
                f"{tol}")

    mark("4e lockstep")
    # where a tick's host time goes, exact and carry float32
    for mode in ("exact", "carry"):
        emit(_serve_tick_parts(torch, net, params, smi, SERVE_STREAMS, mode))
    mark("4e tick parts")

    # paced rates: every variant at SERVE_STREAMS pipelined, exact float32
    # synchronous too; the exact path at 256 streams, float32 and int8
    runs = [(SERVE_STREAMS, m, q, True) for m, q in SERVE_VARIANTS]
    runs += [(SERVE_STREAMS, "exact", None, False),
             (256, "exact", None, True),
             (256, "exact", "int8", True)]
    for streams, mode, quantize, pipelined in runs:
        rec = _serve_paced(torch, net, params, smi, streams, mode, quantize,
                           pipelined)
        emit(rec)
        require(rec["replies_received"] > 0, "no reply in the paced run")
    mark("4e paced")

    # the serving CLI on the card, default device
    for flags in ([], ["--carry", "--int8", "--wire", "f16"]):
        stats = serve_cli.main(["--model", str(FIXTURE), "--host",
                                "127.0.0.1", "--port", "0",
                                "--duration", "0.5", *flags])
        emit({"phase": "serve_cli", "flags": flags, "stats": stats})
        require(stats["device"].startswith("cuda"),
                f"cli.serve ran on {stats['device']}")
    mark("4e cli")
    return serving_launches


def phase_bf16_slice(torch, lstm_cuda, multicell_cuda):
    """The bf16 slice on the card: the trained fixture cast to bf16
    (`params_from_jax(dtype=torch.bfloat16)`) through
    `forward_online_sequence_batched` in 'scan' mode at S = 256 and
    'unfolded' at S = 8, held to the CPU port on the same frames within
    BF16_SLICE_TOL, the bf16 layer counters moving by their per-window
    and per-frame counts; then `forward(backend='fused')` at B = 8 and 256
    against 'auto' on the card (exactly 0.0), 2 multicell and 2 bi bf16
    launches each, and the CPU port at B = 8. Returns (the streaming
    run's launch counts, the fused run's)."""
    import numpy as np
    from mobileposer_tpu_torch.models import MobilePoserNet, forward
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax

    BF = torch.bfloat16
    tree = load_npz(FIXTURE)
    nets = {d: MobilePoserNet(device=d) for d in ("cuda", "cpu")}
    params = {d: params_from_jax(tree, device=d, dtype=BF) for d in nets}
    rng = np.random.RandomState(4)
    lstm_cuda.reset_launches()
    for mode, S, N, chunk in (("scan", 256, 3, 25), ("unfolded", 8, 7, 3)):
        frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
        before = dict(lstm_cuda.launches)
        outs, states = {}, {}
        t0 = {}
        for d in ("cuda", "cpu"):
            t0[d] = time.perf_counter()
            outs[d], states[d] = nets[d].forward_online_sequence_batched(
                params[d], nets[d].init_online_state_batched(S, BF),
                torch.from_numpy(frames).to(device=d, dtype=BF), mode=mode,
                chunk=chunk)
            if d == "cuda":
                torch.cuda.synchronize()
            t0[d] = time.perf_counter() - t0[d]
        moved = {k: lstm_cuda.launches[k] - before[k] for k in before}
        n_windows = N if mode == "scan" else -(-N // chunk)
        expect = dict.fromkeys(lstm_cuda.launches, 0)
        expect["bilstm_scan_bf16"] = 6 * n_windows
        expect["lstm_scan_bf16"] = 2 * N
        errs = {}
        for nm, g, c in zip(("pose", "joints", "root", "contact"),
                            outs["cuda"], outs["cpu"]):
            require(tuple(g.shape) == tuple(c.shape) and g.dtype == c.dtype,
                    f"bf16 {mode} {nm}: {g.dtype} {tuple(g.shape)} vs "
                    f"{c.dtype} {tuple(c.shape)}")
            require(bool(torch.isfinite(g.float()).all()),
                    f"bf16 {mode} {nm}: non-finite")
            errs[nm] = float((g.float().cpu() - c.float()).abs().max())
        state_errs = {nm: float((g.float().cpu() - c.float()).abs().max())
                      for nm, g, c in zip(states["cuda"]._fields,
                                          states["cuda"], states["cpu"])}
        dtypes = {nm: str(t.dtype) for nm, t in
                  zip(states["cuda"]._fields, states["cuda"])}
        emit({"phase": "bf16_slice", "mode": mode, "S": S, "N": N,
              "chunk": chunk if mode == "unfolded" else None,
              "max_abs_err": errs, "tol": BF16_SLICE_TOL,
              "state_max_abs_err": state_errs, "state_dtypes": dtypes,
              "card_seconds": t0["cuda"], "cpu_seconds": t0["cpu"],
              "launches": moved, "expected_launches": expect})
        require(moved == expect,
                f"bf16 {mode}: launches {moved}, expected {expect}")
        require(max(errs.values()) <= BF16_SLICE_TOL,
                f"bf16 {mode}: card vs CPU {errs} > {BF16_SLICE_TOL}")
        require(dtypes["vel_h"] == "torch.bfloat16"
                and dtypes["last_root_pos"] == "torch.float32",
                f"bf16 {mode}: state dtypes {dtypes}")
    stream_launches = dict(lstm_cuda.launches)

    # the fused single-window forward in bf16: 'fused' equals 'auto'
    def counts():
        return {**lstm_cuda.launches, **multicell_cuda.launches}

    T = 45
    imu = (rng.randn(256, T, 60) * 0.1).astype(np.float32)
    hc = (np.tanh(rng.randn(2, 256, 256)), rng.randn(2, 256, 256) * 0.5)
    lstm_cuda.reset_launches()
    multicell_cuda.reset_launches()
    for B in (8, 256):
        def inputs(d):
            return (torch.from_numpy(imu[:B]).to(device=d, dtype=BF),
                    tuple(torch.from_numpy(a[:, :B].astype(np.float32)).to(
                        device=d, dtype=BF) for a in hc))

        x, carry = inputs("cuda")
        before = counts()
        card = forward(params["cuda"], x, nets["cuda"].body_model,
                       vel_h0c0=carry, backend="fused")
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in counts().items()}
        expect = dict.fromkeys(moved, 0)
        expect.update(multicell_scan_bf16=2, bilstm_scan_bf16=2)
        auto = forward(params["cuda"], x, nets["cuda"].body_model,
                       vel_h0c0=carry, backend="auto")
        card, auto = ([*o[:4], *o[4]] for o in (card, auto))
        auto_diff = max(float((g.float() - a.float()).abs().max())
                        for g, a in zip(card, auto))
        cpu_errs = None
        if B == 8:
            x_cpu, carry_cpu = inputs("cpu")
            cpu = forward(params["cpu"], x_cpu, nets["cpu"].body_model,
                          vel_h0c0=carry_cpu, backend="fused")
            cpu_errs = {nm: float((g.float().cpu() - c.float()).abs().max())
                        for nm, g, c in zip(("pose", "joints", "vel",
                                             "contact"), card, cpu)}
        emit({"phase": "bf16_fused", "B": B, "T": T,
              "max_abs_diff_vs_auto_on_card": auto_diff,
              "max_abs_err_vs_cpu": cpu_errs, "tol": BF16_SLICE_TOL,
              "dtypes": [str(t.dtype) for t in card],
              "launches": moved, "expected_launches": expect})
        require(moved == expect,
                f"bf16 fused B={B}: launches {moved}, expected {expect}")
        require(auto_diff == 0.0,
                f"bf16 fused B={B}: 'fused' differs from 'auto' by "
                f"{auto_diff}")
        require(all(bool(torch.isfinite(g.float()).all()) for g in card),
                f"bf16 fused B={B}: non-finite")
        if cpu_errs is not None:
            require(max(cpu_errs.values()) <= BF16_SLICE_TOL,
                    f"bf16 fused B={B}: card vs CPU {cpu_errs}")
    return stream_launches, counts()


def phase_bf16_serving(torch, lstm_cuda, smi, quantize=None):
    """`PoseServer` on bf16 params (random weights from seed 0, cast; with
    quantize='int8' the server quantizes the cast, int8 on bf16 params) on
    the card: SERVE_STREAMS `PoseClient`s in lockstep for SERVE_TICKS
    ticks, exact and carry, synchronous and pipelined, the server in bf16
    (state, frames, step) with float32 replies equal to the direct bf16
    step on the card exactly, pipelined equal to synchronous, 6 bi + 2 uni
    bf16 launches (of the int8 kernels' bf16 entries with int8) per exact
    tick and none in carry mode; then the paced 30 Hz runs at
    SERVE_STREAMS, exact and carry (reply rate, tick p50); then
    `cli.serve --bf16` and `cli.serve --carry --bf16` (with `--int8`) on
    the card. Returns the launch counts of the exact synchronous run."""
    import numpy as np
    from mobileposer_tpu_torch.cli import serve as serve_cli
    from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
    from mobileposer_tpu_torch.nn import cast_params
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    from mobileposer_tpu_torch.stream import PoseClient, PoseServer

    BF = torch.bfloat16
    int8 = quantize == "int8"
    suffix = "int8_bf16" if int8 else "bf16"
    net = MobilePoserNet(device="cuda")
    params = cast_params(init_all_modules(torch.Generator().manual_seed(0),
                                          device="cuda"), BF)
    # what the server steps on: it quantizes the cast it is given
    stepped = quantize_params_int8(params) if int8 else params
    S, T = SERVE_STREAMS, SERVE_TICKS
    frames = serving_frames(12)
    serving_launches = {}
    for mode in ("exact", "carry"):
        replies = {}
        for pipelined in (False, True):
            srv = PoseServer(net, params, host="127.0.0.1", port=0,
                             max_streams=S, mode=mode, pipelined=pipelined,
                             quantize=quantize)
            clients = [PoseClient(stream_id=2000 + s, port=srv.port,
                                  timeout=10.0) for s in range(S)]
            try:
                require(srv.dtype == BF, f"bf16 server dtype {srv.dtype}")
                lstm_cuda.reset_launches()
                replies[pipelined] = _serve_lockstep(srv, clients, frames)
                torch.cuda.synchronize()
                moved = dict(lstm_cuda.launches)
                stats = srv.stats()
                slots = [srv.slot_of[c.stream_id] for c in clients]
            finally:
                for c in clients:
                    c.close()
                srv.stop()
                srv.close()
            expect = dict.fromkeys(lstm_cuda.launches, 0)
            if mode == "exact":
                expect[f"bilstm_scan_{suffix}"] = 6 * T
                expect[f"lstm_scan_{suffix}"] = 2 * T
                if not pipelined:
                    serving_launches = moved
            emit({"phase": "bf16_serving_lockstep", "int8": int8,
                  "mode": mode,
                  "pipelined": pipelined, "streams": S, "ticks": T,
                  "launches": moved, "expected_launches": expect,
                  "tick_ms_p50": stats["tick_ms_p50"]})
            require(moved == expect, f"bf16 serving {mode} pipelined="
                    f"{pipelined}: launches {moved}, expected {expect}")
            require(bool(np.isfinite(replies[pipelined]).all()),
                    "non-finite bf16 replies")
        direct, _ = _serve_direct(torch, net, stepped, mode, frames, slots,
                                  dtype=BF)
        vs_step = float(abs(replies[False] - direct).max())
        vs_sync = float(abs(replies[True] - replies[False]).max())
        emit({"phase": "bf16_serving", "int8": int8, "mode": mode,
              "streams": S,
              "ticks": T, "replies_vs_direct_step_max_abs": vs_step,
              "pipelined_vs_sync_max_abs": vs_sync})
        require(vs_step == 0.0, f"bf16 serving {mode}: replies differ from "
                                f"the direct bf16 step by {vs_step}")
        require(vs_sync == 0.0, f"bf16 serving {mode}: pipelined differs "
                                f"from sync by {vs_sync}")
    for mode in ("exact", "carry"):
        rec = _serve_paced(torch, net, params, smi, SERVE_STREAMS, mode,
                           quantize, True)
        rec["bf16"] = True
        emit(rec)
        require(rec["replies_received"] > 0, "no reply in the bf16 paced "
                                             "run")
    for flags in (["--bf16"], ["--carry", "--bf16"]):
        flags += ["--int8"] if int8 else []
        stats = serve_cli.main(["--model", str(FIXTURE), "--host",
                                "127.0.0.1", "--port", "0",
                                "--duration", "0.5", *flags])
        emit({"phase": "serve_cli", "flags": flags, "stats": stats})
        require(stats["device"].startswith("cuda"),
                f"cli.serve ran on {stats['device']}")
        require(stats["quantize"] == quantize,
                f"cli.serve {flags}: quantize {stats['quantize']}")
    return serving_launches


def _tree_max_abs(torch, a, b) -> float:
    """Max abs difference over every tensor leaf of two output/state
    trees of the same structure."""
    from torch.utils import _pytree as pytree
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    require(len(la) == len(lb), "trees of different structure")
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(la, lb))


def phase_bundle(torch, lstm_cuda):
    """The AOT serving bundle (`serving.py`) on the card, written to a
    temporary directory and loaded back, with the full model (random
    weights from seed 0): exact float32, int8 and bf16 at 256 streams and
    carry at 64 over BUNDLE_FRAMES frames against the eager step on the
    loaded weights (outputs and state), the loaded step's launches equal
    to the eager step's and to the expected counts of the variant's own
    entries; export + save, load and first-step seconds, and the steady
    step in ms, loaded against eager in turns (CUDA events); then the
    offline program, float32 and int8, on a BUNDLE_OFFLINE_GROUP ragged group
    against the eager `forward_offline_batched`; the archive sizes.
    Returns {kernel: launches in the loaded runs}."""
    import numpy as np
    from mobileposer_tpu_torch import bench, serving
    from mobileposer_tpu_torch.evaluation.pose_eval import \
        forward_offline_batched
    from mobileposer_tpu_torch.nn.convert import cast_params

    _, net, params = bench._net(0, "cuda")
    N, BF = BUNDLE_FRAMES, torch.bfloat16
    launches = dict.fromkeys(lstm_cuda.launches, 0)
    sizes = {}
    tmp = tempfile.TemporaryDirectory(prefix="bundle_")
    try:
        for mode, S, dtype_name, quantize, tol in BUNDLE_VARIANTS:
            name = f"{mode}_{dtype_name}_{quantize or 'float'}"
            dtype = getattr(torch, dtype_name)
            p_in = params if dtype == torch.float32 else \
                cast_params(params, dtype)
            t0 = time.perf_counter()
            out_dir = serving.save_bundle(
                Path(tmp.name) / name, net, p_in, n_streams=S, mode=mode,
                dtype=dtype, quantize=quantize)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            step, p, st0, meta = serving.load_bundle(out_dir)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            require(meta["device"] == "cuda" and p["joints"].linear1.weight
                    .is_cuda, f"bundle {name} loaded off the card")
            sizes[name] = os.path.getsize(out_dir / serving._WEIGHTS_FILE)
            frames = torch.from_numpy((np.random.RandomState(31).randn(
                N, S, 60) * 0.1).astype(np.float32)).to(net.device, dtype)
            eager_fn = (net.forward_carry_batched if mode == "carry"
                        else net.forward_online_batched)
            runs = {}
            with torch.no_grad():
                for which, fn in (("loaded", step), ("eager", eager_fn)):
                    st = serving._fresh_state(net, S, mode, dtype)
                    outs = []
                    lstm_cuda.reset_launches()
                    t0 = time.perf_counter()
                    for i in range(N):
                        out, st = fn(p, st, frames[i])
                        outs.append((out, st))
                        if i == 0:
                            torch.cuda.synchronize()
                            first_s = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    runs[which] = (outs, dict(lstm_cuda.launches), first_s)
                diff = max(_tree_max_abs(torch, a, b) for a, b in
                           zip(runs["loaded"][0], runs["eager"][0]))
                moved = runs["loaded"][1]
                expect = dict.fromkeys(lstm_cuda.launches, 0)
                if mode == "exact":
                    sfx = ("_int8" + ("_bf16" if dtype == BF else "")
                           if quantize else
                           "_bf16" if dtype == BF else "_f32")
                    expect[f"bilstm_scan{sfx}"] = 6 * N
                    expect[f"lstm_scan{sfx}"] = 2 * N
                for k, n in moved.items():
                    launches[k] += n
                # the steady step, loaded and eager in turns, on a fixed
                # state and frame
                st = serving._fresh_state(net, S, mode, dtype)
                times = {"loaded": [], "eager": []}
                for which in ("loaded", "eager", "eager", "loaded"):
                    fn = step if which == "loaded" else eager_fn
                    times[which].append(time_ms(
                        lambda: fn(p, st, frames[0]), BUNDLE_TIMED_STEPS))
            loaded_ms = min(times["loaded"])
            eager_ms = min(times["eager"])
            emit({"phase": "bundle", "name": name, "mode": mode,
                  "streams": S, "dtype": dtype_name,
                  "quantize": quantize, "frames": N,
                  "export_save_s": export_s, "load_s": load_s,
                  "first_step_s": runs["loaded"][2],
                  "eager_first_step_s": runs["eager"][2],
                  "max_abs_vs_eager": diff, "gate": tol,
                  "launches": {k: n for k, n in moved.items() if n},
                  "eager_launches": {k: n for k, n in
                                     runs["eager"][1].items() if n},
                  "step_ms_loaded": times["loaded"],
                  "step_ms_eager": times["eager"],
                  "loaded_over_eager": loaded_ms / eager_ms,
                  "weights_bytes": sizes[name]})
            require(diff <= tol, f"bundle {name}: loaded step {diff} from "
                                 f"the eager step (gate {tol})")
            require(moved == runs["eager"][1] == expect,
                    f"bundle {name}: launches {moved}, eager "
                    f"{runs['eager'][1]}, expected {expect}")

        # the offline program on a ragged group, float32 and int8
        _, net, params, imu, lengths, _ = bench._offline_setup(
            *BUNDLE_OFFLINE_GROUP, 0, "cuda")
        B, T = imu.shape[:2]
        for quantize in (None, "int8"):
            name = f"offline_float32_{quantize or 'float'}"
            t0 = time.perf_counter()
            out_dir = serving.save_bundle(
                Path(tmp.name) / name, net, params, n_streams=B,
                mode="offline", seq_len=T, quantize=quantize)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            step, p, _, meta = serving.load_bundle(out_dir)
            load_s = time.perf_counter() - t0
            sizes[name] = os.path.getsize(out_dir / serving._WEIGHTS_FILE)
            runs = {}
            with torch.no_grad():
                for which, fn in (
                        ("loaded", lambda: step(p, imu, lengths)),
                        ("eager", lambda: forward_offline_batched(
                            net, p, imu, lengths))):
                    lstm_cuda.reset_launches()
                    t0 = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                    runs[which] = (out, dict(lstm_cuda.launches),
                                   time.perf_counter() - t0)
                diff = _tree_max_abs(torch, runs["loaded"][0],
                                     runs["eager"][0])
                times = {"loaded": [], "eager": []}
                for which in ("loaded", "eager", "eager", "loaded"):
                    f = (lambda: step(p, imu, lengths)) \
                        if which == "loaded" else \
                        (lambda: forward_offline_batched(net, p, imu,
                                                         lengths))
                    times[which].append(time_ms(f, 3, warmup=1))
            moved = runs["loaded"][1]
            sfx = "_int8" if quantize else "_f32"
            expect = dict.fromkeys(lstm_cuda.launches, 0)
            expect[f"bilstm_scan_masked{sfx}"] = 6
            expect[f"lstm_scan_masked{sfx}"] = 2
            for k, n in moved.items():
                launches[k] += n
            emit({"phase": "bundle", "name": name, "mode": "offline",
                  "batch": B, "seq_len": T, "quantize": quantize,
                  "export_save_s": export_s, "load_s": load_s,
                  "first_call_s": runs["loaded"][2],
                  "max_abs_vs_eager": diff, "gate": BUNDLE_TOL,
                  "launches": {k: n for k, n in moved.items() if n},
                  "eager_launches": {k: n for k, n in
                                     runs["eager"][1].items() if n},
                  "call_ms_loaded": times["loaded"],
                  "call_ms_eager": times["eager"],
                  "loaded_over_eager": min(times["loaded"])
                  / min(times["eager"]),
                  "weights_bytes": sizes[name]})
            require(diff <= BUNDLE_TOL, f"bundle {name}: {diff} from the "
                                        "eager forward")
            require(moved == runs["eager"][1] == expect,
                    f"bundle {name}: launches {moved}, eager "
                    f"{runs['eager'][1]}, expected {expect}")
    finally:
        tmp.cleanup()
    ratio = sizes["exact_float32_int8"] / sizes["exact_float32_float"]
    emit({"phase": "bundle_sizes", "weights_bytes": sizes,
          "int8_over_float32": ratio})
    require(ratio < 0.45, f"the int8 archive is {ratio} of the float32 one")
    return launches


def _smooth_aa(rng, T: int, joints: int, step: float = 0.01):
    """[T, joints * 3] axis-angle trajectories: integrated small twists."""
    import numpy as np
    return np.cumsum(rng.normal(0.0, step, (T, joints * 3)),
                     axis=0).astype(np.float32)


def write_raw_datasets(root: Path, seed: int = 16) -> dict:
    """The four raw datasets in their public layouts under `root` (AMASS
    `*_poses.npz`, DIP-IMU and TotalCapture pickles, TotalCapture's
    `gt_skel_gbl_pos.txt`, IMUPoser pickles of tensors) at the sizes of
    RAW_*; returns the environment that points the processors at them
    and, under "one" and "one_amass", at copies holding the first
    sequence of each (CMU's first one has roots turned near pi)."""
    import pickle
    import shutil
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    amass, dip = root / "AMASS", root / "DIP_IMU"
    tc_imu, tc_raw, imup = root / "TC_IMU", root / "TC_raw", root / "IMUPoser"

    def amass_npz(path, T, fps, near_pi=False):
        path.parent.mkdir(parents=True, exist_ok=True)
        poses = _smooth_aa(rng, T, 52, 0.6 / fps)
        if near_pi:      # roots turned by 3.0 to 3.1 rad
            axis = np.array([0.6, 0.0, 0.8], np.float32)
            poses[:, :3] = axis * np.linspace(3.0, 3.1, T, dtype=np.float32
                                              )[:, None]
        np.savez(path, poses=poses,
                 trans=np.cumsum(rng.normal(0, 0.1 / fps, (T, 3)),
                                 axis=0).astype(np.float32),
                 betas=rng.normal(0, 0.5, 16).astype(np.float32),
                 mocap_framerate=np.float64(fps))

    i = 0
    for n, T, fps in RAW_AMASS:
        for _ in range(n):
            amass_npz(amass / "CMU" / f"{i:02d}" / f"motion_poses.npz", T,
                      fps, near_pi=(i == 0))
            i += 1
    for subject in ("s_01", "s_09", "s_10"):
        for motion in ("01.pkl", "02.pkl"):
            T = RAW_DIP_FRAMES
            acc = rng.normal(0, 3.0, (T, 17, 3))
            acc[1000:1003, 7] = np.nan
            ori = rng.normal(0, 0.5, (T, 17, 3, 3))
            (dip / subject).mkdir(parents=True, exist_ok=True)
            with open(dip / subject / motion, "wb") as f:
                pickle.dump({"imu_acc": acc, "imu_ori": ori,
                             "gt": _smooth_aa(rng, T, 24, 0.01)}, f)
    T = RAW_TC_FRAMES
    tc_imu.mkdir(parents=True)
    for motion in ("acting1", "freestyle1", "walking1"):
        with open(tc_imu / f"s1_{motion}.pkl", "wb") as f:
            pickle.dump({"ori": rng.normal(0, 0.5, (T, 6, 3, 3)),
                         "acc": rng.normal(0, 3.0, (T, 6, 3))}, f)
        if motion != "freestyle1":      # no AMASS poses: failed_to_process
            amass_npz(amass / "TotalCapture" / "S1" / f"{motion}_poses.npz",
                      T, 60)
        path = np.cumsum(rng.normal(0, 0.2, (T, 4, 3)), axis=0)   # inches
        (tc_raw / "S1" / motion).mkdir(parents=True)
        with open(tc_raw / "S1" / motion / "gt_skel_gbl_pos.txt", "w") as f:
            f.write("LeftFoot\tRightFoot\tSpine\tHead\t\n")
            for row in path:
                f.write("\t".join(" ".join("%.4f" % v for v in p)
                                  for p in row) + "\t\n")
    for pid in ("P1", "P9"):
        T = RAW_IMUPOSER_FRAMES
        (imup / pid).mkdir(parents=True)
        with open(imup / pid / "seq0.pkl", "wb") as f:
            pickle.dump({"imu": torch.from_numpy(rng.normal(
                0, 1, (T, 60)).astype(np.float32)),
                "pose": torch.from_numpy(_smooth_aa(rng, T, 24, 0.01)),
                "trans": torch.from_numpy(np.cumsum(rng.normal(
                    0, 0.003, (T, 3)), axis=0).astype(np.float32))}, f)

    # the first sequence of each dataset, for the CPU port's reference:
    # AMASS's CMU folder alone under "one_amass", the rest under "one"
    # (its AMASS folder holds the TotalCapture poses only)
    one = root / "one"
    for src, dst in (
            (amass / "CMU" / "00", one / "AMASS" / "CMU" / "00"),
            (amass / "TotalCapture" / "S1" / "acting1_poses.npz",
             one / "AMASS_TC" / "TotalCapture" / "S1" / "acting1_poses.npz"),
            (dip / "s_09" / "01.pkl", one / "DIP_IMU" / "s_09" / "01.pkl"),
            (tc_imu / "s1_acting1.pkl", one / "TC_IMU" / "s1_acting1.pkl"),
            (tc_raw / "S1" / "acting1", one / "TC_raw" / "S1" / "acting1"),
            (imup / "P9" / "seq0.pkl", one / "IMUPoser" / "P9" / "seq0.pkl")):
        dst.parent.mkdir(parents=True, exist_ok=True)
        (shutil.copytree if src.is_dir() else shutil.copy)(src, dst)
    env = {"MP_RAW_AMASS": amass, "MP_RAW_DIP": dip, "MP_RAW_TC": tc_raw,
           "MP_CALIB_TC": tc_imu, "MP_RAW_IMUPOSER": imup}
    return {"env": {k: str(v) for k, v in env.items()},
            "one": {"MP_RAW_AMASS": str(one / "AMASS_TC"),
                    "MP_RAW_DIP": str(one / "DIP_IMU"),
                    "MP_RAW_TC": str(one / "TC_raw"),
                    "MP_CALIB_TC": str(one / "TC_IMU"),
                    "MP_RAW_IMUPOSER": str(one / "IMUPoser")},
            "one_amass": {"MP_RAW_AMASS": str(one / "AMASS")}}


def _contact_band(joint):
    """[T, 2] True where a foot's displacement lies within CONTACT_BAND of
    the 0.008 threshold."""
    import numpy as np
    band = np.zeros((joint.shape[0], 2), bool)
    for i, j in enumerate((10, 11)):
        disp = np.linalg.norm(joint[1:, j] - joint[:-1, j], axis=1)
        band[1:, i] = np.abs(disp - 0.008) <= CONTACT_BAND
    return band


def _processed_errors(torch, card_path, cpu_path) -> dict:
    """Max errors of the card's processed file against the CPU port's on
    the sequences both hold (the CPU file holds the card's first ones):
    per key, acc relative to its largest magnitude, contact mismatches
    outside the threshold band and the frames left out."""
    import numpy as np
    a = torch.load(card_path, map_location="cpu", weights_only=True)
    b = torch.load(cpu_path, map_location="cpu", weights_only=True)
    require(sorted(a) == sorted(b), f"{card_path}: keys {sorted(a)} vs "
                                    f"{sorted(b)}")
    errs = {"sequences_compared": len(b["acc"]), "contact_mismatch": 0,
            "contact_band_frames": 0}
    for k in b:
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            x, y = x.numpy(), y.numpy()
            require(x.shape == y.shape and x.dtype == y.dtype,
                    f"{card_path} {k}: {x.shape} {x.dtype} vs {y.shape} "
                    f"{y.dtype}")
            if k == "contact":
                band = _contact_band(b["joint"][i].numpy())
                errs["contact_band_frames"] += int(band.sum())
                errs["contact_mismatch"] += int((x != y)[~band].sum())
                continue
            err = float(np.abs(x - y).max())
            if k == "acc":
                err /= max(float(np.abs(y).max()), 1e-30)
            errs[k] = max(errs.get(k, 0.0), err)
    return errs


def phase_recipe(torch, lstm_cuda, train_cuda):
    """The offline recipe on the card, at full width (the 6,890-vertex
    body, the full model): raw-format fixtures at the public datasets'
    sizes processed by `cli.process` for every dataset (frames/s and
    peak memory), the first sequence of each processed again on the CPU
    port and held to the card's files; every processed file read by
    `PoseDataset`; a base `cli.train --concurrent --fast-dev-run` on the
    processed AMASS data; `cli.finetune --dataset dip` sequential and
    `--concurrent`, `--dataset imuposer` chained off `finetuned_dip`;
    `combine_weights(finetune='dip')` and `cli.evaluate` on dip_test;
    `cli.example` offline and `--online`, on the trained fixture's
    weights held to the CPU port, and the scan kernels against their
    plain versions at its shapes;
    `cli.overfit --module poser`; one finetune step card against CPU.
    Returns the launch counts of the finetune, example and overfit runs,
    summed."""
    import shutil
    import numpy as np
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.cli import evaluate as eval_cli
    from mobileposer_tpu_torch.cli import example as example_cli
    from mobileposer_tpu_torch.cli import finetune as finetune_cli
    from mobileposer_tpu_torch.cli import overfit as overfit_cli
    from mobileposer_tpu_torch.cli import process as process_cli
    from mobileposer_tpu_torch.cli import train as train_cli
    from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
    from mobileposer_tpu_torch.data.process import fk_mesh_chunk
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
    from mobileposer_tpu_torch.models.utils import load_model
    from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
    from mobileposer_tpu_torch.train import combine_weights, \
        get_best_checkpoint
    from mobileposer_tpu_torch.train.trainer import _train_val_split

    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    saved_env = {k: os.environ.get(k) for k in (
        "MP_PROCESSED", "MP_RAW_AMASS", "MP_RAW_DIP", "MP_RAW_TC",
        "MP_CALIB_TC", "MP_RAW_IMUPOSER")}

    def layer_dirs(names):
        return sum((2 if MODULE_CONFIGS[n].bidirectional else 1)
                   * MODULE_CONFIGS[n].n_layers for n in names)

    def reset():
        lstm_cuda.reset_launches()
        train_cuda.reset_launches()

    def counts():
        return {**{k: n for k, n in lstm_cuda.launches.items() if n},
                **{k: n for k, n in train_cuda.launches.items() if n}}

    tmp = tempfile.TemporaryDirectory()
    try:
        root = Path(tmp.name)
        t0 = time.perf_counter()
        raw = write_raw_datasets(root / "raw")
        write_s = time.perf_counter() - t0
        card, cpu = root / "processed", root / "processed_cpu"

        # 1. every dataset on the card, timed, with its peak memory
        os.environ.update(raw["env"])
        os.environ["MP_PROCESSED"] = str(card)
        rates = {}
        for ds in ("amass", "dip", "totalcapture", "imuposer"):
            before = set(card.rglob("*.pt")) if card.exists() else set()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            process_cli.main(["--dataset", ds])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            files = sorted(set(card.rglob("*.pt")) - before)
            frames = sum(int(sum(x.shape[0] for x in torch.load(
                f, weights_only=True)["acc"])) for f in files)
            rates[ds] = {"files": [str(f.relative_to(card)) for f in files],
                         "output_frames": frames, "seconds": dt,
                         "frames_per_s": frames / dt,
                         "peak_memory_bytes":
                             torch.cuda.max_memory_allocated() - held}
        emit({"phase": "recipe_process", "raw_write_seconds": write_s,
              "fk_mesh_chunk_frames": fk_mesh_chunk(body.num_vertices),
              "num_vertices": body.num_vertices, "datasets": rates})
        expect_files = {
            "amass": ["CMU.pt", "TotalCapture.pt"],
            "dip": ["eval/dip_test.pt", "eval/dip_train.pt"],
            "totalcapture": ["eval/totalcapture.pt"],
            "imuposer": ["eval/imuposer_test.pt", "eval/imuposer_train.pt"]}
        for ds, want in expect_files.items():
            require(sorted(rates[ds]["files"]) == want,
                    f"cli.process --dataset {ds} wrote {rates[ds]['files']}")
        n_dip = len(range(6, RAW_DIP_FRAMES - 6, 2))
        require(rates["amass"]["output_frames"]
                == sum(n * T // (fps // 30) for n, T, fps in RAW_AMASS[:2])
                + 2 * RAW_TC_FRAMES // 2
                and rates["dip"]["output_frames"] == 6 * n_dip
                and rates["totalcapture"]["output_frames"] == 2 * RAW_TC_FRAMES
                and rates["imuposer"]["output_frames"]
                == 2 * RAW_IMUPOSER_FRAMES,
                f"processed frames {rates}")

        # 2. the first sequence of each dataset on the CPU port, held to
        # the card's files
        os.environ["MP_PROCESSED"] = str(cpu)
        for ds, extra, env in (
                ("amass", [], raw["one_amass"]),
                ("dip", ["--split", "test"], raw["one"]),
                ("totalcapture", [], raw["one"]),
                ("imuposer", ["--split", "test"], raw["one"])):
            os.environ.update(env)
            process_cli.main(["--dataset", ds, "--device", "cpu", *extra])
        errs = {}
        for rel in ("CMU.pt", "eval/dip_test.pt", "eval/totalcapture.pt",
                    "eval/imuposer_test.pt"):
            errs[rel] = _processed_errors(torch, card / rel, cpu / rel)
        emit({"phase": "recipe_process_vs_cpu", "errors": errs,
              "atol": PROCESS_ATOL, "acc_rtol": PROCESS_ACC_RTOL,
              "contact_band": CONTACT_BAND})
        for rel, e in errs.items():
            require(e["sequences_compared"] == 1
                    and e["contact_mismatch"] == 0
                    and e.get("acc", 0.0) <= PROCESS_ACC_RTOL
                    and all(v <= PROCESS_ATOL for k, v in e.items()
                            if k in ("pose", "ori", "joint", "tran",
                                     "shape")),
                    f"{rel} card vs CPU: {e}")

        # 3. every processed file through the dataset
        os.environ["MP_PROCESSED"] = str(card)
        sizes = {"train": len(PoseDataset(fold="train", body_model=body))}
        for ft in ("dip", "imuposer"):
            sizes[f"finetune_{ft}"] = len(PoseDataset(
                fold="train", finetune=ft, body_model=body))
        for ev in ("dip", "totalcapture", "imuposer"):
            sizes[f"evaluate_{ev}"] = len(PoseDataset(
                fold="test", evaluate=ev, body_model=body).windows)
        emit({"phase": "recipe_datasets", "samples_or_sequences": sizes})
        require(sizes["evaluate_dip"] == 4 and sizes["evaluate_totalcapture"]
                == 2 and sizes["evaluate_imuposer"] == 1
                and min(sizes.values()) > 0, f"datasets {sizes}")

        # 4. base training, the finetunes, combine, evaluate, example,
        # overfit
        ckpt = root / "ckpt"
        t0 = time.perf_counter()
        train_cli.main(["--concurrent", "--fast-dev-run",
                        "--checkpoint-dir", str(ckpt)])
        torch.cuda.synchronize()
        secs = {"base_train": time.perf_counter() - t0}
        shutil.copytree(ckpt, root / "ckpt_concurrent")
        reset()
        t0 = time.perf_counter()
        finetune_cli.main(["--dataset", "dip", "--fast-dev-run",
                           "--checkpoint-dir", str(ckpt)])
        torch.cuda.synchronize()
        secs["finetune_dip"] = time.perf_counter() - t0
        finetune_launches = counts()
        reset()
        t0 = time.perf_counter()
        finetune_cli.main(["--dataset", "dip", "--fast-dev-run",
                           "--concurrent", "--checkpoint-dir",
                           str(root / "ckpt_concurrent")])
        torch.cuda.synchronize()
        secs["finetune_dip_concurrent"] = time.perf_counter() - t0
        concurrent_launches = counts()
        t0 = time.perf_counter()
        finetune_cli.main(["--dataset", "imuposer", "--fast-dev-run",
                           "--checkpoint-dir", str(ckpt)])
        torch.cuda.synchronize()
        secs["finetune_imuposer"] = time.perf_counter() - t0
        records = {sub: [json.loads(ln) for ln in (
            ckpt / sub / "metrics.jsonl").read_text().splitlines()]
            for sub in ("finetuned_dip", "finetuned_imuposer")}
        records["concurrent"] = [json.loads(ln) for ln in (
            root / "ckpt_concurrent" / "finetuned_dip" / "metrics.jsonl"
        ).read_text().splitlines()]
        combined = combine_weights(ckpt, finetune="dip")
        t0 = time.perf_counter()
        table = eval_cli.main(["--model", str(combined), "--dataset", "dip"])
        torch.cuda.synchronize()
        secs["evaluate_dip"] = time.perf_counter() - t0
        example = {}
        for mode, extra in (("offline", []), ("online", ["--online"])):
            reset()
            t0 = time.perf_counter()
            path = example_cli.main(["--model", str(combined), "--dataset",
                                     "dip", "--out",
                                     str(root / f"motion_{mode}"), *extra])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            z = np.load(path)
            example[mode] = {"seconds": dt, "frames": int(z["pose_p"].shape[0]),
                             "frames_per_s": z["pose_p"].shape[0] / dt,
                             "launches": counts(),
                             "finite": bool(np.isfinite(z["pose_p"]).all()
                                            and np.isfinite(z["tran_p"]).all())}

        # `cli.example` on the trained fixture's weights, card against
        # CPU (EXAMPLE_ONLINE_CPU_FRAMES' note): offline through the CLI
        # on each device, online the card's CLI run against the CPU port
        # frame by frame over a prefix
        fixture_argv = ["--model", str(FIXTURE), "--dataset", "dip"]
        motions = {mode: dict(np.load(example_cli.main(
            [*fixture_argv, "--out", str(root / f"fixture_{mode}"), *extra])))
            for mode, extra in (("offline", []), ("online", ["--online"]))}
        t0 = time.perf_counter()
        cpu_path = example_cli.main(fixture_argv + [
            "--out", str(root / "fixture_offline_cpu"), "--device", "cpu"])
        secs["example_offline_cpu"] = time.perf_counter() - t0
        want = {"offline": dict(np.load(cpu_path))}
        t0 = time.perf_counter()
        net = MobilePoserNet(body, device="cpu")
        params = params_from_jax(load_model(str(FIXTURE)), device="cpu")
        imu = torch.as_tensor(EvalSequence(PoseDataset(
            fold="test", evaluate="dip", body_model=body, device="cpu"))[0][0])
        state, poses, trans = net.init_online_state(), [], []
        with torch.no_grad():
            for frame in imu[:EXAMPLE_ONLINE_CPU_FRAMES]:
                (p, _, tr, _), state = net.forward_online(params, state,
                                                          frame)
                poses.append(p)
                trans.append(tr)
        want["online"] = {"pose_p": torch.stack(poses).numpy(),
                          "tran_p": torch.stack(trans).numpy()}
        secs["example_online_cpu"] = time.perf_counter() - t0
        example_errs = {
            mode: {k: float(np.abs(motions[mode][k][:len(w[k])]
                                   - w[k]).max()) for k in w}
            for mode, w in want.items()}
        example_shapes_ok = all(
            motions["offline"][k].shape == w.shape
            for k, w in want["offline"].items())

        # the scan kernels against their plain versions at the example's
        # offline shapes (not counted: the counts above were read already)
        T_seq = example["offline"]["frames"]
        scan_errs = []
        for bi, T, H in ((True, T_seq, 256), (True, T_seq, 64),
                         (False, T_seq, 256)):
            err, finite = _scan_vs_plain(torch, *_scan_case(
                torch, lstm_cuda, np.random.RandomState(T + H), bi, T, 1, H))
            scan_errs.append({"name": "bilstm_scan_f32" if bi
                              else "lstm_scan_f32", "T": T, "B": 1, "H": H,
                              "max_abs_err": err, "finite": finite})
        reset()
        t0 = time.perf_counter()
        losses = overfit_cli.main(["--module", "poser", "--steps",
                                   str(OVERFIT_STEPS)])
        torch.cuda.synchronize()
        secs["overfit"] = time.perf_counter() - t0
        overfit_launches = counts()

        # 5. one finetune step, card against CPU
        ds = PoseDataset(fold="train", finetune="dip", body_model=body,
                         device="cpu")
        _, train_idx, _ = _train_val_split(len(ds), 0, 0.1)
        batch = ds._assemble(train_idx[:C.finetune_hypers.batch_size],
                             C.datasets.window_length)
        init = {n: load_npz(get_best_checkpoint(ckpt / n))
                for n in ("joints", "poser")}
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    step_outs = _card_vs_cpu_step(torch, body, batch, "auto_train", init)
    loss_rel, grad_rel = _step_rel_errors(step_outs)
    param_err = _step_param_errors(step_outs, STEP_GRAD_RTOL)
    lr = C.finetune_hypers.lr

    steps = 2
    ft = ("joints", "poser")
    expect_ft = {k: layer_dirs(ft) * steps for k in (
        "lstm_train_fwd_f32", "lstm_train_bwd_f32", "lstm_train_dw_f32")}
    expect_ft["bilstm_scan_masked_f32"] = sum(
        MODULE_CONFIGS[n].n_layers for n in ft)
    expect_overfit = {k: layer_dirs(["poser"]) * OVERFIT_STEPS for k in (
        "lstm_train_fwd_f32", "lstm_train_bwd_f32", "lstm_train_dw_f32")}
    expect_offline = {"bilstm_scan_f32": 6, "lstm_scan_f32": 2}
    n_online = example["online"]["frames"]
    emit({"phase": "recipe", "seconds": secs, "records": records,
          "eval_offline_table": table["offline"].tolist(),
          "example": example, "overfit_losses": losses,
          "example_vs_cpu_max_abs_err": example_errs,
          "example_online_cpu_frames": EXAMPLE_ONLINE_CPU_FRAMES,
          "example_tol": SLICE_TOL, "example_scan_vs_plain": scan_errs,
          "scan_tol": KERNEL_TOL,
          "finetune_launches": finetune_launches,
          "expected_finetune_launches": expect_ft,
          "finetune_concurrent_launches": concurrent_launches,
          "overfit_launches": overfit_launches,
          "expected_overfit_launches": expect_overfit,
          "finetune_step_batch": C.finetune_hypers.batch_size,
          "finetune_step_lr": C.finetune_hypers.lr,
          "finetune_step_loss_rel_err": loss_rel,
          "finetune_step_grad_rel_err": grad_rel,
          "step_loss_rtol": STEP_LOSS_RTOL, "step_grad_rtol": STEP_GRAD_RTOL,
          "finetune_step_param_abs_err": param_err,
          "step_param_atol": STEP_PARAM_ATOL,
          "step_param_others_bound": 2 * lr,
          "finetune_step_losses_card": step_outs["cuda"][0],
          "finetune_step_seconds": {d: o[3] for d, o in step_outs.items()}})
    require(all(math.isfinite(r["train_loss"]) for rs in records.values()
                for r in rs)
            and [r["module"] for r in records["finetuned_dip"]]
            == ["joints", "poser"]
            and all(r.get("concurrent") for r in records["concurrent"]),
            f"finetune records {records}")
    require(table["offline"].shape == (8, 2)
            and bool(np.isfinite(table["offline"]).all()),
            "evaluation of the finetuned weights: bad table")
    require(finetune_launches == expect_ft == concurrent_launches,
            f"finetune launches {finetune_launches}, concurrent "
            f"{concurrent_launches}, expected {expect_ft}")
    require(example["offline"]["launches"] == expect_offline,
            f"example offline launches {example['offline']['launches']}")
    require(example["online"]["launches"] == {
        k: n * n_online for k, n in expect_offline.items()},
        f"example online launches {example['online']['launches']} over "
        f"{n_online} frames")
    require(all(e["finite"] for e in example.values()),
            "cli.example exported non-finite values")
    require(example_shapes_ok and all(
        e <= SLICE_TOL for errs in example_errs.values()
        for e in errs.values()),
        f"cli.example card vs CPU: {example_errs} (tol {SLICE_TOL})")
    require(all(r["finite"] and r["max_abs_err"] <= KERNEL_TOL
                for r in scan_errs),
            f"scan kernels at the example's shapes: {scan_errs}")
    require(overfit_launches == expect_overfit,
            f"overfit launches {overfit_launches}, expected "
            f"{expect_overfit}")
    require(len(losses) == OVERFIT_STEPS and losses[-1] < losses[0],
            f"overfit losses did not fall: {losses}")
    require(max(loss_rel.values()) <= STEP_LOSS_RTOL,
            f"finetune step losses card vs CPU: {loss_rel}")
    require(max(grad_rel.values()) <= STEP_GRAD_RTOL,
            f"finetune step gradients card vs CPU: {grad_rel}")
    require(param_err["determined_max_abs"] <= STEP_PARAM_ATOL
            and param_err["others_max_abs"] <= 2 * lr * (1 + 1e-3),
            f"finetune step params card vs CPU: {param_err}")
    total = {}
    for run in (finetune_launches, example["offline"]["launches"],
                example["online"]["launches"], overfit_launches):
        for k, n in run.items():
            total[k] = total.get(k, 0) + n
    for name in ("bilstm_scan_f32", "lstm_scan_f32", "bilstm_scan_masked_f32",
                 "lstm_train_fwd_f32", "lstm_train_bwd_f32",
                 "lstm_train_dw_f32"):
        require(total.get(name, 0) > 0,
                f"{name} was never launched by the offline recipe")
    return total


def _walk_frames(rng, quats0, T: int, step: float):
    """T raw frames (quats wxyz [T,5,4]) of five devices whose orientations
    take a random walk of `step` rad from quats0 (wxyz [5,4])."""
    import numpy as np
    from mobileposer_tpu_torch.stream import quat_np as Q
    cur, out = np.array(quats0, np.float64), np.zeros((T, 5, 4))
    for t in range(T):
        for d in range(5):
            m = Q.quat_to_matrix(Q.quat_from_euler_xyz(
                rng.normal(0, step, 3))) @ Q.quat_to_matrix(cur[d, [1, 2, 3, 0]])
            cur[d] = Q.matrix_to_quat(m)[[3, 0, 1, 2]]
        out[t] = cur
    return out


def live_kernel_records(torch, lstm_cuda):
    """#1 and #2 at the live step's shapes (LIVE_SHAPES) against their
    plain versions, with kernel, plain and cuDNN times and the bound (not
    counted: the counters are reset before each main-path run)."""
    import numpy as np
    recs = []
    for bi, T, B, H in LIVE_SHAPES:
        kern, plain, args = _scan_case(torch, lstm_cuda,
                                       np.random.RandomState(T + B + H), bi,
                                       T, B, H)
        err, finite = _scan_vs_plain(torch, kern, plain, args)
        with torch.no_grad():
            kernel_ms = time_ms(lambda: kern(*args), 50)
            plain_ms = time_ms(lambda: plain(*args), 5, warmup=1)
        library_ms, _ = _lstm_library_ms(torch, H, B, T, bi, torch.float32)
        bound_ms, bound_by, flops, nbytes = layer_bound(2 if bi else 1, T, B,
                                                        H)
        rec = {"phase": "live_kernel", "name": "bilstm_scan_f32" if bi
               else "lstm_scan_f32", "T": T, "B": B, "H": H,
               "max_abs_err": err, "tol": KERNEL_TOL, "finite": finite,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "torch.nn.LSTM 1 layer (cuDNN, TF32 off; includes "
                          "its input projection)",
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        require(finite and err <= KERNEL_TOL,
                f"{rec['name']} at the live shape {(T, B, H)}: max abs err "
                f"{err} (tol {KERNEL_TOL}), finite {finite}")
        recs.append(rec)
    return recs


_LIVE_REPLAYER = """
import sys
from mobileposer_tpu_torch.stream import DeviceReplayer, synthetic_device_stream
DeviceReplayer().replay(synthetic_device_stream(int(sys.argv[1]), seed=3),
                        fps=float(sys.argv[2]))
"""


def phase_live(torch, lstm_cuda):
    """The live runtime on the card at full width (the official or the
    synthetic 6,890-vertex body, the full model on the trained fixture's
    weights), fed as deployed: a replayer process sends the five devices'
    raw packets (`DeviceReplayer(synthetic_device_stream)`) to the sensor
    frontend's process (`cli.calibration --native`: the native ingest,
    the rebroadcast to :7777), and the live process reads :7777
    (`IMUSet`). Here: #1 and #2 at the live step's shapes; a calibration
    from synthetic body-frame and T-pose holds, then LIVE_FRAMES recorded
    raw frames through `LivePoser.step_frame` on the card (6 + 2
    launches a frame, each step timed) and on the CPU port; meanwhile
    `cli.live_demo --save` runs as a process of its own, started once the
    card's part is timed; then the loop in this process, socket
    calibration and `run(record=True)`, pipelined and synchronous:
    frames, their rates and timings, the recording's schema. Returns
    (the kernel records, the launches of the two loop runs, summed)."""
    import shutil
    import numpy as np
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.models.utils import load_model
    from mobileposer_tpu_torch.nn.convert import params_from_jax
    from mobileposer_tpu_torch.stream import (
        IMUSet, LivePoser, compute_device_calibration, compute_smpl2imu)

    rng = np.random.RandomState(17)
    mount = rng.randn(5, 4)
    mount /= np.linalg.norm(mount, axis=1, keepdims=True)
    bias = rng.randn(5, 3)
    body_hold = _walk_frames(rng, mount, 90, 0.002)
    tpose_hold = _walk_frames(rng, mount, 90, 0.002)
    cal = compute_device_calibration(
        compute_smpl2imu(body_hold[:, 0].mean(axis=0)),
        tpose_hold.mean(axis=0),
        bias + rng.randn(90, 5, 3).mean(axis=0) * 0.1)
    quats = _walk_frames(rng, tpose_hold[-1], LIVE_FRAMES, 0.05)
    accs = bias[None] + rng.randn(LIVE_FRAMES, 5, 3) * 0.5

    tmp = Path(tempfile.mkdtemp())
    env = dict(os.environ, MP_ROOT=str(tmp), PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")]
                                  if x]))
    cal.save(tmp / "cal.npz")
    procs = {}

    def start(name, argv):
        procs[name] = subprocess.Popen(
            [sys.executable, *argv], cwd=tmp, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    try:
        # the sensor side, each a process of its own
        start("replayer", ["-c", _LIVE_REPLAYER, str(300 * LIVE_FPS),
                           str(LIVE_FPS)])
        start("frontend", ["-m", "mobileposer_tpu_torch.cli.calibration",
                           "--native", "--duration", "300"])

        # 1. the kernels at the live shapes; the step card against CPU
        # (the CLI's process starts once the card's part is timed)
        recs = live_kernel_records(torch, lstm_cuda)
        body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
        tree = load_model(str(FIXTURE))
        nets = {d: MobilePoserNet(body, device=d) for d in ("cuda", "cpu")}

        def poser(device, imu_set=None):
            return LivePoser(nets[device], params_from_jax(tree,
                                                           device=device),
                             imu_set=imu_set)

        def counts():
            return {k: n for k, n in lstm_cuda.launches.items() if n}

        outs, step_ms = {}, []
        for device in ("cuda", "cpu"):
            p = poser(device)
            p.set_calibration(cal)
            lstm_cuda.reset_launches()
            frames = []
            for q, a in zip(quats, accs):
                t0 = time.perf_counter()
                res = p.step_frame(q, a)
                if device == "cuda":
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                frames.append([x.cpu().numpy() for x in res])
            if device == "cuda":
                step_launches = counts()
                t_cli = time.perf_counter()
                start("cli", ["-m", "mobileposer_tpu_torch.cli.live_demo",
                              "--model", str(FIXTURE), "--calibration",
                              str(tmp / "cal.npz"), "--duration",
                              str(LIVE_CLI_SECONDS), "--save"])
            outs[device] = [np.stack(x) for x in zip(*frames)]
        names = ("pose", "joints", "tran", "contact")
        errs = {k: float(np.abs(g - w).max()) for k, g, w in zip(
            names, outs["cuda"], outs["cpu"])}
        finite = all(bool(np.isfinite(x).all()) for x in outs["cuda"])
        expect = {"bilstm_scan_f32": 6 * LIVE_FRAMES,
                  "lstm_scan_f32": 2 * LIVE_FRAMES}
        emit({"phase": "live_vs_cpu", "frames": LIVE_FRAMES,
              "max_abs_err": errs, "tol": SLICE_TOL,
              "launches": step_launches, "expected_launches": expect,
              "step_sync_ms_p50": float(np.percentile(step_ms, 50)),
              "step_sync_ms_p99": float(np.percentile(step_ms, 99)),
              "budget_ms": LIVE_BUDGET_MS, "finite": finite})
        require(finite, "the live step on the card gave non-finite values")
        require(all(e <= SLICE_TOL for e in errs.values()),
                f"live step card vs CPU: {errs} (tol {SLICE_TOL})")
        require(step_launches == expect,
                f"live step launches {step_launches}, expected {expect}")

        # 2. the CLI's session (the process frees :7777 when it exits)
        cli_out, _ = procs["cli"].communicate(timeout=300)
        cli_s = time.perf_counter() - t_cli
        saved = [ln.split("Session saved to ", 1)[1].strip()
                 for ln in cli_out.splitlines() if "Session saved to " in ln]
        z = dict(np.load(saved[0])) if saved else {}
        emit({"phase": "live_cli", "returncode": procs["cli"].returncode,
              "seconds": cli_s,
              "session": {k: list(v.shape) for k, v in z.items()},
              "output_tail": cli_out.splitlines()[-3:]})
        schema = {"acc": (5, 3), "ori": (5, 3, 3), "raw_acc": (5, 3),
                  "raw_ori": (5, 4), "pose": (24, 3, 3), "tran": (3,)}
        require(procs["cli"].returncode == 0 and saved,
                f"cli.live_demo exited {procs['cli'].returncode}: "
                f"{cli_out[-2000:]}")
        require(z["pose"].shape[0] > 0
                and all(bool(np.isfinite(z[k]).all()) for k in schema)
                and set(schema) | {"smpl2imu", "device2bone",
                                   "acc_offsets"} == set(z),
                f"cli.live_demo session {sorted(z)}")

        # 3. the loop in this process, pipelined then synchronous
        loop_launches = {}
        for pipelined in (True, False):
            p = poser("cuda", IMUSet(buffer_len=1))
            p.calibrate_body_frame(LIVE_CALIBRATE_S)
            loop_cal = p.calibrate_tpose(LIVE_CALIBRATE_S)
            lstm_cuda.reset_launches()
            rec = p.run(duration=LIVE_SECONDS, fps=LIVE_FPS, record=True,
                        pipelined=pipelined)
            launches = counts()
            n = int(rec["pose"].shape[0]) if rec["pose"].size else 0
            st = p.stats()
            mode = "pipelined" if pipelined else "synchronous"
            emit({"phase": "live_loop", "mode": mode, "frames": n,
                  "seconds": st["seconds"], "output_fps": st["output_fps"],
                  "target_fps": LIVE_FPS, "step_ms": st["step_ms"],
                  "fetch_ms": st["fetch_ms"], "budget_ms": LIVE_BUDGET_MS,
                  "sensor_fps": p.imu_set.clock.get_fps(),
                  "launches": launches,
                  "recording": {k: list(v.shape) for k, v in rec.items()},
                  "calibration_finite": bool(
                      np.isfinite(loop_cal.device2bone).all()
                      and np.isfinite(loop_cal.acc_offsets).all())})
            require(n > 0 and loop_cal is not None,
                    f"live loop ({mode}): no frames")
            require(all(rec[k].shape == (n, *sh) for k, sh in schema.items())
                    and all(bool(np.isfinite(v).all()) for v in rec.values()),
                    f"live loop ({mode}) recording: "
                    f"{ {k: v.shape for k, v in rec.items()} }")
            require(launches == {"bilstm_scan_f32": 6 * n,
                                 "lstm_scan_f32": 2 * n},
                    f"live loop ({mode}) launches {launches} over {n} frames")
            for k, v in launches.items():
                loop_launches[k] = loop_launches.get(k, 0) + v
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        side = {name: proc.communicate(timeout=60)[0]
                for name, proc in procs.items() if name != "cli"}
        shutil.rmtree(tmp, ignore_errors=True)
    native = ("native ingest unavailable" not in side["frontend"]
              and "listening" in side["frontend"])
    emit({"phase": "live_sensor_side", "native_ingest": native,
          "frontend_output_tail": side["frontend"].splitlines()[-3:],
          "replayer_output_tail": side["replayer"].splitlines()[-3:]})
    require(native, "the frontend process did not run the native ingest: "
                    f"{side['frontend'][-1000:]}")
    return recs, loop_launches


def _parallel_meshes(torch):
    """{name: mesh} of phase 4k: the card split into PARALLEL_SHARDS
    shards, and with more than one card every card."""
    from mobileposer_tpu_torch.parallel import make_mesh
    meshes = {"one_card": make_mesh(devices=["cuda:0"] * PARALLEL_SHARDS)}
    if torch.cuda.device_count() > 1:
        meshes["all_cards"] = make_mesh()
    return meshes


def _table_errors(got, want, int8: bool):
    """(max abs differences of the tables and the drift windows, the
    worst ratio to each entry's bound): PARALLEL_TOL in float32, the int8
    pins for int8 (INT8_EVAL_RTOL, the jitter row INT8_JITTER_ATOL, drift
    INT8_DRIFT_RTOL)."""
    import numpy as np
    diffs, worst = {}, 0.0
    for k in ("offline", "online"):
        d = np.abs(got[k] - want[k])
        tol = np.full(d.shape, PARALLEL_TOL)
        if int8:
            tol = EVAL_ATOL + INT8_EVAL_RTOL * np.abs(want[k])
            tol[6] = INT8_JITTER_ATOL
        diffs[k] = float(d.max())
        worst = max(worst, float((d / tol).max()))
    require(got["tran_errors"].keys() == want["tran_errors"].keys(),
            "sharded drift windows differ from one device's")
    for w, v in want["tran_errors"].items():
        d = abs(got["tran_errors"][w] - v)
        diffs[f"drift_{w}"] = d
        worst = max(worst, d / (EVAL_ATOL + INT8_DRIFT_RTOL * abs(v) if int8
                                else PARALLEL_TOL))
    return diffs, worst


def _parallel_eval(torch, lstm_cuda, meshes, smi):
    """Phase 4b's fixture and sequences through `evaluate_pose(mesh=...)`,
    float32 and int8: offline alone (the masked counters: shards x 6 bi +
    2 uni per bucket group), then offline + ONLINE + drift (ONLINE: each
    shard streams its rows of every group unfolded, 6 bi a 25-frame chunk
    and 2 uni a frame), the tables held to one device's. Returns the
    launch counts of the one-card mesh's runs."""
    from mobileposer_tpu_torch import config as Cfg
    from mobileposer_tpu_torch.data import EvalSequence, PoseDataset
    from mobileposer_tpu_torch.evaluation import evaluate_pose
    from mobileposer_tpu_torch.evaluation.pose_eval import _BUCKET, _groups
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.models.utils import load_model
    from mobileposer_tpu_torch.nn.convert import params_from_jax
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8

    tmp = tempfile.TemporaryDirectory()
    try:
        write_eval_sequences(torch, Path(tmp.name) / "synthetic.pt")
        net = MobilePoserNet(ParametricModel.from_file_or_synthetic(
            Cfg.paths.smpl_file), device="cuda")
        base = params_from_jax(load_model(str(FIXTURE)), device=net.device)
        ds = PoseDataset(fold="test", evaluate="dip",
                         body_model=net.body_model,
                         data_files=[Path(tmp.name) / "synthetic.pt"],
                         device=net.device)
        view = EvalSequence(ds)
        n_groups = len(_groups(EVAL_LENGTHS, _BUCKET, 64))
        frames = [max(EVAL_LENGTHS[i] + 5 for i in chunk)
                  for _, chunk in _groups([n + 5 for n in EVAL_LENGTHS],
                                          _BUCKET, 64)]
        launches = {}
        for int8 in (False, True):
            suffix = "int8" if int8 else "f32"
            params = quantize_params_int8(base) if int8 else base
            one = evaluate_pose(net, params, view, online=True,
                                evaluate_tran=True, verbose=False)
            for name, mesh in meshes.items():
                n = mesh.size
                lstm_cuda.reset_launches()
                evaluate_pose(net, params, view, verbose=False, mesh=mesh)
                torch.cuda.synchronize()
                offline = dict(lstm_cuda.launches)
                expect = dict.fromkeys(offline, 0)
                expect[f"bilstm_scan_masked_{suffix}"] = n * 6 * n_groups
                expect[f"lstm_scan_masked_{suffix}"] = n * 2 * n_groups
                lstm_cuda.reset_launches()
                got = evaluate_pose(net, params, view, online=True,
                                    evaluate_tran=True, verbose=False,
                                    mesh=mesh)
                torch.cuda.synchronize()
                both = dict(lstm_cuda.launches)
                online = {k: both[k] - offline[k] for k in both}
                expect_online = dict.fromkeys(offline, 0)
                expect_online[f"bilstm_scan_{suffix}"] = n * sum(
                    6 * -(-f // 25) for f in frames)
                expect_online[f"lstm_scan_{suffix}"] = n * sum(
                    2 * f for f in frames)
                diffs, worst = _table_errors(got, one, int8)
                # no seconds: three sequences are a correctness fixture,
                # not a size to time (_parallel_eval_rate times C3's group)
                emit({"phase": "parallel_eval", "nvidia_smi": smi,
                      "mesh": name, "shards": n,
                      "devices": sorted({str(d) for d in mesh.devices}),
                      "int8": int8, "lengths": EVAL_LENGTHS,
                      "max_abs_diff_vs_one_device": diffs,
                      "worst_diff_over_tol": worst,
                      "tol": "int8 pins" if int8 else PARALLEL_TOL,
                      "offline_launches": offline,
                      "expected_offline_launches": expect,
                      "online_launches": online,
                      "expected_online_launches": expect_online})
                require(offline == expect, f"sharded offline launches "
                                           f"{offline}, expected {expect}")
                require(online == expect_online,
                        f"sharded online launches {online}, expected "
                        f"{expect_online}")
                require(worst <= 1.0, f"{name} int8={int8}: sharded tables "
                                      f"differ from one device's: {diffs}")
                if name == "one_card":
                    for k in both:
                        launches[k] = launches.get(k, 0) + both[k]
    finally:
        tmp.cleanup()
    return launches


def _parallel_eval_rate(torch, meshes, smi):
    """The offline pass's seconds at C3's group (64 x 512, random weights
    from seed 0) on one device and over each mesh, each traced
    (`bench.run_offline_sharded`); the sharded predictions' checksum held
    to one device's at PARALLEL_TOL (relative)."""
    from mobileposer_tpu_torch import bench
    one = bench.run_offline_sharded()
    emit({"phase": "parallel_eval_rate", "nvidia_smi": smi, "mesh": None,
          **one})
    for name, mesh in meshes.items():
        rec = bench.run_offline_sharded(mesh)
        rel = abs(rec["checksum"] - one["checksum"]) / abs(one["checksum"])
        emit({"phase": "parallel_eval_rate", "nvidia_smi": smi,
              "mesh": name, "checksum_rel_diff_vs_one_device": rel,
              "seconds_over_one_device": rec["value"] / one["value"], **rec})
        require(rel <= PARALLEL_TOL, f"{name}: sharded C3 predictions' "
                                     f"checksum {rel} from one device's")


def _parallel_serving(torch, lstm_cuda, meshes, smi):
    """`PoseServer(mesh=...)` with the full model (random weights from
    seed 0): each PARALLEL_SERVE variant in lockstep for
    PARALLEL_SERVE_TICKS ticks against the unsharded server on the same
    frames (replies within PARALLEL_TOL, int8 INT8_SLICE_TOL; shards x 6 bi
    + 2 uni launches a tick in exact mode, none in carry mode) and one
    synchronous tick of each traced, then paced at 30 Hz, pipelined.
    Returns the one-card mesh's lockstep launches."""
    import numpy as np
    from mobileposer_tpu_torch import bench
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
    from mobileposer_tpu_torch.stream import PoseClient, PoseServer

    net = MobilePoserNet(ParametricModel.synthetic(), device="cuda")
    params = init_all_modules(torch.Generator().manual_seed(0),
                              device=net.device)
    launches = {}
    for mode, streams, quantize in PARALLEL_SERVE:
        suffix = "int8" if quantize else "f32"
        rng = np.random.RandomState(streams)
        frames = (rng.randn(PARALLEL_SERVE_TICKS, streams, 60) * 0.1
                  ).astype(np.float32)
        for name, mesh in meshes.items():
            replies, counts, traces = {}, {}, {}
            for which, m in (("one", None), ("sharded", mesh)):
                srv = PoseServer(net, params, host="127.0.0.1", port=0,
                                 max_streams=streams, mode=mode,
                                 quantize=quantize, mesh=m)
                clients = [PoseClient(stream_id=s, port=srv.port)
                           for s in range(streams)]
                try:
                    lstm_cuda.reset_launches()
                    replies[which] = _serve_lockstep(srv, clients, frames)
                    torch.cuda.synchronize()
                    counts[which] = dict(lstm_cuda.launches)

                    def one_tick():
                        srv.has_frame[:] = True
                        srv.tick()
                    # one synchronous tick, every slot fed, traced: its
                    # wall time, host time and each card's busy share
                    traces[which] = bench._traced(
                        one_tick, m.distinct if m else [net.device])
                finally:
                    for c in clients:
                        c.close()
                    srv.stop()
                    srv.close()
            diff = float(np.abs(replies["sharded"] - replies["one"]).max())
            tol = INT8_SLICE_TOL if quantize else PARALLEL_TOL
            n = mesh.size
            expect = dict.fromkeys(counts["one"], 0)
            if mode == "exact":
                expect[f"bilstm_scan_{suffix}"] = n * 6 * PARALLEL_SERVE_TICKS
                expect[f"lstm_scan_{suffix}"] = n * 2 * PARALLEL_SERVE_TICKS
            emit({"phase": "parallel_serving_lockstep", "nvidia_smi": smi,
                  "mesh": name, "shards": n, "mode": mode,
                  "streams": streams, "int8": quantize == "int8",
                  "ticks": PARALLEL_SERVE_TICKS,
                  "replies_max_abs_diff_vs_one_device": diff, "tol": tol,
                  "launches": counts["sharded"],
                  "expected_launches": expect,
                  "one_device_launches": counts["one"],
                  "traced_tick": traces["sharded"],
                  "one_device_traced_tick": traces["one"]})
            require(diff <= tol, f"{name} {mode} {quantize}: sharded replies "
                                 f"differ from one device's by {diff}")
            require(counts["sharded"] == expect,
                    f"{name} {mode} {quantize}: launches "
                    f"{counts['sharded']}, expected {expect}")
            rec = _serve_paced(torch, net, params, smi, streams, mode,
                               quantize, True, mesh=mesh)
            emit({**rec, "phase": "parallel_serving_rate", "mesh": name})
            require(rec["replies_received"] > 0,
                    f"{name} {mode} {quantize}: no paced reply")
            if name == "one_card":
                for k, v in counts["sharded"].items():
                    launches[k] = launches.get(k, 0) + v
    return launches


def _parallel_train(torch, train_cuda, smi, runs=None):
    """The data-parallel concurrent train step (`bench.run_train_dp`) from
    the trained fixture's weights: two ranks on card 0 over gloo, and one
    rank per card over NCCL when there are several (or `runs`, {backend:
    devices}), against the one-process step on the whole ragged batch from
    the same seed. Returns the launches of one rank's step."""
    import numpy as np
    from mobileposer_tpu_torch import bench
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.parallel import spawn
    from mobileposer_tpu_torch.train.trainer import (MODULE_NAMES,
                                                     make_multi_train_step,
                                                     to_device)

    states = bench._dp_states(str(FIXTURE), 0, "cuda")
    step = make_multi_train_step(ParametricModel.synthetic())
    batch = to_device(bench.train_batch(256, 125, 0, ragged=True), "cuda")
    train_cuda.reset_launches()
    states, want = step(states, batch,
                        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    want_launches = dict(train_cuda.launches)
    want = {n: float(v) for n, v in want.items()}
    want_g = bench._flat_grads(states)
    # where each gradient tensor lies in the flat vector
    names = [f"{n}.{k}" for n in MODULE_NAMES
             for k, _ in states[n].params.named_parameters()]
    sizes = [p.numel() for n in MODULE_NAMES
             for p in states[n].params.parameters()]
    bounds = np.cumsum([0] + sizes)
    del states, batch
    if runs is None:
        runs = {"gloo": ["cuda:0"] * 2}
        if torch.cuda.device_count() > 1:
            runs["nccl"] = [f"cuda:{i}"
                            for i in range(torch.cuda.device_count())]
    launches = {}
    tmp = tempfile.TemporaryDirectory()
    try:
        for backend, devices in runs.items():
            t0 = time.perf_counter()
            ranks = spawn(bench.run_train_dp, devices, tmp.name, 256, 125,
                          0, 3, str(FIXTURE), backend=backend)
            seconds = time.perf_counter() - t0
            for impl in ("gspmd", "shard_map"):
                recs = [r[impl] for r in ranks]
                grads = [np.load(r["grads"]) for r in recs]
                same = all(np.array_equal(g, grads[0]) for g in grads[1:])
                if impl == "gspmd":
                    loss_err = max(abs(r["losses"][n] - want[n])
                                   / abs(want[n])
                                   for r in recs for n in MODULE_NAMES)
                    d = np.abs(grads[0] - want_g)
                    global_err = float(d.max() / np.abs(want_g).max())
                    per = sorted(
                        ((float(d[a:b].max() / max(np.abs(want_g[a:b]).max(),
                                                   1e-30)),
                          float(np.linalg.norm(d[a:b]) / max(np.linalg.norm(
                              want_g[a:b]), 1e-30)),
                          float(np.abs(want_g[a:b]).max()), nm)
                         for a, b, nm in zip(bounds[:-1], bounds[1:], names)),
                        reverse=True)
                    grad_err = per[0][0]
                    ok = loss_err <= DP_LOSS_RTOL and grad_err <= DP_GRAD_TOL
                else:
                    loss_err = max(
                        abs(r["losses"][n] - np.mean([q["own_losses"][n]
                                                      for q in recs]))
                        / abs(r["losses"][n])
                        for r in recs for n in MODULE_NAMES)
                    grad_err = global_err = None
                    ok = loss_err <= DP_MEAN_RTOL
                emit({"phase": "parallel_train", "nvidia_smi": smi,
                      "backend": backend, "dp_impl": impl,
                      "ranks": len(devices), "devices": devices,
                      "batch": 256, "window": 125,
                      "rows_per_rank": recs[0]["rows"],
                      "loss_rel_err": loss_err,
                      "loss_rtol": DP_LOSS_RTOL if impl == "gspmd"
                      else DP_MEAN_RTOL,
                      "grad_err_per_tensor_over_its_max_abs": grad_err,
                      "grad_err_over_global_max_abs": global_err,
                      "worst_tensors": per[:6] if impl == "gspmd" else None,
                      "grad_tol": DP_GRAD_TOL,
                      "ranks_reduced_equal_grads": same,
                      "losses": recs[0]["losses"],
                      "one_process_losses": want,
                      "own_losses": [r["own_losses"] for r in recs],
                      "step_ms": [r["step_ms"] for r in recs],
                      "reduce_ms": [r["reduce_ms"] for r in recs],
                      "reduce_floats": recs[0]["reduce_floats"],
                      "peak_memory_bytes": [r["peak_memory_bytes"]
                                            for r in recs],
                      "launches": [r["launches"] for r in recs],
                      "one_process_launches": want_launches,
                      "spawn_seconds": seconds})
                require(ok, f"{backend} {impl}: losses {loss_err} / "
                            f"gradients {grad_err} beyond the bounds")
                require(same, f"{backend} {impl}: the ranks' reduced "
                              "gradients differ")
                for r in recs:
                    require(r["launches"] == want_launches,
                            f"{backend} {impl} rank {r['rank']}: launches "
                            f"{r['launches']}, one process "
                            f"{want_launches}")
                if impl == "gspmd" and not launches:
                    launches = dict(recs[0]["launches"])
    finally:
        tmp.cleanup()
    return launches


def phase_parallel(torch, lstm_cuda, train_cuda, smi, ptxas):
    """Phase 4k: data parallelism. The kernels at the per-shard shapes
    against their plain versions (#1 and #2 at 256 streams over 4 shards,
    B = 64; #7 and #8 at B = 256 over 2 ranks, B = 128); then sharded
    evaluation, serving and two-rank training, each against one device.
    Returns (the per-shard kernel records, the main-path launches of the
    sharded runs)."""
    recs = phase_kernels(torch, lstm_cuda, cases=[
        ("bilstm_scan_f32", 256, 256 // PARALLEL_SHARDS),
        ("bilstm_scan_f32", 64, 256 // PARALLEL_SHARDS),
        ("lstm_scan_f32", 256, 256 // PARALLEL_SHARDS)])
    recs += phase_train_kernels(torch, train_cuda, ptxas,
                                shapes=((256, 128), (64, 128)))
    mark("4k kernels")
    meshes = _parallel_meshes(torch)
    emit({"phase": "parallel_meshes",
          "meshes": {k: [str(d) for d in m.devices]
                     for k, m in meshes.items()}})
    launches = {}
    eval_launches = _parallel_eval(torch, lstm_cuda, meshes, smi)
    mark("4k eval")
    _parallel_eval_rate(torch, meshes, smi)
    mark("4k eval rate")
    serving = _parallel_serving(torch, lstm_cuda, meshes, smi)
    mark("4k serving")
    for out in (eval_launches, serving,
                _parallel_train(torch, train_cuda, smi)):
        for k, v in out.items():
            launches[k] = launches.get(k, 0) + v
    mark("4k train")
    return recs, launches


# ---------------------------------------------------------------------------
# Phase 4l: the rest of the library — SequenceLoader, RNNWithInit,
# DynamicsModel / PhysicsOptimizer, SMPLViewer and cli.render
# ---------------------------------------------------------------------------

_LIB_CPU_LOADER = """
import sys, time
import numpy as np
import torch
torch.set_num_threads(2)
from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.viz import SequenceLoader
imu_path, out, model, n_online = sys.argv[1:5]
imu = np.load(imu_path)
body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
loader = SequenceLoader(MobilePoserNet(body, device="cpu"),
                        params_from_jax(load_model(model), device="cpu"),
                        device="cpu")
t0 = time.perf_counter()
off = loader.run_offline(imu)
t1 = time.perf_counter()
on = loader.run_online(imu[:int(n_online)])
np.savez(out, *off, *on, seconds=[t1 - t0, time.perf_counter() - t1])
"""


def _library_sequences(torch, lstm_cuda, body, tree, tmp: Path):
    """(a) The trained fixture through `SequenceLoader` on the card:
    `run_offline` over LIB_OFFLINE_FRAMES frames (one call: 6 #1 + 2 #2
    launches at (T, 1, H)) and `run_online` over LIB_ONLINE_FRAMES (6 + 2
    a frame). The CPU port's runs, the reference, go in a process of their
    own started first. Returns (offline outputs, online outputs, the two
    runs' launches, `check(smi)`: joins that process and holds the card
    to it at SLICE_TOL)."""
    import numpy as np
    from mobileposer_tpu_torch.models import MobilePoserNet
    from mobileposer_tpu_torch.nn.convert import params_from_jax
    from mobileposer_tpu_torch.viz import SequenceLoader

    imu = (np.random.RandomState(19).randn(LIB_OFFLINE_FRAMES, 60)
           * 0.1).astype(np.float32)
    np.save(tmp / "imu.npy", imu)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _LIB_CPU_LOADER, str(tmp / "imu.npy"),
         str(tmp / "cpu.npz"), str(FIXTURE), str(LIB_ONLINE_FRAMES)],
        cwd=tmp, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    loader = SequenceLoader(MobilePoserNet(body, device="cuda"),
                            params_from_jax(tree, device="cuda"),
                            device="cuda")
    outs, launches, secs = {}, {}, {}
    for mode, run, n in (("offline", loader.run_offline, LIB_OFFLINE_FRAMES),
                         ("online", loader.run_online, LIB_ONLINE_FRAMES)):
        lstm_cuda.reset_launches()
        t0 = time.perf_counter()
        outs[mode] = run(imu[:n])
        secs[mode] = time.perf_counter() - t0
        launches[mode] = {k: v for k, v in lstm_cuda.launches.items() if v}

    def check(smi):
        log, _ = proc.communicate(timeout=600)
        require(proc.returncode == 0,
                f"the CPU SequenceLoader exited {proc.returncode}: "
                f"{log[-2000:]}")
        with np.load(tmp / "cpu.npz") as z:
            cpu = [z[f"arr_{i}"] for i in range(6)]
            cpu_secs = z["seconds"]
        expect = {"offline": {"bilstm_scan_f32": 6, "lstm_scan_f32": 2},
                  "online": {"bilstm_scan_f32": 6 * LIB_ONLINE_FRAMES,
                             "lstm_scan_f32": 2 * LIB_ONLINE_FRAMES}}
        for i, (mode, names, want) in enumerate((
                ("offline", ("pose", "joints", "tran", "contact"), cpu[:4]),
                ("online", ("pose", "tran"), cpu[4:]))):
            got = outs[mode]
            errs = {k: float(np.abs(g - w).max())
                    for k, g, w in zip(names, got, want)}
            finite = all(bool(np.isfinite(g).all()) for g in got)
            emit({"phase": "library_sequence_loader", "mode": mode,
                  "frames": int(got[0].shape[0]), "max_abs_err": errs,
                  "tol": SLICE_TOL, "finite": finite,
                  "launches": launches[mode], "expected": expect[mode],
                  "card_seconds": secs[mode], "cpu_seconds": cpu_secs[i],
                  "nvidia_smi": smi})
            require(finite and all(e <= SLICE_TOL for e in errs.values()),
                    f"SequenceLoader.run_{mode} card vs CPU: {errs} (tol "
                    f"{SLICE_TOL}), finite {finite}")
            require(launches[mode] == expect[mode],
                    f"SequenceLoader.run_{mode} launches {launches[mode]}, "
                    f"expected {expect[mode]}")

    total = {}
    for part in launches.values():
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return outs["offline"], outs["online"], total, check


def library_kernel_records(torch, lstm_cuda, lengths) -> None:
    """#2 and #3 (unidirectional) at `RNNWithInit`'s layer shape
    (LIB_RWI_WINDOW, LIB_RWI_BATCH, 256), #3 with its sorted `lengths`,
    against their plain versions with kernel, plain and cuDNN times and
    the bound (not counted: the counters are reset before each main-path
    run)."""
    import numpy as np
    from mobileposer_tpu_torch.nn.lstm import length_mask
    T, B, H = LIB_RWI_WINDOW, LIB_RWI_BATCH, 256
    for name in ("lstm_scan_f32", "lstm_scan_masked_f32"):
        kern, plain, args = _scan_case(torch, lstm_cuda,
                                       np.random.RandomState(T + B), False,
                                       T, B, H)
        valid = None
        if name == "lstm_scan_masked_f32":
            kern, plain = (lstm_cuda.lstm_layer_masked,
                           lstm_cuda.lstm_layer_masked_plain)
            args = (*args, length_mask(torch.from_numpy(lengths).cuda(), T))
            valid = int(lengths.sum())
        err, finite = _scan_vs_plain(torch, kern, plain, args)
        with torch.no_grad():
            kernel_ms = time_ms(lambda: kern(*args), 20)
            plain_ms = time_ms(lambda: plain(*args), 2, warmup=1)
        library_ms, _ = _lstm_library_ms(
            torch, H, B, T, False, torch.float32,
            lengths if valid is not None else None)
        bound_ms, bound_by, flops, nbytes = layer_bound(1, T, B, H, valid)
        rec = {"phase": "library_kernel", "name": name, "T": T, "B": B,
               "H": H, "lengths": "sorted random" if valid else None,
               "max_abs_err": err, "tol": KERNEL_TOL, "finite": finite,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "torch.nn.LSTM 1 layer (cuDNN, TF32 off; includes "
                          "its input projection; packed when masked)",
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "pct_of_bound": 100.0 * bound_ms / kernel_ms}
        emit(rec)
        require(finite and err <= KERNEL_TOL,
                f"{name} at RNNWithInit's shape {(T, B, H)}: max abs err "
                f"{err} (tol {KERNEL_TOL}), finite {finite}")


def _rnn_with_init_plain(torch, lstm_cuda, mod, cfg, x, init, lengths):
    """`rnn_with_init_apply` of a unidirectional `RNNWithInit`, every layer
    on the plain version of its scan kernel (#2, or #3 with lengths), on
    the tensors' device."""
    from mobileposer_tpu_torch.nn.lstm import length_mask
    from mobileposer_tpu_torch.nn.rnn_with_init import initial_state
    h0, c0 = initial_state(mod, cfg, init)
    xs = torch.relu(mod.rnn.linear1(x)).transpose(0, 1)          # [T, B, H]
    hs, cs = [], []
    for li, layer in enumerate(mod.rnn.lstm):
        p = layer["fwd"]
        x_proj = torch.matmul(xs, p.w_ih) + (p.b_ih + p.b_hh)
        if lengths is None:
            xs, (h, c) = lstm_cuda.lstm_layer_plain(x_proj, p.w_hh, h0[li],
                                                    c0[li])
        else:
            xs, (h, c) = lstm_cuda.lstm_layer_masked_plain(
                x_proj, p.w_hh, h0[li], c0[li],
                length_mask(lengths, xs.shape[0]))
        hs.append(h)
        cs.append(c)
    return mod.rnn.linear2(xs.transpose(0, 1)), (torch.stack(hs),
                                                 torch.stack(cs))


def _library_rnn_with_init(torch, lstm_cuda, train_cuda, smi):
    """(b) `RNNWithInit` at full width (velocity's LSTMConfig(132, 72, 256,
    n_layers=2, unidirectional), n_init = 72) at B = 256, T = 125: the
    forward without lengths (#2) and with sorted random lengths (#3)
    against the same function on the kernels' plain versions on the card
    (KERNEL_TOL); #8's dh0 and dc0 at layer 0's real inputs against the
    plain version; one 'auto_train' step (#7, #8) against the CPU port's
    gradients (STEP_GRAD_RTOL, each tensor relative to its largest entry;
    the init MLP's gradients flow through #8's dh0 and dc0). Returns the
    main-path launches (the two forwards and the step)."""
    import numpy as np
    from mobileposer_tpu_torch.nn import (LSTMConfig, RNNWithInitConfig,
                                          init_rnn_with_init,
                                          rnn_with_init_apply)
    from mobileposer_tpu_torch.nn.lstm import (draw_dropout_keep, length_mask,
                                               rnn_apply)
    from mobileposer_tpu_torch.nn.rnn_with_init import initial_state

    cfg = RNNWithInitConfig(LSTMConfig(132, 72, 256, n_layers=2,
                                       bidirectional=False), n_init=72)
    B, T, H = LIB_RWI_BATCH, LIB_RWI_WINDOW, cfg.rnn.n_hidden
    mods = {d: init_rnn_with_init(torch.Generator().manual_seed(19), cfg,
                                  device=d) for d in ("cuda", "cpu")}
    rng = np.random.RandomState(23)
    host = {"x": (rng.randn(B, T, 132) * 0.5).astype(np.float32),
            "init": (rng.randn(B, 72) * 0.3).astype(np.float32),
            "lengths": np.sort(rng.randint(T // 4, T + 1, B))[::-1].copy(),
            "wy": rng.randn(B, T, 72).astype(np.float32),
            "wh": rng.randn(2, B, H).astype(np.float32),
            "wc": rng.randn(2, B, H).astype(np.float32)}
    host["lengths"][0] = T
    keep = draw_dropout_keep(cfg.rnn, (B, T, H),
                             torch.Generator().manual_seed(29))
    dev = {d: {k: torch.from_numpy(v).to(d) for k, v in host.items()}
           for d in ("cuda", "cpu")}
    card, mod = dev["cuda"], mods["cuda"]

    def counts(*mods_):
        return {k: v for m in mods_ for k, v in m.launches.items() if v}

    library_kernel_records(torch, lstm_cuda, host["lengths"])
    launches = {}
    # the forward, without and with lengths, against the plain versions
    for ragged in (False, True):
        lengths = card["lengths"] if ragged else None
        with torch.no_grad():
            lstm_cuda.reset_launches()
            y, (h, c) = rnn_with_init_apply(mod, cfg, card["x"], card["init"],
                                            lengths)
            got_launches = counts(lstm_cuda)
            py, (ph, pc) = _rnn_with_init_plain(torch, lstm_cuda, mod, cfg,
                                                card["x"], card["init"],
                                                lengths)
            ms = time_ms(lambda: rnn_with_init_apply(
                mod, cfg, card["x"], card["init"], lengths), 10)
            plain_ms = time_ms(lambda: _rnn_with_init_plain(
                torch, lstm_cuda, mod, cfg, card["x"], card["init"],
                lengths), 2, warmup=1)
        name = "lstm_scan_masked_f32" if ragged else "lstm_scan_f32"
        err = max(float((g - w).abs().max())
                  for g, w in ((y, py), (h, ph), (c, pc)))
        finite = all(bool(torch.isfinite(t).all()) for t in (y, h, c))
        rec = {"phase": "library_rnn_with_init", "pass": "forward",
               "lengths": "sorted random" if ragged else None,
               "B": B, "T": T, "H": H, "kernel": name,
               "max_abs_err_vs_plain": err, "tol": KERNEL_TOL,
               "finite": finite, "launches": got_launches, "ms": ms,
               "plain_ms": plain_ms, "nvidia_smi": smi}
        emit(rec)
        require(finite and err <= KERNEL_TOL,
                f"RNNWithInit forward ({name}) vs plain: {err} (tol "
                f"{KERNEL_TOL}), finite {finite}")
        require(got_launches == {name: 2},
                f"RNNWithInit forward launches {got_launches}")
        for k, v in got_launches.items():
            launches[k] = launches.get(k, 0) + v

    # #8's dh0 and dc0 at layer 0's real inputs (the init MLP's state),
    # against the plain version on the card
    with torch.no_grad():
        h0, c0 = initial_state(mod, cfg, card["init"])
        p = mod.rnn.lstm[0]["fwd"]
        xs = torch.relu(mod.rnn.linear1(card["x"])).transpose(0, 1)
        x_proj = (torch.matmul(xs, p.w_ih) + (p.b_ih + p.b_hh)).contiguous()
        mask = length_mask(card["lengths"], T)
        h0, c0 = h0[0].contiguous(), c0[0].contiguous()
        ys, acts, hseq, cseq, _, _ = train_cuda.lstm_train_fwd(
            x_proj, p.w_hh, h0, c0, mask)
        g = torch.Generator(device="cuda").manual_seed(31)
        dy, dh_T, dc_T = (torch.randn(s, generator=g, device="cuda")
                          for s in ((T, B, H), (B, H), (B, H)))
        args = (dy, dh_T, dc_T, acts, cseq,
                torch.cat([h0[None], hseq[:-1]]),
                torch.cat([c0[None], cseq[:-1]]), p.w_hh, mask)
        got = train_cuda.lstm_train_bwd(*args)
        want = train_cuda.lstm_train_bwd_plain(*args)
    errs = {k: float((a - b).abs().max()) / (float(b.abs().max())
                                             if k == "dw_hh" else 1.0)
            for k, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got,
                               want)}
    emit({"phase": "library_rnn_with_init", "pass": "bwd_dh0_dc0",
          "B": B, "T": T, "H": H, "errors": errs,
          "tol": {"dx_proj": TRAIN_TOL, "dh0": TRAIN_TOL, "dc0": TRAIN_TOL,
                  "dw_hh (relative)": DW_REL_TOL},
          "dh0_max_abs": float(want[2].abs().max()),
          "dc0_max_abs": float(want[3].abs().max())})
    require(all(errs[k] <= TRAIN_TOL for k in ("dx_proj", "dh0", "dc0"))
            and errs["dw_hh"] <= DW_REL_TOL,
            f"#8 at RNNWithInit's layer 0 vs plain: {errs}")

    # one 'auto_train' step, card against the CPU port. The init MLP is
    # piecewise linear: a pre-activation within rounding of 0 may take
    # the other ReLU branch on the CPU (cuBLAS and the CPU's GEMM round
    # differently), and its unit's gradient rows then differ in full. So
    # the CPU reference runs the same function on the card's branch (its
    # ReLU masks); every unit whose branch differs is reported and must
    # lie within RELU_KINK of 0.
    with torch.no_grad():
        masks, kinks = [], {}
        z = {d: dev[d]["init"] for d in ("cuda", "cpu")}
        for lin in ("init1", "init2"):
            z = {d: getattr(mods[d], lin)(z[d]) for d in z}
            m = z["cuda"] > 0
            flip = m.cpu() != (z["cpu"] > 0)
            kinks[lin] = {"flipped": int(flip.sum()),
                          "max_abs_pre_activation": float(
                              z["cpu"][flip].abs().max()) if flip.any()
                          else 0.0}
            masks.append(m)
            z = {d: torch.where(m.to(d), z[d], z[d].new_zeros(()))
                 for d in z}

    def loss_on(d, branch):
        m, t = mods[d], dev[d]
        if branch is None:
            y, (h, c) = rnn_with_init_apply(m, cfg, t["x"], t["init"],
                                            t["lengths"], train=True,
                                            dropout_keep=keep.to(d))
        else:
            a = t["init"]
            for lin, mk in zip((m.init1, m.init2), branch):
                a = lin(a) * mk.to(d)
            state = m.init3(a).reshape(B, 2, cfg.rnn.n_layers, H)
            y, (h, c) = rnn_apply(m.rnn, cfg.rnn, t["x"], t["lengths"],
                                  (state[:, 0].transpose(0, 1),
                                   state[:, 1].transpose(0, 1)),
                                  backend="auto_train", train=True,
                                  dropout_keep=keep.to(d))
        return ((y * t["wy"]).mean() + (h * t["wh"]).mean()
                + (c * t["wc"]).mean())

    grads, losses = {}, {}
    for d in ("cuda", "cpu"):
        m = mods[d]
        m.requires_grad_(True)
        names, params = zip(*m.named_parameters())
        train_cuda.reset_launches()
        loss = loss_on(d, None if d == "cuda" else masks)
        grads[d] = dict(zip(names, torch.autograd.grad(loss, params)))
        losses[d] = float(loss.detach())
        if d == "cuda":
            step_launches = counts(train_cuda)
            step_ms = time_ms(lambda: torch.autograd.grad(
                loss_on(d, None), params), 5)
        m.requires_grad_(False)
    grad_err = {n: float((grads["cuda"][n].cpu() - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for n, g in grads["cpu"].items()}
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    expect = {"lstm_train_fwd_f32": 2, "lstm_train_bwd_f32": 2,
              "lstm_train_dw_f32": 2}
    emit({"phase": "library_rnn_with_init", "pass": "auto_train_step",
          "B": B, "T": T, "H": H, "loss_rel_err": loss_err,
          "grad_rel_err": grad_err, "tol": STEP_GRAD_RTOL,
          "relu_branches_differing": kinks, "relu_kink_tol": RELU_KINK,
          "init_mlp_grad_max_abs": {
              n: float(grads["cpu"][n].abs().max())
              for n in grads["cpu"] if n.startswith("init")},
          "launches": step_launches, "expected": expect, "ms": step_ms,
          "nvidia_smi": smi})
    require(all(k["max_abs_pre_activation"] <= RELU_KINK
                for k in kinks.values()),
            f"an init-MLP ReLU took another branch on the card away from "
            f"0: {kinks}")
    require(loss_err <= STEP_LOSS_RTOL
            and all(e <= STEP_GRAD_RTOL for e in grad_err.values()),
            f"RNNWithInit train step card vs CPU: loss {loss_err}, "
            f"gradients {grad_err}")
    require(all(float(grads["cpu"][n].abs().max()) > 0
                for n in grads["cpu"] if n.startswith("init")),
            "the init MLP received no gradient")
    require(step_launches == expect,
            f"RNNWithInit train step launches {step_launches}")
    for k, v in step_launches.items():
        launches[k] = launches.get(k, 0) + v
    return launches


# Phase 4l's RNNWithInit step: an init-MLP pre-activation whose ReLU branch
# differs between the card and the CPU must be within this of 0: float32
# rounding of these pre-activations (of order 0.1) is far below it, a
# fault in the card's forward far above.
RELU_KINK = 1e-5
# DynamicsModel outputs held card against CPU at each of LIB_DYN_STATES
# seeded states, relative to the output's largest magnitude: inverse
# dynamics, h and M at 1e-4 (float32 sums in another order: cuBLAS,
# reductions), the kinematic quantities at 1e-5, forward dynamics at 5e-3
# (a float32 Cholesky solve of an ill-conditioned M, cond(M) 7e4 to 1e5
# at tests/test_torch_physics.py's states on the small synthetic body:
# cuSOLVER's and LAPACK's factors differ by rounding, which the solve
# scales by up to cond(M) * 6e-8; that test argues the same bound against
# the JAX package).
DYN_ID_TOL = 1e-4
DYN_KIN_TOL = 1e-5
DYN_FD_TOL = 5e-3
LIB_DYN_FUNCS = {
    "inverse_dynamics": (lambda m, q, v, a, t: m.inverse_dynamics(q, v, a),
                         DYN_ID_TOL),
    "calc_h": (lambda m, q, v, a, t: m.calc_h(q, v), DYN_ID_TOL),
    "calc_M": (lambda m, q, v, a, t: m.calc_M(q), DYN_ID_TOL),
    "forward_dynamics": (lambda m, q, v, a, t: m.forward_dynamics(q, v, t),
                         DYN_FD_TOL),
    "calc_point_Jacobian": (
        lambda m, q, v, a, t: m.calc_point_Jacobian(q, 20, (0.05, 0, 0)),
        DYN_KIN_TOL),
    "calc_body_Jacobian": (lambda m, q, v, a, t: m.calc_body_Jacobian(q, 15),
                           DYN_KIN_TOL),
    "calc_space_Jacobian": (lambda m, q, v, a, t: m.calc_space_Jacobian(q, 11),
                            DYN_KIN_TOL),
    "center_of_mass": (
        lambda m, q, v, a, t:
        m.calc_center_of_mass_position_velocity_acceleration(q, v, a),
        DYN_KIN_TOL),
    "calc_zero_moment_point": (
        lambda m, q, v, a, t: m.calc_zero_moment_point(q, v, a),
        DYN_KIN_TOL),
}
# PhysicsOptimizer card against CPU over the online frames: its smoothing
# state contracts (weight 0.2 on the previous pose), so per-frame float32
# differences (QR, FK, the ZMP) stay ~1e-6 and do not grow with the frame
# count; 1e-4 on pose and tran leaves two orders of margin.
PHYS_TOL = 1e-4


def _library_dynamics(torch, body, contact, pose, tran, smi):
    """(c) `DynamicsModel` on the card against the CPU port at
    LIB_DYN_STATES seeded states (each output relative to its largest
    magnitude), ID == M qdd + h on the card, each call's ms and its
    device launches (one traced call); then `PhysicsOptimizer(dynamics=)`
    over the online frames, card against CPU (PHYS_TOL), its ms a frame."""
    import numpy as np
    from mobileposer_tpu_torch import bench
    from mobileposer_tpu_torch.physics import DynamicsModel, PhysicsOptimizer
    from mobileposer_tpu_torch.physics.dynamics import DOF

    models = {d: DynamicsModel(body, device=d) for d in ("cuda", "cpu")}

    def state(seed):
        r = np.random.RandomState(seed)
        q = np.concatenate([r.randn(3) * 0.2, r.randn(72) * 0.4])
        return [torch.from_numpy(x.astype(np.float32)).cuda()
                for x in (q, r.randn(DOF) * 0.8, r.randn(DOF) * 0.8,
                          r.randn(DOF) * 5)]

    def flat(out):
        return [t for o in (out if isinstance(out, tuple) else (out,))
                for t in (o if isinstance(o, tuple) else (o,))]

    states = [state(s) for s in range(LIB_DYN_STATES)]
    for name, (fn, tol) in LIB_DYN_FUNCS.items():
        err = 0.0
        for st in states:
            got = flat(fn(models["cuda"], *st))
            want = flat(fn(models["cpu"], *[x.cpu() for x in st]))
            for g, w in zip(got, want):
                w = torch.as_tensor(w)
                err = max(err, float((g.cpu() - w).abs().max())
                          / max(float(w.abs().max()), 1e-6))
        ms = time_ms(lambda: fn(models["cuda"], *states[0]), 20)
        traced = bench._traced(lambda: fn(models["cuda"], *states[0]),
                               "cuda")
        n_launch = sum(g["launches"] for g in traced["groups"].values())
        emit({"phase": "library_dynamics", "call": name,
              "states": LIB_DYN_STATES, "max_rel_err": err, "tol": tol,
              "ms": ms, "device_launches": n_launch,
              "device_busy_share": traced["device_busy_share"],
              "nvidia_smi": smi})
        require(err <= tol, f"DynamicsModel.{name} card vs CPU: {err} "
                            f"relative (tol {tol})")
    m = models["cuda"]
    id_err = 0.0
    for q, qd, qdd, _ in states:
        tau = m.inverse_dynamics(q, qd, qdd).double()
        want = m.calc_M(q).double() @ qdd.double() + m.calc_h(q, qd).double()
        id_err = max(id_err, float((tau - want).abs().max()
                                   / want.abs().max()))
    emit({"phase": "library_dynamics", "call": "ID == M qdd + h (card)",
          "max_rel_err": id_err, "tol": DYN_ID_TOL})
    require(id_err <= DYN_ID_TOL, f"on the card ID != M qdd + h: {id_err}")

    outs, frame_ms = {}, {}
    for d in ("cuda", "cpu"):
        opt = PhysicsOptimizer(body, contact_threshold=0.5,
                               dynamics=models[d])
        st, res = opt.reset_states(), []
        t0 = time.perf_counter()
        for p, c, t in zip(pose, contact, tran):
            (po, to), st = opt.optimize_frame(p, None, c, None, st, t)
            res.append((po, to))
        res = [torch.stack(x).cpu() for x in zip(*res)]
        frame_ms[d] = (time.perf_counter() - t0) * 1e3 / len(pose)
        outs[d] = res
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(
        ("pose", "tran"), outs["cuda"], outs["cpu"])}
    emit({"phase": "library_physics_optimizer", "frames": len(pose),
          "max_abs_err": errs, "tol": PHYS_TOL,
          "card_ms_per_frame": frame_ms["cuda"],
          "cpu_ms_per_frame": frame_ms["cpu"], "nvidia_smi": smi})
    require(all(e <= PHYS_TOL for e in errs.values()),
            f"PhysicsOptimizer card vs CPU: {errs} (tol {PHYS_TOL})")


def _library_render(torch, body, online, offline):
    """(d) `SMPLViewer.view` of (a)'s online motion (the offline one as
    its ground truth), then `python -m mobileposer_tpu_torch.cli.render`
    on the bundle in a process of its own, on the card: the frames and
    the GIF; `load_bundle_joints` on the card against the CPU (1e-5)."""
    import shutil
    import numpy as np
    from mobileposer_tpu_torch.viz import SMPLViewer
    from mobileposer_tpu_torch.viz.render import load_bundle_joints

    n = LIB_ONLINE_FRAMES
    tmp = Path(tempfile.mkdtemp())
    try:
        bundle = SMPLViewer(body, tmp / "view").view(
            online[0], online[1], pose_t=offline[0][:n],
            tran_t=offline[2][:n], name="online")
        joints = {d: load_bundle_joints(str(bundle), body, device=d)[1:]
                  for d in ("cuda", "cpu")}
        err = max(float(np.abs(g - w).max()) for g, w in zip(
            joints["cuda"], joints["cpu"]))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "mobileposer_tpu_torch.cli.render",
             str(bundle), "--out", str(tmp / "render"), "--stride",
             str(LIB_RENDER_STRIDE), "--gif"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        pngs = sorted((tmp / "render").glob("frame_*.png"))
        gif = tmp / "render" / "motion.gif"
        want = -(-n // LIB_RENDER_STRIDE)
        emit({"phase": "library_render", "bundle_keys": sorted(
            np.load(bundle).files), "joints_card_vs_cpu": err, "tol": 1e-5,
              "returncode": out.returncode, "seconds": secs,
              "pngs": len(pngs), "expected_pngs": want,
              "gif_bytes": gif.stat().st_size if gif.exists() else 0,
              "output_tail": (out.stdout + out.stderr).splitlines()[-3:]})
        require(err <= 1e-5, f"load_bundle_joints card vs CPU: {err}")
        require(out.returncode == 0 and len(pngs) == want and gif.exists(),
                f"cli.render exited {out.returncode} with {len(pngs)} "
                f"frames: {(out.stdout + out.stderr)[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_library(torch, lstm_cuda, train_cuda, smi):
    """Phase 4l: the rest of the library on the card. (a) SequenceLoader
    on the trained fixture, (b) RNNWithInit at full width through #2, #3,
    #7 and #8, (c) DynamicsModel and PhysicsOptimizer, (d) SMPLViewer and
    cli.render. Returns the main-path launches of (a) and (b)."""
    import shutil
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models.utils import load_model

    tmp = Path(tempfile.mkdtemp())
    try:
        body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
        offline, online, launches, check = _library_sequences(
            torch, lstm_cuda, body, load_model(str(FIXTURE)), tmp)
        for k, v in _library_rnn_with_init(torch, lstm_cuda, train_cuda,
                                           smi).items():
            launches[k] = launches.get(k, 0) + v
        n = LIB_ONLINE_FRAMES
        _library_dynamics(torch, body,
                          torch.from_numpy(offline[3][:n]).cuda(),
                          torch.from_numpy(online[0]).cuda(),
                          torch.from_numpy(online[1]).cuda(), smi)
        _library_render(torch, body, online, offline)
        check(smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches

# Phase 4m: a train step on bf16 params against the f32 step on the same
# weights widened. The float32 batch makes the forward the f32 one on
# those weights but for the bias sum b_ih + b_hh, rounded to bf16, and the
# float32 sums' order; the losses were 9.1e-6 apart relatively (NVIDIA
# H100 80GB HBM3, 700 W): held at 1e-4.
BF16_STEP_LOSS_RTOL = 1e-4
# The same step at STEP_BATCH on the card against the CPU port on the
# same bf16 weights, batch and draws: losses within STEP_LOSS_RTOL;
# gradients (bf16: float32 sums cast once) within STEP_BF16_GRAD_ULPS bf16
# ulps of each tensor's largest magnitude, the bound the CPU tests hold
# the port's gradients to against the JAX package's; the moments mu =
# (1 - b1) g within one ulp more, nu = (1 - b2) g^2 (twice g's relative
# error) within twice that and one more. The updated params where the
# CPU gradient exceeds 2 STEP_BF16_GRAD_ULPS ulps of its tensor's largest
# (so both devices move them the same way): one Adam step from fresh
# moments moves an entry by lr * u, u = +-1 up to the bf16 roundings of
# its few operations (2^-9 each, under 2^-5 in all on either device), so
# the two agree within one bf16 ulp of the param plus lr * 2^-5; any
# other entry, which may move the other way, within 2 lr (1 + 2^-5) plus
# one ulp.
STEP_BF16_GRAD_ULPS = 4
# The compiled (inductor) loss and backward of one module on bf16 params
# against eager: inductor fuses the elementwise ops around the kernels and
# may round a float32 value differently in its last bits; the loss within
# a relative 1e-5, each gradient (bf16) within COMPILED_GRAD_ULPS bf16 ulps
# of its largest magnitude (a last bit of dy can flip the bf16 rounding of
# a dgate for the dh product, which the scan carries on).
COMPILED_LOSS_RTOL = 1e-5
COMPILED_GRAD_ULPS = 2


def _bf16_step_errors(torch, outs, lr):
    """Card against CPU in a bf16-param `_card_vs_cpu_step` result: the
    losses relative; the gradients, mu and nu in bf16 ulps of each CPU
    tensor's largest magnitude (the worst tensor of each); and the updated
    params' differences over their bounds (STEP_BF16_GRAD_ULPS's note), the
    worst ratio of the determined entries and of the others."""
    card, cpu = outs["cuda"], outs["cpu"]
    loss = {n: abs(card[0][n] - c) / abs(c) for n, c in cpu[0].items()}
    errs = dict.fromkeys(("grad_ulps", "mu_ulps", "nu_ulps",
                          "param_determined", "param_others"), 0.0)
    for n, grads in cpu[1].items():
        for i, gc in enumerate(grads):
            (mg, vg), (mc, vc) = card[4][n][i], cpu[4][n][i]
            for k, g, c in (("grad_ulps", card[1][n][i], gc),
                            ("mu_ulps", mg, mc), ("nu_ulps", vg, vc)):
                errs[k] = max(errs[k], ulps_apart([g], [c]))
            pc, pg = cpu[2][n][i].float(), card[2][n][i].float()
            d = (pg - pc).abs()
            # one bf16 ulp of the larger of the two
            ulp = torch.ldexp(torch.ones_like(pc), torch.frexp(
                torch.maximum(pc.abs(), pg.abs())).exponent - 8)
            big = gc.float().abs() > 2 * STEP_BF16_GRAD_ULPS * bf16_ulp(gc)
            for k, sel, allow in (
                    ("param_determined", big, lr * 2 ** -5),
                    ("param_others", ~big, 2 * lr * (1 + 2 ** -5))):
                if bool(sel.any()):
                    errs[k] = max(errs[k],
                                  float((d / (ulp + allow))[sel].max()))
    return loss, errs


def phase_bf16_train(torch, lstm_cuda, train_cuda, multicell_cuda):
    """Phase 4m: training on bf16 params at full width and C4's batch (B =
    256 x 125). One concurrent step of the four modules on
    `init_all_modules(dtype=torch.bfloat16)` (the seed's float32 weights
    cast) under both residual dtypes, on C4's float32 batch (the f32
    forward on the widened w_hh and the wbf16 backward: JAX promotes the
    batch over bf16 weights) and on the batch cast to bf16 (joints, whose
    input is the IMU alone, on the bf16-I/O entries; the other modules
    concatenate the float32 noise, which promotes their input); each
    against the f32 step on the weights widened (losses within
    BF16_STEP_LOSS_RTOL on the float32 batch) and on the original float32
    weights (loss gaps), with finite losses, every parameter and moment
    still bf16 and the launches of the f32 step (10 #7, 10 #8 scans, 10
    dW per step). Then the same four variants at STEP_BATCH against the
    CPU port on the same weights, batch and draws: losses, gradients,
    moments and updated params (STEP_BF16_GRAD_ULPS). Then each variant's
    step time and peak memory beside C4's and C9's (`bench.run_train`);
    the compiled (inductor) loss and backward of footcontact against
    eager with the same #7 / #8 launches; and `forward(backend='fused')`
    exported with the weights as inputs against the eager forward at
    0.0 with 2 multicell + 2 bilstm launches. Returns the launch counts
    of the bf16-param runs (the new entries' main-path runs)."""
    import numpy as np
    from mobileposer_tpu_torch import bench, serving
    from mobileposer_tpu_torch import config as C
    from mobileposer_tpu_torch.kinematics import ParametricModel
    from mobileposer_tpu_torch.models import MobilePoserNet, forward
    from mobileposer_tpu_torch.models import modules as M
    from mobileposer_tpu_torch.nn.convert import cast_params
    from mobileposer_tpu_torch.train.trainer import (
        MODULE_NAMES, TrainState, make_multi_train_step, make_optimizer,
        to_device)
    bf16, f32 = torch.bfloat16, torch.float32
    body = ParametricModel.synthetic()
    batch = to_device(bench.train_batch(256, 125, 0), "cuda")
    batch16 = {k: v.to(bf16) if v.is_floating_point() else v
               for k, v in batch.items()}
    p32 = M.init_all_modules(torch.Generator().manual_seed(0), "cuda")
    p16 = cast_params(p32, bf16)
    widened = cast_params(p16, f32)
    lr = C.train_hypers.lr

    def states_of(params):
        params = cast_params(params, params["joints"].linear1.weight.dtype)
        return {n: TrainState(params[n].requires_grad_(True),
                              make_optimizer(n, lr, params[n]))
                for n in MODULE_NAMES}

    def run(params, b, backend):
        step = make_multi_train_step(body, backend=backend)
        states = states_of(params)
        train_cuda.reset_launches()
        states, losses = step(states, b,
                              torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        return states, {n: float(v) for n, v in losses.items()}, {
            k: n for k, n in train_cuda.launches.items() if n}

    n_dirs = sum((2 if cfg.bidirectional else 1) * cfg.n_layers
                 for cfg in M.MODULE_CONFIGS.values())
    joints_dirs = 2 * M.MODULE_CONFIGS["joints"].n_layers
    main_launches, failures = {}, []
    for backend, res in (("auto_train", ""), ("auto_train_bf16res",
                                              "_bf16res")):
        dw = "lstm_train_dw_" + ("bf16res" if res else "f32")
        fwd32 = "lstm_train_fwd_" + ("bf16res" if res else "f32")
        _, want, _ = run(widened, batch, backend)
        _, orig, _ = run(p32, batch, backend)
        for b, tag in ((batch, "f32_batch"), (batch16, "bf16_batch")):
            states, losses, launches = run(p16, b, backend)
            if tag == "f32_batch":
                expect = {fwd32: n_dirs,
                          f"lstm_train_bwd_wbf16{res}": n_dirs, dw: n_dirs}
            else:
                rest = n_dirs - joints_dirs
                expect = {f"lstm_train_fwd_bf16{res}": joints_dirs,
                          f"lstm_train_bwd_bf16{res}": joints_dirs,
                          fwd32: rest,
                          f"lstm_train_bwd_wbf16{res}": rest, dw: n_dirs}
            # each new entry's main-path run: the float32 batch for the
            # wbf16 backward, the bf16 one for the bf16-I/O entries
            new = ({f"lstm_train_bwd_wbf16{res}"} if tag == "f32_batch"
                   else {f"lstm_train_{k}_bf16{res}" for k in ("fwd", "bwd")})
            main_launches.update({k: launches.get(k, 0) for k in new})
            gap = {n: abs(losses[n] - want[n]) / abs(want[n])
                   for n in MODULE_NAMES}
            gap_orig = {n: abs(losses[n] - orig[n]) / abs(orig[n])
                        for n in MODULE_NAMES}
            dtypes = {str(p.dtype) for n in MODULE_NAMES
                      for p in states[n].params.parameters()}
            moments = {str(v.dtype) for n in MODULE_NAMES
                       for st in states[n].opt.state.values()
                       for k, v in st.items() if k in ("mu", "nu")}
            emit({"phase": "bf16_train_step", "backend": backend,
                  "batch": tag, "losses": losses,
                  "f32_losses_on_widened": want, "f32_losses": orig,
                  "loss_rel_gap_vs_widened": gap,
                  "loss_rel_gap_vs_f32": gap_orig,
                  "largest_gap_vs_f32": max(gap_orig.values()),
                  "rtol": BF16_STEP_LOSS_RTOL, "launches": launches,
                  "expected_launches": expect, "param_dtypes": sorted(dtypes),
                  "moment_dtypes": sorted(moments)})
            tag = f"{backend} {tag}"
            if not all(math.isfinite(v) for v in losses.values()):
                failures.append(f"{tag}: losses {losses}")
            if launches != expect:
                failures.append(f"{tag}: launches {launches}, expected "
                                f"{expect}")
            if tag.endswith("f32_batch") and max(gap.values()) \
                    > BF16_STEP_LOSS_RTOL:
                failures.append(f"{tag}: losses {gap} from the f32 step")
            if dtypes != {"torch.bfloat16"} or moments != {"torch.bfloat16"}:
                failures.append(f"{tag}: dtypes {dtypes}, {moments}")
    mark("4m step")

    # the same steps at STEP_BATCH, card against the CPU port
    small = bench.train_batch(STEP_BATCH, 125, 0)
    bounds = {"grad_ulps": STEP_BF16_GRAD_ULPS,
              "mu_ulps": STEP_BF16_GRAD_ULPS + 1,
              "nu_ulps": 2 * STEP_BF16_GRAD_ULPS + 1,
              "param_determined": 1.0, "param_others": 1.0}
    for backend in ("auto_train", "auto_train_bf16res"):
        for batch_dtype, tag in ((None, "f32_batch"), (bf16, "bf16_batch")):
            outs = _card_vs_cpu_step(torch, body, small, backend, dtype=bf16,
                                     batch_dtype=batch_dtype)
            loss_rel, errs = _bf16_step_errors(torch, outs, lr)
            emit({"phase": "bf16_train_step_vs_cpu", "backend": backend,
                  "batch": tag, "step_batch": STEP_BATCH,
                  "loss_rel_err": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
                  "errors": errs, "bounds": bounds,
                  "step_seconds": {d: outs[d][3] for d in outs}})
            tag = f"{backend} {tag} vs CPU"
            if max(loss_rel.values()) > STEP_LOSS_RTOL:
                failures.append(f"{tag}: losses {loss_rel}")
            over = {k: v for k, v in errs.items() if v > bounds[k]}
            if over:
                failures.append(f"{tag}: {over} beyond {bounds}")
    mark("4m step vs CPU")

    # step time and peak memory, C4 and C9 beside, in turns
    rates = {}
    for params16, res16 in ((False, False), (False, True), (True, False),
                            (True, True)):
        rec = bench.run_train(batch=256, window=125, bf16_residuals=res16,
                              bf16_params=params16)
        rates[rec["metric"]] = rec
        emit({"phase": "bf16_train_rate", **rec})
    c4 = rates["training_frames_per_sec"]
    for k, rec in rates.items():
        if rec["bf16_params"]:
            emit({"phase": "bf16_train_rate_vs_c4", "metric": k,
                  "step_ms": rec["step_ms"], "c4_step_ms": c4["step_ms"],
                  "c9_step_ms": rates["training_bf16res_frames_per_sec"][
                      "step_ms"],
                  "peak_memory_bytes": rec["peak_memory_bytes"],
                  "c4_peak_memory_bytes": c4["peak_memory_bytes"],
                  "c9_peak_memory_bytes": rates[
                      "training_bf16res_frames_per_sec"]["peak_memory_bytes"],
                  "over_c4": rec["value"] / c4["value"]})
            per_step = {n: v for n, v in rec[
                "train_kernel_launches_per_step"].items() if v}
            if sorted(per_step.values()) != [n_dirs] * 3:
                failures.append(f"{k}: launches a step {per_step}")

    # the compiled (inductor) loss and backward of one module, eager beside
    name = "footcontact"
    cfg = M.MODULE_CONFIGS[name]
    dirs = cfg.n_layers * (2 if cfg.bidirectional else 1)
    block = cast_params(p16[name], bf16).requires_grad_(True)
    draws = M.draw(name, batch, torch.Generator(device="cuda").manual_seed(2))

    def loss_fn(block, batch, draws):
        return M.LOSSES[name](block, batch, draws, train=True,
                              backend="auto_train")

    compiled = torch.compile(loss_fn, fullgraph=True)
    runs = {}
    for label, fn in (("eager", loss_fn), ("compile", compiled),
                      ("compiled", compiled)):
        block.zero_grad(set_to_none=True)
        train_cuda.reset_launches()
        t0 = time.perf_counter()
        loss = fn(block, batch, draws)
        loss.backward()
        torch.cuda.synchronize()
        runs[label] = (float(loss), [p.grad.clone() for p in
                                     block.parameters()],
                       {k: n for k, n in train_cuda.launches.items() if n},
                       time.perf_counter() - t0)
    (l_e, g_e, n_e, _), (l_c, g_c, n_c, t_c) = runs["eager"], runs["compiled"]
    loss_rel = abs(l_c - l_e) / abs(l_e)
    grad_ulps = max(ulps_apart([a], [b]) for a, b in zip(g_c, g_e))
    expect = {"lstm_train_fwd_f32": dirs, "lstm_train_bwd_wbf16": dirs,
              "lstm_train_dw_f32": dirs}
    emit({"phase": "bf16_train_compiled", "module": name,
          "backend": "inductor", "loss_rel_err": loss_rel,
          "loss_rtol": COMPILED_LOSS_RTOL, "grad_max_ulps": grad_ulps,
          "grad_ulps_tol": COMPILED_GRAD_ULPS, "eager_launches": n_e,
          "compiled_launches": n_c,
          "compile_seconds": runs["compile"][3], "compiled_seconds": t_c,
          "eager_seconds": runs["eager"][3]})
    if loss_rel > COMPILED_LOSS_RTOL or grad_ulps > COMPILED_GRAD_ULPS:
        failures.append(f"compiled {name}: loss {loss_rel}, gradients "
                        f"{grad_ulps} ulps")
    if not (n_e == n_c == expect):
        failures.append(f"compiled {name}: launches eager {n_e}, compiled "
                        f"{n_c}, expected {expect}")

    # forward(backend='fused') exported, the weights as inputs
    net = MobilePoserNet(body, device="cuda")
    imu = torch.from_numpy((np.random.RandomState(3).randn(256, 45, 60)
                            * 0.1).astype(np.float32)).cuda()

    def fn(modules, imu):
        return forward(modules, imu, net.body_model, backend="fused")

    def counts():
        return {k: n for k, n in {**lstm_cuda.launches,
                                  **multicell_cuda.launches}.items() if n}

    t0 = time.perf_counter()
    prog = serving._export(net, p32, fn, (imu,), f32)
    export_s = time.perf_counter() - t0
    nodes = {}
    for n in prog.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith(
                "mobileposer_tpu_torch."):
            nodes[str(n.target)] = nodes.get(str(n.target), 0) + 1
    outs = {}
    with torch.no_grad():
        for label, call in (("eager", lambda: fn(p32, imu)),
                            ("exported", lambda: prog.module()(
                                serving._weights(p32), imu))):
            lstm_cuda.reset_launches()
            multicell_cuda.reset_launches()
            out = call()
            torch.cuda.synchronize()
            outs[label] = (torch.utils._pytree.tree_leaves(out), counts())
    err = max(float((a - b).abs().max())
              for a, b in zip(outs["exported"][0], outs["eager"][0]))
    expect = {"multicell_scan_f32": 2, "bilstm_scan_f32": 2}
    emit({"phase": "fused_export", "B": 256, "T": 45,
          "export_seconds": export_s, "graph_ops": nodes,
          "max_abs_err_vs_eager": err, "eager_launches": outs["eager"][1],
          "exported_launches": outs["exported"][1]})
    if err != 0.0:
        failures.append(f"exported fused forward {err} from eager")
    if nodes != {"mobileposer_tpu_torch.multicell_lstm.default": 2,
                 "mobileposer_tpu_torch.bilstm_layer.default": 2}:
        failures.append(f"exported fused forward graph ops {nodes}")
    if not (outs["eager"][1] == outs["exported"][1] == expect):
        failures.append(f"fused launches eager {outs['eager'][1]}, "
                        f"exported {outs['exported'][1]}")
    require(not failures, "; ".join(failures))
    return main_launches


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

    mark("start")
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
    # the CPU port's serving steps, the references of phase 4e, in
    # processes of their own from here on; stopped whichever way the
    # script ends
    cpu_serving = CpuServing()
    atexit.register(cpu_serving.close)
    mark("2 build")

    # 3. each kernel against its plain version
    kernel_recs = phase_kernels(torch, lstm_cuda)
    mark("3")
    # 3b. each masked kernel against its plain version
    kernel_recs += phase_masked_kernels(torch, lstm_cuda)
    mark("3b")
    # 3c. the training kernels against their plain versions
    train_recs = phase_train_kernels(torch, train_cuda,
                                     ptxas["lstm_train.cu"])
    mark("3c")
    # 3h. the bf16res entries of #7 and #8 against the f32 entries and
    # their plain versions
    train_recs += phase_train_bf16res_kernels(torch, train_cuda)
    mark("3h")
    # 3i. the entries of #7 and #8 for bf16 params (bf16 I/O, and float32
    # I/O beside bf16 w_hh) against their plain versions
    train_recs += phase_train_bf16_kernels(torch, train_cuda)
    mark("3i")
    # 3d. the int8 kernels against their plain versions
    kernel_recs += phase_int8_kernels(torch, lstm_cuda)
    mark("3d")
    # 3e. the multicell kernel against its plain version
    kernel_recs += phase_multicell(torch, multicell_cuda, lstm_cuda)
    mark("3e")
    # 3f. the bf16-I/O entries of #1, #2, #3 and #9 against their plain
    # versions
    kernel_recs += phase_bf16_kernels(torch, lstm_cuda, multicell_cuda)
    mark("3f")
    # 3g. the bf16-I/O entries of #4, #5 and #6 against their plain
    # versions
    kernel_recs += phase_int8_bf16_kernels(torch, lstm_cuda)
    mark("3g")

    # the CPU port's evaluations, the references of phases 4b, 4f and 4g,
    # in processes of their own while the card runs phases 4 to 4d; they
    # are stopped whichever way the script ends
    cpu_evals = CpuEvals(torch)
    atexit.register(cpu_evals.close)

    # 4. the streaming slice on the card, float32 then int8 (their
    # main-path runs: the full-length counters are read on them)
    multicell_cuda.reset_launches()
    stream_launches = phase_slice(torch, lstm_cuda)
    stream_int8_launches = phase_slice(torch, lstm_cuda, int8=True)
    mark("4")
    # 4b. the evaluation entry point, float32 then --int8 (their offline
    # runs: the masked counters)
    offline_launches, online_launches, card_f32 = phase_eval(
        torch, lstm_cuda, cpu_evals)
    offline_int8_launches, online_int8_launches, card_int8 = phase_eval(
        torch, lstm_cuda, cpu_evals, int8=True)
    # the ONLINE protocol in carry mode, float32 and int8: no LSTM kernel
    for int8 in (False, True):
        phase_eval(torch, lstm_cuda, cpu_evals, int8=int8,
                   online_mode="carry")
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
    mark("4b")
    # 4c. the training entry point, float32 then bf16 residuals (their
    # runs: the training counters)
    train_launches, train16_launches = phase_train(torch, lstm_cuda,
                                                   train_cuda)
    mark("4c")
    # the multicell kernel is `forward(backend='fused')`'s alone
    require(multicell_cuda.launches["multicell_scan_f32"] == 0,
            "the streaming, evaluation or training path launched the "
            "multicell kernel")
    # 4d. the fused single-window forward (its run: the multicell counter)
    fused_launches = phase_fused(torch, lstm_cuda, multicell_cuda)
    mark("4d")
    # every CPU evaluation done before the paced serving runs, which the
    # host's load would slow
    cpu_evals.wait()
    mark("4e wait for the CPU evaluations")
    # 4e. the serving entry point (its runs: the full-length counters of
    # the exact float32 and int8 servers)
    serving_launches = phase_serving(torch, lstm_cuda, smi, cpu_serving)
    cpu_serving.close()
    serving_by_kernel = {
        name: serving_launches["int8" if "int8" in name else "f32"][name]
        for name in ("bilstm_scan_f32", "lstm_scan_f32", "bilstm_scan_int8",
                     "lstm_scan_int8")}
    for name, n in serving_by_kernel.items():
        require(n > 0, f"{name} was never launched by the server")
    # 4f. the bf16 slice: streaming and the fused forward (their runs: the
    # full-length and multicell bf16 counters), `cli.evaluate --bf16` (its
    # offline run: the masked bf16 counters), bf16 serving
    bf16_stream_launches, bf16_fused_launches = phase_bf16_slice(
        torch, lstm_cuda, multicell_cuda)
    bf16_offline_launches, _, _ = phase_eval(torch, lstm_cuda, cpu_evals,
                                             bf16=True)
    bf16_serving = phase_bf16_serving(torch, lstm_cuda, smi)
    for name in ("bilstm_scan_bf16", "lstm_scan_bf16"):
        serving_by_kernel[name] = bf16_serving[name]
        require(bf16_serving[name] > 0,
                f"{name} was never launched by the bf16 server")
    mark("4f")
    # 4g. int8 on bf16 params: streaming exact and carry (the exact runs:
    # the full-length int8 bf16 counters), `cli.evaluate --int8 --bf16`
    # (its offline run: the masked int8 bf16 counters), serving
    int8_bf16_stream_launches = phase_slice(torch, lstm_cuda, int8=True,
                                            bf16=True)
    int8_bf16_offline_launches, _, _ = phase_eval(
        torch, lstm_cuda, cpu_evals, int8=True, bf16=True)
    cpu_evals.close()
    int8_bf16_serving = phase_bf16_serving(torch, lstm_cuda, smi,
                                           quantize="int8")
    for name in ("bilstm_scan_int8_bf16", "lstm_scan_int8_bf16"):
        serving_by_kernel[name] = int8_bf16_serving[name]
        require(int8_bf16_serving[name] > 0,
                f"{name} was never launched by the int8 bf16 server")
    mark("4g")
    # 4h. the AOT serving bundle: exported, saved, loaded and run (its
    # loaded runs: the bundle counters)
    bundle_launches = phase_bundle(torch, lstm_cuda)
    mark("4h")
    # 4i. the offline recipe: raw-data processing, finetune, example,
    # overfit (their runs: the recipe counters)
    recipe_launches = phase_recipe(torch, lstm_cuda, train_cuda)
    mark("4i")
    # 4j. the live runtime: the step card against CPU, the loopback loop,
    # the live demo CLI (its loop runs: the live counters)
    live_recs, live_launches = phase_live(torch, lstm_cuda)
    mark("4j")
    kernel_recs += live_recs
    main_launches = {
        **{k: n for k, n in stream_launches.items() if k.endswith("f32")
           and "masked" not in k},
        **{k: n for k, n in offline_launches.items() if k.endswith("f32")
           and "masked" in k},
        **{k: n for k, n in stream_int8_launches.items()
           if k.endswith("int8") and "masked" not in k},
        **{k: n for k, n in offline_int8_launches.items()
           if k.endswith("int8") and "masked" in k},
        **{k: n for k, n in train_launches.items() if k.endswith("f32")},
        **{f"lstm_train_{k}_bf16res": train16_launches[
            f"lstm_train_{k}_bf16res"] for k in ("fwd", "bwd", "dw")},
        "multicell_scan_f32": fused_launches["multicell_scan_f32"],
        **{k: bf16_stream_launches[k] for k in ("bilstm_scan_bf16",
                                                "lstm_scan_bf16")},
        **{k: bf16_offline_launches[k] for k in ("bilstm_scan_masked_bf16",
                                                 "lstm_scan_masked_bf16")},
        "multicell_scan_bf16": bf16_fused_launches["multicell_scan_bf16"],
        **{k: int8_bf16_stream_launches[k] for k in (
            "bilstm_scan_int8_bf16", "lstm_scan_int8_bf16")},
        **{k: int8_bf16_offline_launches[k] for k in (
            "bilstm_scan_masked_int8_bf16", "lstm_scan_masked_int8_bf16")}}
    for name, n in main_launches.items():
        require(n > 0, f"{name} was never launched on its main path")
    for name in ("bilstm_scan_f32", "lstm_scan_f32"):
        require(live_launches.get(name, 0) > 0,
                f"{name} was never launched by the live loop")
    # 4k. data parallelism: sharded evaluation and serving, two-rank
    # training, each against one device (their runs: the parallel
    # counters), and the kernels at the per-shard shapes
    shard_recs, parallel_launches = phase_parallel(
        torch, lstm_cuda, train_cuda, smi, ptxas["lstm_train.cu"])
    for name in ("bilstm_scan_f32", "lstm_scan_f32", "bilstm_scan_masked_f32",
                 "lstm_scan_masked_f32", "lstm_scan_int8", "bilstm_scan_int8",
                 "bilstm_scan_masked_int8", "lstm_scan_masked_int8",
                 "lstm_train_fwd_f32", "lstm_train_bwd_f32",
                 "lstm_train_dw_f32"):
        require(parallel_launches.get(name, 0) > 0,
                f"{name} was never launched on the sharded paths")
    # 4l. the rest of the library: SequenceLoader, RNNWithInit, the
    # physics layer, SMPLViewer and cli.render (their runs: the library
    # counters)
    library_launches = phase_library(torch, lstm_cuda, train_cuda, smi)
    for name in ("bilstm_scan_f32", "lstm_scan_f32", "lstm_scan_masked_f32",
                 "lstm_train_fwd_f32", "lstm_train_bwd_f32",
                 "lstm_train_dw_f32"):
        require(library_launches.get(name, 0) > 0,
                f"{name} was never launched on the library's paths")
    mark("4l")
    # 4m. training on bf16 params: the concurrent step on the new entries
    # (their runs: the bf16-param counters), its time and memory beside
    # C4's and C9's, a compiled module's loss and backward, the exported
    # fused forward
    bf16_train_launches = phase_bf16_train(torch, lstm_cuda, train_cuda,
                                           multicell_cuda)
    for name in (*(f"lstm_train_{k}_{s}" for k in ("fwd", "bwd")
                   for s in ("bf16", "bf16_bf16res")),
                 "lstm_train_bwd_wbf16", "lstm_train_bwd_wbf16_bf16res"):
        require(bf16_train_launches.get(name, 0) > 0,
                f"{name} was never launched on its main path")
        main_launches[name] = bf16_train_launches[name]
    mark("4m")

    # 5. exact-path streamed frames/s (tracing off), then one traced call;
    # at 256 streams (C1's shape) the same on bf16 params beside it
    for streams in (256, 8):
        rec = bench.run(n_streams=streams, n_frames=RATE_FRAMES,
                        trials=RATE_TRIALS)
        emit({"phase": "rate", **rec})
        require(rec["pct_of_f32_peak"] < 100.0,
                "implied FLOP/s above the card's peak: the harness is wrong")
        trace = bench.breakdown(n_streams=streams, n_frames=RATE_FRAMES)
        emit({"phase": "breakdown", **trace})
        require(trace["device_busy_seconds"] > 0,
                "the traced call shows no device time")
        if streams == 256:
            rec16 = bench.run(n_streams=256, n_frames=RATE_FRAMES, bf16=True,
                              trials=RATE_TRIALS)
            emit({"phase": "rate", **rec16,
                  "f32_value_same_run": rec["value"],
                  "bf16_over_f32": rec16["value"] / rec["value"]})
            require(rec16["pct_of_f32_peak"] < 100.0,
                    "implied FLOP/s above the card's peak: the harness is "
                    "wrong")
            trace = bench.breakdown(n_streams=256, n_frames=RATE_FRAMES,
                                    bf16=True)
            emit({"phase": "breakdown", **trace})
            require(any(g.endswith("bf16") for g in trace["groups"]),
                    "the traced bf16 call shows no bf16 kernel")
    # the same on W8A8 params at 256 streams (the JAX bench's exact_int8)
    rec = bench.run(n_streams=256, n_frames=RATE_FRAMES, mode="scan",
                    int8=True, trials=RATE_TRIALS)
    emit({"phase": "rate", **rec})
    require(rec["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    trace = bench.breakdown(n_streams=256, n_frames=RATE_FRAMES, mode="scan",
                            int8=True)
    emit({"phase": "breakdown", **trace})
    require(any("int8" in g for g in trace["groups"]),
            "the traced int8 call shows no int8 kernel")
    # int8 on bf16 params (the JAX bench's exact_int8 leg as written)
    # beside C5 (int8 on float32 params) and C7 (bf16)
    rec8 = bench.run(n_streams=256, n_frames=RATE_FRAMES, mode="scan",
                     int8=True, bf16=True, trials=RATE_TRIALS)
    emit({"phase": "rate", **rec8, "int8_f32_value_same_run": rec["value"],
          "bf16_value_same_run": rec16["value"],
          "over_int8_f32": rec8["value"] / rec["value"],
          "over_bf16": rec8["value"] / rec16["value"]})
    require(rec8["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    trace = bench.breakdown(n_streams=256, n_frames=RATE_FRAMES, mode="scan",
                            int8=True, bf16=True)
    emit({"phase": "breakdown", **trace})
    require(any("int8" in g and g.endswith("bf16") for g in trace["groups"]),
            "the traced int8 bf16 call shows no int8 bf16 kernel")

    mark("5")
    # 5b. offline-evaluation frames/s of one 64 x 512 ragged group
    rec = bench.run_offline(batch=64, bucket=512)
    emit({"phase": "offline_rate", **rec})
    require(rec["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    trace = bench.breakdown_offline(batch=64, bucket=512)
    emit({"phase": "offline_breakdown", **trace})
    require(trace["device_busy_seconds"] > 0,
            "the traced offline call shows no device time")

    mark("5b")
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
    # C9: the same step on bf16 residuals, beside C4's rate and peak
    # memory, then one traced step that must show the bf16res kernels
    rec16 = bench.run_train(batch=256, window=125, bf16_residuals=True)
    emit({"phase": "train_rate", **rec16, "f32_value_same_run": rec["value"],
          "over_f32": rec16["value"] / rec["value"],
          "f32_peak_memory_bytes": rec["peak_memory_bytes"],
          "peak_memory_saved_bytes": rec["peak_memory_bytes"]
          - rec16["peak_memory_bytes"]})
    require(rec16["pct_of_f32_peak"] < 100.0,
            "implied FLOP/s above the card's peak: the harness is wrong")
    require(rec16["train_kernel_launches_per_step"]
            == {k: n // 2 for k, n in train16_launches.items()},
            f"bench bf16res step launches "
            f"{rec16['train_kernel_launches_per_step']}")
    trace = bench.breakdown_train(batch=256, window=125, bf16_residuals=True)
    emit({"phase": "train_breakdown", **trace})
    train_groups = [g for g in trace["groups"] if "lstm_train" in g]
    require(len(train_groups) == 3
            and all(g.endswith("bf16res") for g in train_groups),
            f"the traced bf16res step's training kernels: {train_groups}")

    mark("5c")
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

    mark("5d")
    emit({"phase": "phase_seconds",
          "seconds": {b[0]: b[1] - a[1] for a, b in zip(MARKS, MARKS[1:])},
          "total_seconds": MARKS[-1][1] - MARKS[0][1]})

    # 6. kernels line: each kernel's main-path shape (streaming: T=45,
    # H=256, B=256; evaluation: T=512, H=256, B=64; training: T=125,
    # H=256, B=256; fused: T=45, B=256, the trio's five cells); the int8
    # kernels have no library yardstick and carry the float kernel's time
    # at the same shape, the multicell kernel the per-module kernels' time
    ported = []
    for tpu_name, replaces, name in TPU_KERNELS:
        recs = [r for r in kernel_recs + train_recs if r["name"] == name]
        multicell = name.startswith("multicell")
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
        extra = {k: main[k] for k in ("float_kernel_ms",
                                      "int8_f32_kernel_ms",
                                      "per_module_kernels_ms",
                                      "f32_entry_ms",
                                      "max_err_ulps") if k in main}
        ported.append({
            "name": name, "route": "cuda",
            "source": f"mobileposer_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(errs),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], **extra,
            "serving_launches": serving_by_kernel.get(name, 0),
            "bundle_launches": bundle_launches.get(name, 0),
            "recipe_launches": recipe_launches.get(name, 0),
            "live_launches": live_launches.get(name, 0),
            "parallel_launches": parallel_launches.get(name, 0),
            "library_launches": library_launches.get(name, 0),
            "shape": {"T": T, "B": B, "H": main["H"]}})
        shard = next((r for r in shard_recs if r["name"] == name
                      and r["H"] == 256), None)
        if shard is not None:
            ported[-1]["per_shard"] = {
                k: shard[k] for k in ("T", "B", "H", "max_abs_err",
                                      "kernel_ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}
    emit({"kernels": ported,
          "online_eval_launches": online_launches,
          "online_eval_int8_launches": online_int8_launches,
          "not_ported": [], "variants_not_ported": []})

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
