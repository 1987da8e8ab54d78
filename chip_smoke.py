#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's exact streaming path on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels of `mobileposer_tpu_torch` from this checkout,
then runs these phases, each printing JSON lines:

  1. card    — `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build   — nvcc time (set-up, not kernel time) and ptxas usage;
  3. kernel  — each kernel against its plain PyTorch version at the
               streaming shapes (f32, TF32 off, nonzero h0/c0): max abs
               error, kernel / plain / cuDNN `torch.nn.LSTM` times, and
               the card's bound for the same work;
  4. slice   — the trained fixture weights through
               `forward_online_sequence_batched` on the card in 'scan'
               and 'unfolded' modes, each continued from its final state,
               held to the same calls on the CPU port; the kernels'
               launch counters must move by the expected counts;
  5. rate    — exact-path streamed frames/s (`mobileposer_tpu_torch.bench`)
               at 256 streams (scan) and 8 streams (unfolded), then one
               traced call of each: device time by kernel group and the
               device's busy share;
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
import subprocess
import sys
import time
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

HBM_BYTES_PER_S = 3.35e12    # H100 SXM
F32_FLOPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores

# file:line of each TPU kernel (the `pallas_call` site's function)
TPU_KERNELS = [
    ("bilstm_layer_pallas", "mobileposer_tpu/ops/lstm_pallas.py:264",
     "bilstm_scan_f32"),
    ("lstm_layer_pallas", "mobileposer_tpu/ops/lstm_pallas.py:73",
     "lstm_scan_f32"),
    ("lstm_layer_masked_pallas", "mobileposer_tpu/ops/lstm_pallas.py:163",
     None),
    ("lstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:434",
     None),
    ("lstm_layer_masked_pallas_int8",
     "mobileposer_tpu/ops/lstm_pallas.py:354", None),
    ("bilstm_layer_pallas_int8", "mobileposer_tpu/ops/lstm_pallas.py:523",
     None),
    ("_fwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:90", None),
    ("_bwd_call", "mobileposer_tpu/ops/lstm_train_pallas.py:202", None),
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


def layer_bound(n_dir: int, T: int, B: int, H: int):
    """Least time (ms) the card needs for one layer scan: each input read
    once, each output written once, the recurrent products at the
    float32 rate. Returns (bound_ms, bound_by, flops, bytes)."""
    flops = n_dir * T * 2.0 * B * H * 4 * H
    floats = n_dir * (T * B * 4 * H      # x_proj
                      + H * 4 * H        # w_hh
                      + 2 * B * H        # h0, c0
                      + T * B * H        # ys
                      + 2 * B * H)       # h_T, c_T
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
            expect = {"bilstm_scan_f32": 6 * n_windows, "lstm_scan_f32": 2 * N}

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

    # 2. build (set-up time, not kernel time)
    t0 = time.perf_counter()
    lstm_cuda.build()
    log = _build.library_path("lstm_scan.cu").with_suffix(".log")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. each kernel against its plain version
    kernel_recs = phase_kernels(torch, lstm_cuda)

    # 4. the slice on the card (the main-path run the counters are read on)
    main_launches = phase_slice(torch, lstm_cuda)
    for name, n in main_launches.items():
        require(n > 0, f"{name} was never launched on the main path")

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

    # 6. kernels line: the main-path shape's numbers (H=256, B=256)
    sources = "mobileposer_tpu_torch/ops/csrc/lstm_scan.cu"
    ported = []
    for tpu_name, replaces, name in TPU_KERNELS:
        if name is None:
            continue
        recs = [r for r in kernel_recs if r["name"] == name]
        main = next(r for r in recs if r["H"] == 256 and r["B"] == 256)
        ported.append({
            "name": name, "route": "cuda", "source": sources,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": {"T": 45, "B": 256,
                                                         "H": 256}})
    emit({"kernels": ported,
          "not_ported": [{"name": n, "replaces": r, "status": "to port"}
                         for n, r, p in TPU_KERNELS if p is None]})

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
