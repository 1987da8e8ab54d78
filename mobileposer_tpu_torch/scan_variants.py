"""Time edited copies of the full-length layer scans (`ops/csrc/lstm_scan.cu`,
or with --int8 the int8 cluster scans of `ops/csrc/lstm_scan_int8.cu`)
against the checked-in kernel on one card, in turns.

    python -m mobileposer_tpu_torch.scan_variants [--int8] [--variants a,b]
        [--out FILE]

Each variant is the checked-in source with a few text edits (`VARIANTS`,
`INT8_VARIANTS`): another layout of the products, or a part of the step
left out to see what it costs (those compute wrong values and say so).
Each is built with nvcc as the kernel itself is, run at the shapes of
`chip_smoke.py` phase 3 (`SHAPES`; with --int8, phase 3d's `INT8_SHAPES`)
with the rows per cluster `lstm_cuda.scan_geometry` picks, held to the
checked-in kernel (max abs difference) and timed with CUDA events in
turns: the kernel, each variant, then back in reverse order. Prints one
JSON line per shape (with --out, writes them to FILE as well). No variant
is reachable from the port's entry points. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mobileposer_tpu_torch.ops import _build, lstm_cuda
from mobileposer_tpu_torch.ops.quant import quantize_weight_int8

_K_LOOP = ("      } else {\n"
           "        for (int k = 0; k < H; k += 4) k_group(k);\n")
_PRODUCTS = "    if (rows > 0) {\n      // gates = x_proj"
_PUSH = ("      for (int q = 0; q < n_cta; ++q)\n        cluster."
         "map_shared_rank(h_next, q)[r * H + unit0 + u] = h;\n")
_OWN_PUSH = "      h_next[r * H + unit0 + u] = h;\n"
_END = "    cluster.sync();\n    cur ^= 1;\n"

#: name: (what it changes, [(old, new, times old must occur)])
VARIANTS = {
    "one_col": ("one gate column per lane at every rows (16 product warps)",
                [(", 4));", ", 1));", 10)]),
    "four_col": ("four gate columns per lane also at rows <= 2",
                 [("CALL(1, 1)", "CALL(1, 4)", 1)]),
    "unroll2": ("the k loop unrolled twice (at rows per lane other than 3)",
                [(_K_LOOP, _K_LOOP.replace("        for",
                                           "#pragma unroll 2\n        for"),
                  1)]),
    "no_products": ("the products left out (wrong values)",
                    [(_PRODUCTS, _PRODUCTS.replace("rows > 0", "T < 0"), 1)]),
    "no_remote": ("h pushed to the CTA's own buffer only (wrong values)",
                  [(_PUSH, _OWN_PUSH, 1)]),
    "no_cluster_barrier": ("no_remote, and a CTA barrier in place of the "
                           "step's cluster barrier (wrong values)",
                           [(_PUSH, _OWN_PUSH, 1),
                            (_END, _END.replace("cluster.sync",
                                                "__syncthreads"), 1)]),
}

_I8_PRODUCTS = "      if (s < n_ks) {\n#pragma unroll\n        for (int m"
_I8_QUANTIZE = "static_cast<int8_t>(quantize(h[p], scale[p]))"
_I8_Q_PUSH = ("      for (int cq = 0; cq < n_cta; ++cq)\n"
              "        cluster.map_shared_rank(q_s, cq)[r * S + unit0 + u]"
              " = q;\n")
_I8_MAX_PUSH = ("      if (lane < n_cta)\n"
                "        cluster.map_shared_rank(amax_s, lane)"
                "[r * kMaxCtas + cta] = m;\n")
_I8_OWN = [(_I8_Q_PUSH, "      q_s[r * S + unit0 + u] = q;\n", 1),
           (_I8_MAX_PUSH,
            "      if (lane < n_cta) amax_s[r * kMaxCtas + lane] = m;\n", 1)]
_I8_BARRIERS = [("    cluster.sync();  // q complete everywhere",
                 "    __syncthreads();  // q complete everywhere", 1),
                ("    // sums of this step any more\n    cluster.sync();",
                 "    // sums of this step any more\n    __syncthreads();", 1)]

#: the same for the int8 cluster body (--int8): the parts of its step
INT8_VARIANTS = {
    "no_products": ("the mma products left out (wrong values)",
                    [(_I8_PRODUCTS,
                      _I8_PRODUCTS.replace("s < n_ks", "s < n_ks && T < 0"),
                      1)]),
    "no_quantize": ("the division and rounding of the quantization left out, "
                    "the row scales and the pushes of q kept (wrong values)",
                    [(_I8_QUANTIZE, "static_cast<int8_t>(h[p] > scale[p])",
                      1)]),
    "no_remote": ("q and the row maxima written to the CTA's own buffers "
                  "only (wrong values)", _I8_OWN),
    "no_cluster_barrier": ("no_remote, and CTA barriers in place of the "
                           "step's two cluster barriers (wrong values)",
                           _I8_OWN + _I8_BARRIERS),
}

# (entry, H, B): chip_smoke.py phase 3's shapes, T = 45
SHAPES = [("bilstm_scan_f32", 256, 256), ("bilstm_scan_f32", 64, 256),
          ("lstm_scan_f32", 256, 256), ("bilstm_scan_f32", 256, 200),
          ("bilstm_scan_f32", 64, 200), ("lstm_scan_f32", 256, 8),
          ("lstm_scan_f32", 160, 1), ("bilstm_scan_f32", 160, 37)]
# phase 3d's: the int8 scan mode at 256 streams and the unfolded velocity
# layer at 8
INT8_SHAPES = [("bilstm_scan_int8", 256, 256), ("lstm_scan_int8", 256, 256),
               ("lstm_scan_int8", 256, 8)]
T = 45


def _source(int8: bool) -> str:
    return "lstm_scan_int8.cu" if int8 else "lstm_scan.cu"


def variant_source(name: str, int8: bool = False) -> str:
    src = (_build.CSRC_DIR / _source(int8)).read_text()
    for old, new, count in (INT8_VARIANTS if int8 else VARIANTS)[name][1]:
        if src.count(old) != count:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{src.count(old)} times, not {count}")
        src = src.replace(old, new)
    return src


def build_variant(name: str, int8: bool = False):
    """nvcc the variant into ops/build/variants/; returns (library, ptxas
    register and spill lines)."""
    src = variant_source(name, int8)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{name}-{hashlib.sha256(src.encode()).hexdigest()[:12]}"
    cu = out_dir / f"{stem}.cu"
    cu.write_text(src)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
         "-o", str(out_dir / f"{stem}.so"), str(cu)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out_dir / f"{stem}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for entry, n_ptr in lstm_cuda._ENTRIES[_source(int8)].items():
        if entry in lstm_cuda._ROWS_ENTRIES and "masked" not in entry:
            getattr(lib, entry).argtypes = [P] * n_ptr + [I] * 4 + [P]
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "spill" in ln and not ln.strip().startswith("0 bytes")]
    return lib, ptxas


def _inputs(name: str, H: int, B: int):
    """phase 3's seeded inputs (per direction x_proj, w_hh, h0, c0), or
    for an int8 entry phase 3d's (x_proj, int8 w_hh, w_scale, h0, c0)."""
    if "int8" in name:
        return _int8_inputs(name, H, B)
    rng = np.random.RandomState(H + B)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).cuda()

    bound = 1.0 / math.sqrt(H)
    return [(t(T, B, 4 * H),
             torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H))
                              .astype(np.float32)).cuda(),
             t(B, H, scale=0.5), t(B, H, scale=0.5))
            for _ in range(2 if name == "bilstm_scan_f32" else 1)]


def _int8_inputs(name: str, H: int, B: int):
    rng = np.random.RandomState(H + B + T + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    bound = 1.0 / math.sqrt(H)
    dirs = []
    for _ in range(2 if name.startswith("bi") else 1):
        w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound,
                                                    (H, 4 * H)))
        dirs.append((t(rng.randn(T, B, 4 * H)), torch.from_numpy(w_q).cuda(),
                     t(w_s), t(np.tanh(rng.randn(B, H))),
                     t(rng.randn(B, H) * 0.5)))
    return dirs


def _launcher(lib, name: str, dirs):
    """A function that launches `name` of `lib` on `dirs` into fixed
    outputs and returns them (ys, then h_T, c_T, per direction)."""
    _, B, H4 = dirs[0][0].shape
    H = H4 // 4
    outs = ([torch.empty((T, B, H), device="cuda") for _ in dirs]
            + [torch.empty((B, H), device="cuda")
               for _ in range(2 * len(dirs))])
    int8 = "int8" in name
    rows = lstm_cuda.scan_geometry(len(dirs), B, H, dirs[0][0].device,
                                   int8=int8).rows
    n_w = 3 if int8 else 2  # x_proj, w_hh (and w_scale) lead, by direction
    ins = ([x for d in dirs for x in d] if len(dirs) == 1 else
           [d[i] for i in range(n_w) for d in dirs]
           + [*dirs[0][n_w:], *dirs[1][n_w:]])
    ptrs = [t.data_ptr() for t in ins + outs]

    def launch():
        err = getattr(lib, name)(*ptrs, T, B, H, rows,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return outs
    return launch


def _time_ms(fn, n: int = 20) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true",
                    help="the int8 cluster scans' variants")
    ap.add_argument("--variants", default=None,
                    help="comma-separated (default: every variant)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: no CUDA device; the kernels run on "
                         "the card")
    table = INT8_VARIANTS if args.int8 else VARIANTS
    names = (args.variants or ",".join(table)).split(",")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        # the kernel itself, its entries declared
        base = pool.submit(lstm_cuda._lib, _source(args.int8))
        built = dict(zip(names, pool.map(
            lambda n: build_variant(n, args.int8), names)))
        libs = {"kernel": base.result(), **{n: b[0] for n, b in built.items()}}
    lines = [{"ptxas_spills": {n: b[1] for n, b in built.items()},
              "variants": {n: table[n][0] for n in names}}]
    print(json.dumps(lines[-1]), flush=True)
    order = ["kernel", *names, *reversed(names), "kernel"]
    for name, H, B in INT8_SHAPES if args.int8 else SHAPES:
        dirs = _inputs(name, H, B)
        runs = {n: _launcher(lib, name, dirs) for n, lib in libs.items()}
        want = [x.clone() for x in runs["kernel"]()]
        diff = {}
        for n in names:
            got = runs[n]()
            diff[n] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        times = {n: [] for n in libs}
        for n in order:
            times[n].append(_time_ms(runs[n]))
        geo = lstm_cuda.scan_geometry(len(dirs), B, H, dirs[0][0].device,
                                      int8=args.int8)
        lines.append({"name": name, "T": T, "B": B, "H": H,
                      "rows_per_cluster": geo.rows,
                      "max_abs_diff_vs_kernel": diff,
                      "ms": {n: sum(v) / len(v) for n, v in times.items()},
                      "ms_turns": times})
        print(json.dumps(lines[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
