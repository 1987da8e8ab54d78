"""Time edited copies of the full-length layer scans (`ops/csrc/lstm_scan.cu`)
against the checked-in kernel on one card, in turns.

    python -m mobileposer_tpu_torch.scan_variants [--variants a,b] [--out FILE]

Each variant is the checked-in source with a few text edits (`VARIANTS`):
another layout of the products, or a part of the step left out to see what
it costs (those compute wrong values and say so). Each is built with nvcc
as the kernel itself is, run at the shapes of `chip_smoke.py` phase 3 with
the rows per cluster `lstm_cuda.scan_geometry` picks, held to the
checked-in kernel (max abs difference) and timed with CUDA events in
turns: the kernel, each variant, then back in reverse order. Prints one
JSON line per shape (with --out, writes them to FILE as well). Needs a
CUDA card.
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

# (entry, H, B): chip_smoke.py phase 3's shapes, T = 45
SHAPES = [("bilstm_scan_f32", 256, 256), ("bilstm_scan_f32", 64, 256),
          ("lstm_scan_f32", 256, 256), ("bilstm_scan_f32", 256, 200),
          ("bilstm_scan_f32", 64, 200), ("lstm_scan_f32", 256, 8),
          ("lstm_scan_f32", 160, 1), ("bilstm_scan_f32", 160, 37)]
T = 45


def variant_source(name: str) -> str:
    src = (_build.CSRC_DIR / "lstm_scan.cu").read_text()
    for old, new, count in VARIANTS[name][1]:
        if src.count(old) != count:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{src.count(old)} times, not {count}")
        src = src.replace(old, new)
    return src


def build_variant(name: str):
    """nvcc the variant into ops/build/variants/; returns (library, ptxas
    register and spill lines)."""
    src = variant_source(name)
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
    lib.lstm_scan_f32.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.bilstm_scan_f32.argtypes = [P] * 14 + [I] * 4 + [P]
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "spill" in ln and not ln.strip().startswith("0 bytes")]
    return lib, ptxas


def _inputs(name: str, H: int, B: int):
    """phase 3's seeded inputs (per direction x_proj, w_hh, h0, c0)."""
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


def _launcher(lib, name: str, dirs):
    """A function that launches `name` of `lib` on `dirs` into fixed
    outputs and returns them (ys, then h_T, c_T, per direction)."""
    _, B, H4 = dirs[0][0].shape
    H = H4 // 4
    outs = ([torch.empty((T, B, H), device="cuda") for _ in dirs]
            + [torch.empty((B, H), device="cuda")
               for _ in range(2 * len(dirs))])
    rows = lstm_cuda.scan_geometry(len(dirs), B, H, dirs[0][0].device).rows
    ins = ([x for d in dirs for x in d] if len(dirs) == 1 else
           [dirs[0][0], dirs[1][0], dirs[0][1], dirs[1][1], *dirs[0][2:],
            *dirs[1][2:]])
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
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: no CUDA device; the kernels run on "
                         "the card")
    names = args.variants.split(",")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        base = pool.submit(lstm_cuda._lib, "lstm_scan.cu")  # entries declared
        built = dict(zip(names, pool.map(build_variant, names)))
        libs = {"kernel": base.result(), **{n: b[0] for n, b in built.items()}}
    lines = [{"ptxas_spills": {n: b[1] for n, b in built.items()},
              "variants": {n: VARIANTS[n][0] for n in names}}]
    print(json.dumps(lines[-1]), flush=True)
    order = ["kernel", *names, *reversed(names), "kernel"]
    for name, H, B in SHAPES:
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
        geo = lstm_cuda.scan_geometry(len(dirs), B, H, dirs[0][0].device)
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
