"""Time edited copies of the full-length layer scans (`ops/csrc/lstm_scan.cu`,
or with --int8 the int8 cluster scans of `ops/csrc/lstm_scan_int8.cu`)
against the checked-in kernel on one card, in turns; with --multicell,
the multicell scan (`ops/csrc/multicell_scan.cu`) in each of its h
layouts against the layout its geometry picks.

    python -m mobileposer_tpu_torch.scan_variants [--int8 | --multicell]
        [--variants a,b] [--out FILE]

Each variant is the checked-in source with a few text edits (`VARIANTS`,
`INT8_VARIANTS`, `MULTICELL_VARIANTS`; an edit may name a shared header):
another layout of the products, or a part of the step left out to see
what it costs (those compute wrong values and say so). Each is built with
nvcc as the kernel itself is, run at the shapes of `chip_smoke.py` phase
3 (`SHAPES`; with --int8, phase 3d's `INT8_SHAPES`, a masked one among
them; with --multicell, phase 3e's `MULTICELL_BATCHES`) with the rows per
cluster the kernel's geometry picks (`lstm_cuda.scan_geometry`,
`multicell_cuda.multicell_geometry`), held to the checked-in kernel (max
abs difference) and timed with CUDA events in turns: the kernel, each
variant, then back in reverse order. --multicell also times the kernel
in each of its h layouts (`MULTICELL_LAYOUTS`, at the rows the geometry
picks for that layout). Prints one JSON line per shape (with --out,
writes them to FILE as well). No variant is reachable from the port's
entry points. Needs a CUDA card.
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

from mobileposer_tpu_torch.models.fused import _ROW_H
from mobileposer_tpu_torch.ops import _build, lstm_cuda, multicell_cuda
from mobileposer_tpu_torch.ops.quant import quantize_weight_int8

_BODY = "scan_body.cuh"  # the float body's edits change the shared header
_K_LOOP = ("      } else {\n"
           "        for (int k = 0; k < H; k += 4) k_group(k);\n")
_PRODUCTS = "    if (rows > 0) {\n      // gates = x_proj"
_PUSH = ("      for (int q = 0; q < n_cta; ++q)\n        cluster."
         "map_shared_rank(h_next, at.rank0 + q)[r * H + unit0 + u] = hx;\n")
_OWN_PUSH = "      h_next[r * H + unit0 + u] = hx;\n"
_END = "    cluster.sync();\n    if constexpr (!kSingleH) cur ^= 1;\n"

#: name: (what it changes, [([file,] old, new, times old must occur)])
VARIANTS = {
    "one_col": ("one gate column per lane at every rows (16 product warps)",
                [(", 4));", ", 1));", 10)]),
    "four_col": ("four gate columns per lane also at rows <= 2",
                 [("CALL(1, 1)", "CALL(1, 4)", 1)]),
    "unroll2": ("the k loop unrolled twice (at rows per lane other than 3)",
                [(_BODY, _K_LOOP,
                  _K_LOOP.replace("        for",
                                  "#pragma unroll 2\n        for"), 1)]),
    "no_products": ("the products left out (wrong values)",
                    [(_BODY, _PRODUCTS, _PRODUCTS.replace("rows > 0",
                                                          "T < 0"), 1)]),
    "no_remote": ("h pushed to the CTA's own buffer only (wrong values)",
                  [(_BODY, _PUSH, _OWN_PUSH, 1)]),
    "no_cluster_barrier": ("no_remote, and a CTA barrier in place of the "
                           "step's cluster barrier (wrong values)",
                           [(_BODY, _PUSH, _OWN_PUSH, 1),
                            (_BODY, _END, _END.replace("cluster.sync",
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

_MC_UNROLL = ("scan_body.cuh", "#pragma unroll 2\n", "", 1)
_MC_RT4 = "    default: return static_cast<int>(CALL(4, 4, kGroups));"

#: the multicell scan's (--multicell); an edit (file, old, new, count)
#: changes a header
MULTICELL_VARIANTS = {
    "rolled": ("the k loop of the sixteen row groups not unrolled",
               [_MC_UNROLL]),
    "groups8": ("eight row groups of one warp, up to 8 rows a lane, the k "
                "loop rolled (spills from 7 rows a lane on)",
                [_MC_UNROLL,
                 ("constexpr int kGroups = 16;", "constexpr int kGroups = 8; ",
                  1),
                 ("constexpr int kMaxRowsPerLane = 4;",
                  "constexpr int kMaxRowsPerLane = 8;", 1),
                 ("constexpr int kMaxDoubleRowsPerLane = 3;",
                  "constexpr int kMaxDoubleRowsPerLane = 8;", 1),
                 ("static_assert(kMaxRowsPerLane == 4,",
                  "static_assert(kMaxRowsPerLane == 8,", 1),
                 (_MC_RT4, " \\\n".join(
                     f"    {'default' if rt == 8 else f'case {rt}'}: return "
                     f"static_cast<int>(CALL({rt}, 4, kGroups));"
                     for rt in range(4, 9)), 1)]),
}

#: the multicell scan's h layouts (--multicell): name: (h_buffers, what)
MULTICELL_LAYOUTS = {
    "double_h": (2, "h double-buffered: one cluster barrier a step, at most "
                    "39 rows a group at H = 256"),
    "single_h": (1, "h single-buffered: two cluster barriers a step, up to "
                    "64 rows a group"),
}

# (entry, H, B): chip_smoke.py phase 3's shapes, T = 45
SHAPES = [("bilstm_scan_f32", 256, 256), ("bilstm_scan_f32", 64, 256),
          ("lstm_scan_f32", 256, 256), ("bilstm_scan_f32", 256, 200),
          ("bilstm_scan_f32", 64, 200), ("lstm_scan_f32", 256, 8),
          ("lstm_scan_f32", 160, 1), ("bilstm_scan_f32", 160, 37)]
# phase 3d's: the int8 scan mode at 256 streams, the unfolded velocity
# layer at 8, and an offline-evaluation group's masked bi layer (T = 512)
INT8_SHAPES = [("bilstm_scan_int8", 256, 256), ("lstm_scan_int8", 256, 256),
               ("lstm_scan_int8", 256, 8),
               ("bilstm_scan_masked_int8", 256, 64)]
# phase 3e's batches of the trio's five cells
MULTICELL_BATCHES = [256, 8]
T = 45
T_MASKED = 512

#: per kind: (source, variants)
_KINDS = {"float": ("lstm_scan.cu", VARIANTS),
          "int8": ("lstm_scan_int8.cu", INT8_VARIANTS),
          "multicell": ("multicell_scan.cu", MULTICELL_VARIANTS)}


def variant_sources(name: str, kind: str = "float") -> dict:
    """{file: text} of the variant's edited files: its source, and each
    header an edit names."""
    source, table = _KINDS[kind]
    files = {}
    for edit in table[name][1]:
        fname, old, new, count = (edit if len(edit) == 4
                                  else (source, *edit))
        if fname not in files:
            files[fname] = (_build.CSRC_DIR / fname).read_text()
        if files[fname].count(old) != count:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{files[fname].count(old)} times in {fname}, "
                               f"not {count}")
        files[fname] = files[fname].replace(old, new)
    files.setdefault(source, (_build.CSRC_DIR / source).read_text())
    return files


def build_variant(name: str, kind: str = "float"):
    """nvcc the variant into its own directory under ops/build/variants/
    (an edited header beside the source is found before the checked-in
    one); returns (library, ptxas register and spill lines)."""
    source = _KINDS[kind][0]
    files = variant_sources(name, kind)
    digest = hashlib.sha256("".join(files[f] for f in sorted(files))
                            .encode()).hexdigest()[:12]
    out_dir = _build.BUILD_DIR / "variants" / f"{name}-{digest}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for fname, text in files.items():
        (out_dir / fname).write_text(text)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
         "-o", str(out_dir / "variant.so"), str(out_dir / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out_dir / "variant.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    if kind == "multicell":
        lib.multicell_scan_f32.argtypes = [P] * 8 + [I] * 5 + [P]
    else:
        for entry, n_ptr in lstm_cuda._ENTRIES[source].items():
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
    """phase 3d's inputs; a masked entry's mask (an empty row, a full row,
    seeded lengths) last."""
    steps = T_MASKED if "masked" in name else T
    rng = np.random.RandomState(H + B + steps + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    bound = 1.0 / math.sqrt(H)
    dirs = []
    for _ in range(2 if name.startswith("bi") else 1):
        w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound,
                                                    (H, 4 * H)))
        dirs.append((t(rng.randn(steps, B, 4 * H)),
                     torch.from_numpy(w_q).cuda(), t(w_s),
                     t(np.tanh(rng.randn(B, H))), t(rng.randn(B, H) * 0.5)))
    if "masked" in name:
        lengths = rng.randint(1, steps, size=B)
        lengths[0], lengths[1] = 0, steps
        dirs.append(t(np.arange(steps)[:, None] < lengths[None, :]))
    return dirs


def _launcher(lib, name: str, dirs):
    """A function that launches `name` of `lib` on `dirs` (a masked
    entry's mask last) into fixed outputs and returns them (ys, then h_T,
    c_T, per direction)."""
    masked = "masked" in name
    mask = [dirs[-1]] if masked else []
    dirs = dirs[:-1] if masked else dirs
    steps, B, H4 = dirs[0][0].shape
    H = H4 // 4
    outs = ([torch.empty((steps, B, H), device="cuda") for _ in dirs]
            + [torch.empty((B, H), device="cuda")
               for _ in range(2 * len(dirs))])
    int8 = "int8" in name
    rows = lstm_cuda.scan_geometry(len(dirs), B, H, dirs[0][0].device,
                                   masked=masked, int8=int8).rows
    n_w = 3 if int8 else 2  # x_proj, w_hh (and w_scale) lead, by direction
    ins = ([x for d in dirs for x in d] if len(dirs) == 1 else
           [d[i] for i in range(n_w) for d in dirs]
           + [*dirs[0][n_w:], *dirs[1][n_w:]])
    ptrs = [t.data_ptr() for t in ins + mask + outs]

    def launch():
        err = getattr(lib, name)(*ptrs, steps, B, H, rows,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return outs
    return launch


def _multicell_inputs(B: int):
    """phase 3e's inputs: x_proj, then per cell w_hh, h0, c0."""
    rng = np.random.RandomState(B + 9)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    x = t(rng.randn(T, B, 4 * sum(_ROW_H)))
    ws = [t(rng.uniform(-1 / math.sqrt(H), 1 / math.sqrt(H), (H, 4 * H)))
          for H in _ROW_H]
    h0s = [t(np.tanh(rng.randn(B, H))) for H in _ROW_H]
    c0s = [t(rng.randn(B, H) * 0.5) for H in _ROW_H]
    return x, ws, h0s, c0s


def _multicell_launcher(inputs, h_buffers=None, lib=None):
    """A function that launches the multicell kernel (or the build `lib`
    of a variant) on `inputs` in the h layout `h_buffers` (None: the one
    the kernel's geometry picks) at the rows that geometry picks for that
    layout, into fixed outputs, and returns them; and that geometry."""
    x, ws, h0s, c0s = inputs
    B = x.shape[1]
    geo = multicell_cuda.multicell_geometry(B, _ROW_H, x.device, h_buffers)
    n = len(_ROW_H)
    outs = ([torch.empty((T, B, H), device="cuda") for H in _ROW_H]
            + [torch.empty((B, H), device="cuda") for H in 2 * _ROW_H])

    def arr(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    args = (x.data_ptr(), arr(ws), arr(h0s), arr(c0s), arr(outs[:n]),
            arr(outs[n:2 * n]), arr(outs[2 * n:]),
            (ctypes.c_int * n)(*_ROW_H), n, T, B, geo.rows, geo.h_buffers)
    lib = lib or multicell_cuda._lib()

    def launch():
        err = lib.multicell_scan_f32(*args,
                                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"multicell_scan_f32 launch failed: CUDA "
                               f"error {err}")
        return outs
    return launch, geo


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
    kinds = ap.add_mutually_exclusive_group()
    kinds.add_argument("--int8", action="store_true",
                       help="the int8 cluster scans' variants")
    kinds.add_argument("--multicell", action="store_true",
                       help="the multicell scan's variants")
    ap.add_argument("--variants", default=None,
                    help="comma-separated (default: every variant)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: no CUDA device; the kernels run on "
                         "the card")
    kind = ("multicell" if args.multicell else "int8" if args.int8
            else "float")
    source, table = _KINDS[kind]
    names = (args.variants or ",".join(table)).split(",")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        # the kernel itself, its entries declared
        base = pool.submit(multicell_cuda._lib if args.multicell
                           else lambda: lstm_cuda._lib(source))
        built = dict(zip(names, pool.map(
            lambda n: build_variant(n, kind), names)))
        libs = {"kernel": base.result(), **{n: b[0] for n, b in built.items()}}
    layouts = list(MULTICELL_LAYOUTS) if args.multicell else []
    lines = [{"ptxas_spills": {n: b[1] for n, b in built.items()},
              "variants": {n: table[n][0] for n in names},
              "layouts": {n: MULTICELL_LAYOUTS[n][1] for n in layouts}}]
    print(json.dumps(lines[-1]), flush=True)
    others = [*layouts, *names]
    order = ["kernel", *others, *reversed(others), "kernel"]
    shapes = ([("multicell_scan_f32", list(_ROW_H), B)
               for B in MULTICELL_BATCHES] if args.multicell
              else INT8_SHAPES if args.int8 else SHAPES)
    for name, H, B in shapes:
        where = {}
        if args.multicell:
            inputs = _multicell_inputs(B)
            runs = {}
            for n in ["kernel", *layouts]:
                runs[n], geo = _multicell_launcher(
                    inputs, MULTICELL_LAYOUTS[n][0] if n in layouts else None)
                where[n] = {"rows_per_group": geo.rows,
                            "h_buffers": geo.h_buffers,
                            "clusters": geo.clusters}
            for n in names:  # at the kernel's geometry
                runs[n], _ = _multicell_launcher(inputs, lib=libs[n])
            where = {"geometry": where}
        else:
            dirs = _inputs(name, H, B)
            runs = {n: _launcher(lib, name, dirs) for n, lib in libs.items()}
            n_dir = 2 if name.startswith("bi") else 1
            where = {"rows_per_cluster": lstm_cuda.scan_geometry(
                n_dir, B, H, torch.device("cuda", 0),
                masked="masked" in name, int8=args.int8).rows}
        want = [x.clone() for x in runs["kernel"]()]
        diff = {}
        for n in others:
            got = runs[n]()
            diff[n] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        times = {n: [] for n in runs}
        for n in order:
            times[n].append(_time_ms(runs[n]))
        lines.append({"name": name, "B": B, "H": H,
                      "T": T_MASKED if "masked" in name else T, **where,
                      "max_abs_diff_vs_kernel": diff,
                      "ms": {n: sum(v) / len(v) for n, v in times.items()},
                      "ms_turns": times})
        print(json.dumps(lines[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
