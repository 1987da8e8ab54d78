"""Time cells C1 to C9 (PERF.md section 4) of two checkouts in turns on one
card, so that a change is compared with its parent under the same clocks.

    python -m mobileposer_tpu_torch.bench_turns --other DIR [--out FILE]
        [--cells C1,C7]
    python -m mobileposer_tpu_torch.bench_turns --other DIR --kernels [LIST]

DIR is another checkout of this repository (for example the parent
commit unpacked with `git archive` into a git-ignored directory). The
turns run other, this, this, other; each turn is one process that imports
`mobileposer_tpu_torch.bench` from its own tree, builds that tree's
kernels and runs every cell once. Prints one JSON line per cell and turn,
then one line of medians per cell and tree with the change's relative
difference; with --out, writes the lines to FILE as well; --cells runs
only those cells (a noisy one again, for more turns). A cell whose
bench function a tree does not take (C7's `bf16` before the port ran
bf16, C9's `bf16_residuals` before it stored bf16 residuals) or refuses
with NotImplementedError (C8's int8 on bf16 params before the port ran
it) is skipped in that tree's turns; a cell that records its peak device
memory (C4, C9) prints it beside its rate. With --kernels
each turn runs kernel phases of its tree's `chip_smoke.py` instead, LIST
a comma-separated choice of `full` (phase 3, the full-length layer scans
at the streaming shapes; the default), `masked` (phase 3b, the masked
scans at the evaluation shapes), `train` (phase 3c, the training kernels
and the dW reduction), `int8` (phase 3d, the W8A8 scans at the
streaming and evaluation shapes), `multicell` (phase 3e, the multicell
scan at B = 256 and 8), `bf16` (phase 3f, the bf16-I/O entries of the
float scans), `int8_bf16` (phase 3g, the bf16-I/O entries of the W8A8
scans), `train_bf16res` (phase 3h, the bf16-residual entries of the
training kernels) and `train_bf16` (phase 3i, their entries for bf16
params; each skipped in a tree without it), and a cell is one
kernel at one shape: its time in ms, with the yardstick's (cuDNN, or
torch.matmul for dW; for an int8 kernel, which has none, the float
kernel's at the same shape, and for a bf16 int8 kernel also the float32
int8 entry's; for the multicell scan the per-module kernels' on the same
cells; for a bf16res entry also the f32 entry's) in the same turn. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# each cell: (name, bench function, keyword arguments); the rate each
# reports is its "value"
CELLS = [
    ("C1", "run", {"n_streams": 256, "n_frames": 100}),
    ("C2", "run", {"n_streams": 8, "n_frames": 100}),
    ("C3", "run_offline", {"batch": 64, "bucket": 512}),
    ("C4", "run_train", {"batch": 256, "window": 125}),
    ("C5", "run", {"n_streams": 256, "n_frames": 100, "mode": "scan",
                   "int8": True}),
    ("C6f", "run_forward", {"batch": 256, "window": 45, "backend": "fused"}),
    ("C6a", "run_forward", {"batch": 256, "window": 45, "backend": "auto"}),
    # C1 on bf16 params, state and frames
    ("C7", "run", {"n_streams": 256, "n_frames": 100, "bf16": True}),
    # C1's shape on bf16 params quantized to W8A8 (the JAX bench's
    # exact_int8 leg as it is written)
    ("C8", "run", {"n_streams": 256, "n_frames": 100, "mode": "scan",
                   "int8": True, "bf16": True}),
    # C4 with the training kernels' residuals stored in bf16
    ("C9", "run_train", {"batch": 256, "window": 125,
                         "bf16_residuals": True}),
]

# run inside the tree under test: its own package, TF32 off as in
# chip_smoke.py
_TURN = """
import inspect, json, sys
sys.path.insert(0, {tree!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mobileposer_tpu_torch import bench
for name, fn, kw in {cells!r}:
    if set(kw) - set(inspect.signature(getattr(bench, fn)).parameters):
        continue
    try:
        rec = getattr(bench, fn)(**kw)
    except NotImplementedError:
        continue
    print(json.dumps({{"cell": name, "value": rec["value"],
                      "unit": rec.get("unit"), "rate_min": rec.get("rate_min"),
                      "rate_max": rec.get("rate_max"),
                      "peak_memory_bytes": rec.get("peak_memory_bytes")}}),
          flush=True)
"""

# the same for the kernels (--kernels): phases 3 ('full'), 3b ('masked'),
# 3c ('train'), 3d ('int8'), 3e ('multicell'), 3f ('bf16'), 3g
# ('int8_bf16'), 3h ('train_bf16res') and 3i ('train_bf16') of the tree's
# chip_smoke.py
KERNEL_PHASES = ("full", "masked", "train", "int8", "multicell", "bf16",
                 "int8_bf16", "train_bf16res", "train_bf16")
_KERNEL_TURN = """
import json, sys
sys.path.insert(0, {tree!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from mobileposer_tpu_torch.ops import _build, lstm_cuda, multicell_cuda
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda
recs = []
for phase in {phases!r}:
    if phase == "train":
        train_cuda.build()
        log = _build.library_path("lstm_train.cu").with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        recs += chip_smoke.phase_train_kernels(torch, train_cuda, ptxas)
    elif phase == "multicell":
        lstm_cuda.build()
        multicell_cuda.build()
        recs += chip_smoke.phase_multicell(torch, multicell_cuda, lstm_cuda)
    elif phase == "bf16":
        if not hasattr(chip_smoke, "phase_bf16_kernels"):
            continue
        lstm_cuda.build()
        multicell_cuda.build()
        recs += chip_smoke.phase_bf16_kernels(torch, lstm_cuda,
                                              multicell_cuda)
    elif phase == "int8_bf16":
        if not hasattr(chip_smoke, "phase_int8_bf16_kernels"):
            continue
        lstm_cuda.build()
        recs += chip_smoke.phase_int8_bf16_kernels(torch, lstm_cuda)
    elif phase in ("train_bf16res", "train_bf16"):
        fn = getattr(chip_smoke, f"phase_{{phase}}_kernels", None)
        if fn is None:
            continue
        train_cuda.build()
        recs += fn(torch, train_cuda)
    else:
        lstm_cuda.build()
        fn = {{"full": chip_smoke.phase_kernels,
              "masked": chip_smoke.phase_masked_kernels,
              "int8": chip_smoke.phase_int8_kernels}}[phase]
        recs += fn(torch, lstm_cuda)
for rec in recs:
    cell = f"{{rec['name']}} T={{rec['T']}} B={{rec['B']}} H={{rec['H']}}"
    if "case" in rec:
        cell += " " + rec["case"]
    print(json.dumps({{"cell": cell, "value": rec["kernel_ms"], "unit": "ms",
                      "library_ms": rec["library_ms"],
                      "float_kernel_ms": rec.get("float_kernel_ms"),
                      "int8_f32_kernel_ms": rec.get("int8_f32_kernel_ms"),
                      "per_module_kernels_ms":
                          rec.get("per_module_kernels_ms"),
                      "f32_entry_ms": rec.get("f32_entry_ms"),
                      "bound_ms": rec["bound_ms"]}}), flush=True)
"""


def run_turn(tree: Path, kernels=(), cells=CELLS) -> dict:
    """One process in `tree` running `cells` (or, with `kernels`, every
    shape of those kernel phases); {cell: record}."""
    script = (_KERNEL_TURN.format(tree=str(tree), phases=tuple(kernels))
              if kernels else _TURN.format(tree=str(tree), cells=cells))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"bench_turns: {tree} failed:\n{proc.stderr}")
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith('{"cell"')]
    return {r["cell"]: r for r in recs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the checkout to compare with (e.g. the parent)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--kernels", nargs="?", const="full", default="",
                    help="time these kernel phases instead of the cells: "
                         "a comma-separated choice of "
                         + ", ".join(KERNEL_PHASES) + " (default full)")
    ap.add_argument("--cells", default="",
                    help="run only these cells, comma-separated (default "
                         "all: " + ",".join(c[0] for c in CELLS) + ")")
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    names = [c for c in args.cells.split(",") if c]
    if set(names) - {c[0] for c in CELLS}:
        ap.error(f"--cells takes {', '.join(c[0] for c in CELLS)}; got "
                 f"{args.cells}")
    chosen = [c for c in CELLS if not names or c[0] in names]
    if set(kernels) - set(KERNEL_PHASES):
        ap.error(f"--kernels takes {', '.join(KERNEL_PHASES)}; got "
                 f"{args.kernels}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_turns: no CUDA device; the cells run on the "
                         "card")
    trees = {"other": args.other.resolve(), "this": ROOT}
    lines = []
    values = {t: defaultdict(list) for t in trees}
    cells = {}   # every cell either tree ran, in order of first appearance
    for turn, tree in enumerate(("other", "this", "this", "other")):
        for cell, rec in run_turn(trees[tree], kernels, chosen).items():
            values[tree][cell].append(rec["value"])
            cells[cell] = None
            lines.append({"turn": turn, "tree": tree, **rec})
            print(json.dumps(lines[-1]), flush=True)
    for cell in cells:
        med = {t: statistics.median(values[t][cell]) if values[t][cell]
               else None for t in trees}
        lines.append({"cell": cell, "median_other": med["other"],
                      "median_this": med["this"],
                      "this_vs_other": (med["this"] / med["other"] - 1.0
                                        if None not in med.values()
                                        else None),
                      "values": {t: values[t][cell] for t in trees}})
        print(json.dumps(lines[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
