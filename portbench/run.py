"""Run one cell of the benchmark of `mobileposer_tpu_torch` on one NVIDIA
card and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`--trace 0` prints the cell's end-to-end metrics; `--trace 1` profiles
the first calls of the window and prints its per-layer metrics, the
device's busy and window seconds and a breakdown. Every run checks what
the timed path produced against the plain reference and prints each
number compared beside its limit, last on standard error and under
`checks` in the result. Without a CUDA card the run exits with code 2
and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every compiler cache of the run at a fixed place inside the checkout
for _key, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_key] = str(ROOT / "portbench" / ".cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mobileposer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _profile(device):
    """A function that runs `body(span)` under `torch.profiler`, `span()`
    opening a call span, and returns the trace's record."""
    def run(body):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            body(lambda: record_function(trace.CALL_SPAN))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return trace.record(prof)
    return run


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool,
             device, manifest=None, traffic=None, t0: float = T0) -> dict:
    """One run of `workload` on `device`; returns the result object.
    `traffic` replaces the cell's traffic file (the tests' small sizes)."""
    import torch

    from portbench import check, manifest as mf, trace

    man = manifest or mf.Manifest()
    cell = man.cell(workload)
    cfg = man.config(cell["config"])
    tr = traffic or man.traffic(cell["traffic"])
    limits = man.limits(workload)
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])

    def memory_peak():
        return torch.cuda.max_memory_allocated(device) if cuda else 0

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    ctx = {"cfg": cfg, "traffic": tr, "device": device, "seed": seed,
           "seconds": seconds, "trace": trace_on, "t0": t0,
           "profile": _profile(device), "memory_peak": memory_peak,
           "free": free}
    got = man.runner(tr["kind"]).run(ctx)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded in the run's process: {bad}")
    readings = got["readings"]
    result = {"correct": check.verdict(readings, limits),
              "attempted": got["attempted"], "failed": got["failed"],
              "metrics": {},
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device) if cuda
                                  else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": got["memory_peak_bytes"]}}
    if trace_on:
        rec = got["trace"]
        win = trace.window_us(rec["trace"])
        result["device"]["busy_s"] = trace.busy_us(rec["trace"]) / 1e6
        result["device"]["window_s"] = (win[1] - win[0]) / 1e6 if win else 0.0
        for m in man.metrics("per_layer", workload):
            v = man.reader(m["name"]).read(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = trace.breakdown(rec["trace"])
    else:
        e2e = dict(got["end_to_end"], setup_s=got["setup_s"])
        for m in man.metrics("end_to_end", workload):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    result["diag"] = got["diag"]
    result["checks"] = {k: {"value": readings.get(k), "limit": v}
                        for k, v in limits.items()}
    result["check_lines"] = check.lines(readings, limits)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")

    import torch

    from portbench import manifest as mf

    man = mf.Manifest()
    chips = man.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", manifest=man)
    lines = result.pop("check_lines")
    checks = result.pop("checks")
    result["checks"] = checks            # the key that comes last
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
