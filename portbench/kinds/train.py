"""The `train` traffic: `train.trainer.make_multi_train_step`, the
concurrent four-module step, one step after another with the states
threaded, on batches cycled from a pool made at set-up.

Set-up builds the one step object with its four states and drives it
through its first `checked_steps` steps on distinct batches, keeping what
the check compares (each step's losses, the first gradients as the
optimizers took them, the parameters' change); further warm-up steps
follow, and that same object runs the window.
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import check, motion, weights


def _moment_norms(states, beta1) -> dict:
    """Norms of each leaf's first gradient as its optimizer took it:
    its first moment after one step over (1 - beta1)."""
    out = {}
    for m, st in states.items():
        for k, p in st.params.named_parameters():
            s = st.opt.state.get(p, {})
            mu = s.get("exp_avg", s.get("mu"))
            out[(m, k)] = (float("inf") if mu is None
                           else float((mu / (1 - beta1)).float().norm()))
    return out


def _change_norms(states, cfg, flat0) -> dict:
    v0 = weights.views(cfg, flat0)
    return {(m, k): float((p.detach().float() - v0[m][k].float()).norm())
            for m, st in states.items()
            for k, p in st.params.named_parameters()}


def run(ctx) -> dict:
    """One run of a train cell; returns its part of the result."""
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
    from mobileposer_tpu_torch.train.trainer import (MODULE_NAMES,
                                                     init_train_state,
                                                     make_multi_train_step)
    cfg, tr, dev, seed = ctx["cfg"], ctx["traffic"], ctx["device"], ctx["seed"]
    dtype = weights.DTYPES[cfg["dtype"]]
    tc = cfg["train"]
    for name, m in cfg["modules"].items():
        if MODULE_CONFIGS[name]._asdict() != m:
            raise ValueError(f"the program's {name} is not the "
                             f"configuration's: {MODULE_CONFIGS[name]}")
    if (list(MODULE_NAMES) != tc["draw_order"]
            or tc["residuals"] != "float32"):
        raise ValueError("the program's step is not the configuration's")
    t_start = time.perf_counter()
    flat0 = weights.make_flat(cfg, seed, dev)
    states = {n: init_train_state(n, torch.Generator(), tc["lr"], dev, dtype)
              for n in MODULE_NAMES}
    weights.load_into(cfg, flat0, {n: s.params for n, s in states.items()})
    step = make_multi_train_step(ParametricModel(weights.body_arrays(cfg)),
                                 backend="auto_train")
    t_program = time.perf_counter()
    pool = motion.train_pool(tr, seed, dev)
    gen = motion.generator(seed, 4, dev)

    prog = {"losses": []}
    for i in range(tr["checked_steps"]):
        states, losses = step(states, pool[i % len(pool)], gen)
        prog["losses"].append({n: float(v) for n, v in losses.items()})
        if i == 0:
            prog["grad"] = _moment_norms(states, tc["betas"][0])
    prog["change"] = _change_norms(states, cfg, flat0)
    i = tr["checked_steps"]
    for _ in range(tr["warmup_steps"]):
        states, _ = step(states, pool[i % len(pool)], gen)
        i += 1

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    setup_peak = ctx["memory_peak"]()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    issue_ms = []

    def steps(n=None, until=None, span=None):
        nonlocal i, states
        k = 0
        while (n is None or k < n) and (until is None
                                        or time.perf_counter() < until):
            with span() if span else contextlib.nullcontext():
                t1 = time.perf_counter()
                states, _ = step(states, pool[i % len(pool)], gen)
                issue_ms.append(1e3 * (time.perf_counter() - t1))
            i += 1
            k += 1
        return k

    t_setup = time.perf_counter()
    trace_rec, n_traced = None, 0
    if ctx["trace"]:
        trace_rec = ctx["profile"](
            lambda span: steps(n=tr["trace_calls"], span=span))
        n_traced = tr["trace_calls"]
    n_steps = n_traced + steps(until=t_setup + ctx["seconds"])
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    window_peak = ctx["memory_peak"]()
    del states, step
    ctx["free"]()

    t_check = time.perf_counter()
    ref = check.train_reference(cfg, flat0, pool[:tr["checked_steps"]],
                                motion.generator(seed, 4, dev))
    frames = tr["batch"] * tr["window"]
    out = {
        "setup_s": t_setup - ctx["t0"],
        "attempted": n_steps, "failed": 0,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "end_to_end": {"train_frames_per_s":
                       frames * n_steps / (t_end - t_setup),
                       "peak_mem_gb": window_peak / 1e9},
        "readings": check.train(ref, prog),
        "diag": {"to_start": t_start - ctx["t0"],
                    "weights_program": t_program - t_start,
                    "inputs_warmup": t_setup - t_program,
                    "window": t_end - t_setup,
                    "check": time.perf_counter() - t_check,
                    "worst_leaves": check.worst_leaves(ref, prog)},
    }
    if trace_rec is not None:
        out["trace"] = {"kind": "train", "cfg": cfg, "traffic": tr,
                        "frames_per_call": frames, "trace": trace_rec,
                        "issue_ms": issue_ms[:n_traced]}
    return out
