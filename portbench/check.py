"""The comparison that decides `correct`: what the timed path produced,
against the plain reference under `portbench/reference/`, each number
beside its limit (`limits/<cell>.json`).

Streaming: a sample of the streams, drawn from the seed, is compared at
every tick it was served, from its first: joints and contact logits as
the largest absolute gap to the reference's; the pose as the largest
gap to the reference's pose over the decode's magnification of an r6d
error at that joint (`reference.model.pose_gap`); and the root by one
fusion step: the reference's step, in float64, from the program's
previous root and feet, on the contact branch the program's own contact
logits chose (a near tie may go either way; the logits themselves are
compared).

Training: the first `checked_steps` steps, which the reference follows
from the same weights, batches and draws: each step's loss (relative
gap), the first gradient as the optimizer takes it (from its first
moment after one step) and the parameters' change over the steps, both
by the worst leaf: the gap of the two norms over the larger of the
reference's norm of that leaf and of the median leaf (`grad_median_gap`
is the median leaf's gap, for a cell whose worst leaf swings from seed
to seed). A leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of the change.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench import weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train


def verdict(readings: dict, limits: dict) -> bool:
    """Every number the cell's limits name read, finite and within its
    limit (a cell compares the readings its limits name)."""
    return set(limits) <= set(readings) and all(
        math.isfinite(readings[k]) and readings[k] <= limits[k]
        for k in limits)


def lines(readings: dict, limits: dict) -> list:
    return [f"check {k} {readings.get(k)!r} limit {limits[k]!r}"
            for k in limits]


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def stream(cfg: dict, flat: torch.Tensor, frames: torch.Tensor,
           prog: dict) -> dict:
    """Readings of a stream cell. frames [n_ticks, K, 60] float32 as the
    program received them (rounded to its dtype and widened); prog the
    program's outputs of the same K streams at the same ticks, float32:
    pose [n, K, 24, 3, 3], joints [n, K, 24, 3], root [n, K, 3],
    contact [n, K, 2]."""
    ref = ref_model.stream_outputs(cfg, weights.views(cfg, flat), frames)
    n, K = frames.shape[:2]
    feet = cfg["feet"]
    rest = ref_model.rest_pose_joints(cfg, frames.device)[feet]
    last_feet = torch.cat([rest.expand(1, K, 2, 3),
                           prog["joints"][:-1][:, :, feet]])
    # the step from the program's previous root, added in float64: the
    # program's float32 root can say no more than its own rounding
    root_prev = torch.cat([torch.zeros_like(prog["root"][:1]),
                           prog["root"][:-1]]).double()
    c = prog["contact"]
    root = ref_model.fusion_step(
        cfg, ref["joints"].reshape(n * K, 24, 3),
        ref["contact"].reshape(n * K, 2), ref["vel"].reshape(n * K, -1),
        last_feet.reshape(n * K, 2, 3), root_prev.reshape(n * K, 3),
        (c[..., 0] > c[..., 1]).reshape(n * K)).reshape(n, K, 3)
    pose = ref_model.pose_gap(cfg, ref["r6d"].reshape(n * K, -1),
                              prog["pose"].reshape(n * K, 24, 3, 3))
    return {"pose_gap": pose,
            "joints_gap": _max_abs(prog["joints"], ref["joints"]),
            "contact_gap": _max_abs(prog["contact"], ref["contact"]),
            "root_gap": _max_abs(prog["root"].double(), root)}


def _norms(tree: dict) -> dict:
    return {(m, k): float(v.float().norm()) for m, ls in tree.items()
            for k, v in ls.items()}


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap of the two norms over the larger of its reference
    norm and the median leaf's."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def worst_leaves(ref: dict, prog: dict) -> dict:
    """The leaf that sets `grad_gap` and `change_gap`, for the record."""
    out = {}
    for name in ("grad", "change"):
        if set(prog[name]) == set(ref[name]):
            g = _gaps(prog[name], ref[name], ref[name])
            k = max(g, key=g.get)
            out[name] = [".".join(k), g[k], ref[name][k]]
    return out


def train_reference(cfg: dict, flat0: torch.Tensor, batches: list,
                    gen: torch.Generator) -> dict:
    """The reference's readings of the checked steps: losses [step]
    {module: float}, first-gradient norms and change norms per leaf."""
    leaves0 = weights.views(cfg, flat0)
    hist, g1, p = ref_train.run_steps(cfg, leaves0, batches, gen)
    change = {m: {k: p[m][k].float() - leaves0[m][k].float() for k in p[m]}
              for m in p}
    return {"losses": hist, "grad": _norms(g1), "change": _norms(change)}


def train(ref: dict, prog: dict) -> dict:
    """Readings of a train cell from the reference's and the program's
    readings (each as `train_reference` returns them)."""
    loss_gap = max(abs(pl[m] - rl[m]) / abs(rl[m])
                   for pl, rl in zip(prog["losses"], ref["losses"])
                   for m in rl)
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    if set(prog["grad"]) != set(ref["grad"]):
        return {"loss_gap": loss_gap, "grad_gap": math.inf,
                "grad_median_gap": math.inf, "change_gap": math.inf}
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    grad = _gaps(prog["grad"], ref["grad"], ref["grad"]).values()
    return {"loss_gap": loss_gap, "grad_gap": max(grad),
            "grad_median_gap": statistics.median(grad),
            "change_gap": max(_gaps(prog["change"], ref["change"],
                                    moved).values())}
