"""Kernel #8, the backward scan with its dW reduction: the least time of
the traced steps' training backwards (`roofline.train_bound_ms(...,
"bwd")`) over the device time of #8's kernels, in %."""

from portbench import roofline, trace


def read(rec):
    if rec["kind"] != "train":
        return None
    us = trace.op_us(rec["trace"], trace.is_train_bwd)
    calls = len(rec["trace"]["calls"])
    if us <= 0 or not calls:
        return None
    t = rec["traffic"]
    bound_ms = roofline.train_bound_ms(rec["cfg"], t["batch"], t["window"],
                                       "bwd")
    return 100.0 * bound_ms * calls / (us / 1e3)
