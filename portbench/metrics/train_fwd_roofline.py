"""Kernel #7: the least time of the traced steps' training forwards
(`roofline.train_bound_ms(..., "fwd")`) over the device time of #7, in %."""

from portbench import roofline, trace


def read(rec):
    if rec["kind"] != "train":
        return None
    us = trace.op_us(rec["trace"], trace.is_train_fwd)
    calls = len(rec["trace"]["calls"])
    if us <= 0 or not calls:
        return None
    t = rec["traffic"]
    bound_ms = roofline.train_bound_ms(rec["cfg"], t["batch"], t["window"],
                                       "fwd")
    return 100.0 * bound_ms * calls / (us / 1e3)
