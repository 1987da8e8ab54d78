"""Device operations (kernels, copies, sets) per train step of the traced
window."""

from portbench import trace


def read(rec):
    return trace.per_call(rec, "train", len(rec["trace"]["device_ops"]))
