"""Device operations (kernels, copies, sets) per tick of the traced window."""

from portbench import trace


def read(rec):
    return trace.per_call(rec, "stream", len(rec["trace"]["device_ops"]))
