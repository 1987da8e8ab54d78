"""The whole streaming step's share of the configuration's peak: the
model's matmul FLOPs per frame (`roofline.model_flops_per_frame`) x the
window's frames (each streamed frame re-runs the whole window) x the
traced window's streamed frames over its seconds, in %."""

from portbench import trace


def read(rec):
    w = rec["cfg"]["window"]
    return trace.mfu(rec, "stream", w["past"] + w["future"])
