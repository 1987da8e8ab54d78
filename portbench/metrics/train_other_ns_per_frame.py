"""Device ns per training frame of what is no LSTM kernel, product or
copy: the losses, the finite flags and the optimizers' updates."""

from portbench import trace


def read(rec):
    return trace.ns_per_frame(rec, "train", trace.is_other)
