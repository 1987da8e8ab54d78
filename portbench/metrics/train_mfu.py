"""The whole training step's share of the configuration's peak: the
model's matmul FLOPs per frame x 3 (forward and backward) x the traced
window's training frames over its seconds, in %."""

from portbench import trace


def read(rec):
    return trace.mfu(rec, "train", 3)
