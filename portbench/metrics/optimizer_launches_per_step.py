"""Device operations per train step launched inside torch's
`Optimizer.step#<Class>.step` ranges (launches paired with device
operations, `spans.owners`)."""

from portbench import spans


def read(rec):
    return spans.launches_per_call(rec, "train", spans.is_optimizer)
