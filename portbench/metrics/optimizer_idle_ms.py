"""Ms per train step in which the host was inside torch's
`Optimizer.step#<Class>.step` ranges and the device ran nothing: the
median over the traced steps."""

from portbench import spans


def read(rec):
    return spans.idle_ms(rec, "train", spans.is_optimizer)
