"""Host ms per train step inside torch's `Optimizer.step#<Class>.step`
ranges, summed over the four modules' optimizers: the median over the
traced steps."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "train", spans.is_optimizer)
