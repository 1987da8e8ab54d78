"""Host ms per train step inside the port's `mp.train.backward` span
(the backward of the summed losses): the median over the traced steps."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "train", spans.named("mp.train.backward"))
