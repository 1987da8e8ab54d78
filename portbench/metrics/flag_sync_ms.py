"""Host ms per train step inside the port's `mp.train.finite_flags` span:
the finite flags and their fetch, the step's one wait for the device; the
median over the traced steps."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "train", spans.named("mp.train.finite_flags"))
