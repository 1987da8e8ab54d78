"""Device ns per streamed frame of the operations launched inside the
port's `mp.fusion` span: one frame of the translation fusion."""

from portbench import spans


def read(rec):
    return spans.ns_per_frame(rec, "stream", spans.named("mp.fusion"))
