"""Device ns per streamed frame of what is no LSTM kernel, product or
copy: the r6d decode and IK, the fusion and the elementwise glue."""

from portbench import trace


def read(rec):
    return trace.ns_per_frame(rec, "stream", trace.is_other)
