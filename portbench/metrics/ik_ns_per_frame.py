"""Device ns per streamed frame of the operations launched inside the
port's `mp.decode_ik` span: the r6d decode and IK."""

from portbench import spans


def read(rec):
    return spans.ns_per_frame(rec, "stream", spans.named("mp.decode_ik"))
