"""Device ns of cuBLAS's products (linears, input projections) per
streamed frame of the traced window."""

from portbench import trace


def read(rec):
    return trace.ns_per_frame(rec, "stream", trace.is_matmul)
