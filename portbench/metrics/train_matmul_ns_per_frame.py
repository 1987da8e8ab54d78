"""Device ns of cuBLAS's products (linears, input projections, their
gradients) per training frame of the traced window."""

from portbench import trace


def read(rec):
    return trace.ns_per_frame(rec, "train", trace.is_matmul)
