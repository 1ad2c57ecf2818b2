"""The dense-list training forward's share of its roofline (``csrc/rasterize_dense_fwd.cu``)."""

from port_bench import work


def read(ctx):
    return work.roofline(ctx, "rasterize_dense_fwd_kernel", work.forward)
