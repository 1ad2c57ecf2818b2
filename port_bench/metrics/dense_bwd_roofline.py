"""The dense-list training backward's share of its roofline (``csrc/rasterize_dense_bwd.cu``)."""

from port_bench import work


def read(ctx):
    return work.roofline(ctx, "rasterize_dense_bwd_kernel", work.backward)
