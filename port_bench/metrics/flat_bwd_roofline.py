"""The flat training backward's share of its roofline (``csrc/rasterize_bwd.cu``)."""

from port_bench import work


def read(ctx):
    return work.roofline(ctx, "rasterize_bwd_kernel", work.backward)
