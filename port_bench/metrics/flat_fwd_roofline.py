"""The flat training forward's share of its roofline (``csrc/rasterize_fwd.cu``)."""

from port_bench import work


def read(ctx):
    return work.roofline(ctx, "rasterize_fwd_kernel", work.forward)
