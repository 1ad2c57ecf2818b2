"""The fused SSIM kernel's share of its roofline (``csrc/ssim_fused.cu``)."""

from port_bench import work


def read(ctx):
    return work.roofline(ctx, "ssim_fused_kernel",
                         lambda c, pixels: work.ssim(pixels))
