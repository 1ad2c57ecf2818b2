"""The yardstick for rooflines and the step's share of peak: the H100's
published peaks, and the operations and bytes each kernel's work needs,
counted from what the reference finds a view needs
(``reference/gstex_ref.py:view_counts``), whatever implements it.

Operation constants (float32 operations; a division, an exp, a min/max,
a floor or a compare-and-select each one):

- a response: one surfel at one pixel (ray-plane hit, falloff, alpha);
- a forward blend: uv, the bilinear fetch and the eight sums;
- a backward blend: transmittance recovery, the 3x3 hat-weight fetch and
  its gradient, the chain rule to 20 record fields and the chart texels;
- SSIM: one pixel and channel (5 blurs and 3 adjoint blurs of 2 x 11
  taps, the map and its derivatives);
- Adam: one element (two moments, the root, the bias-corrected step).

A blend counted is a pixel-surfel pair of alpha >= 1/255 in front of the
pixel's stop; each needs its response. Bytes are each input and output
once: the records (32 floats) and active texels (3 floats) that the
blends read, their gradients written by the backward, and the image
planes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

RESPONSE_FLOPS = 34
BLEND_FLOPS = 75
BWD_FLOPS = 350
SSIM_FLOPS = 400
ADAM_FLOPS = 11
RECORD_BYTES = 32 * 4
TEXEL_BYTES = 3 * 4
FWD_PLANES = 15        # fourteen float maps and the int ncontrib
BWD_PLANES = 16        # twelve cotangents, three maps and ncontrib


def bound_s(bytes_, ops) -> float:
    """Least seconds the card could take: bytes at peak bandwidth or
    operations at peak float32 rate, whichever is longer."""
    return max(bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def forward(c: dict, pixels: int):
    ops = c["blends"] * (RESPONSE_FLOPS + BLEND_FLOPS)
    bytes_ = (c["surfels"] * RECORD_BYTES + c["texels"] * TEXEL_BYTES
              + FWD_PLANES * pixels * 4)
    return bytes_, ops


def backward(c: dict, pixels: int):
    ops = c["blends"] * (RESPONSE_FLOPS + BWD_FLOPS)
    bytes_ = (2 * c["surfels"] * RECORD_BYTES + 2 * c["texels"] * TEXEL_BYTES
              + BWD_PLANES * pixels * 4)
    return bytes_, ops


def ssim(pixels: int, channels: int = 3):
    n = pixels * channels
    return 3 * n * 4, n * SSIM_FLOPS


def adam(elements: int):
    return 7 * elements * 4, elements * ADAM_FLOPS


def adam_elements(params: dict, buffers: dict) -> int:
    """Elements Adam needs to update: every leaf the render reads, the
    charts' active texels only."""
    hw = buffers["texture_hw"].long()
    texels = int((hw[:, 0] * hw[:, 1]).sum()) * 3
    rest = sum(v.numel() for k, v in params.items()
               if k not in ("texture", "features_dc"))
    return texels + rest


def step_ops(c: dict, pixels: int, adam_elements: int) -> float:
    """Operations one training step needs."""
    return (forward(c, pixels)[1] + backward(c, pixels)[1]
            + ssim(pixels)[1] + adam(adam_elements)[1])


def roofline(ctx: dict, kernel: str, work_of) -> float | None:
    """A kernel's share of its roofline in percent: the mean least time of
    its work over the counted views, over its device time per launch in
    the trace; ``None`` where the trace has no launch of it."""
    total_s, launches = ctx["trace"]["kernels"].get(kernel, (0.0, 0))
    if not launches or not ctx["counts"]:
        return None
    need = [bound_s(*work_of(c, ctx["pixels"])) for c in ctx["counts"]]
    return 100.0 * (sum(need) / len(need)) / (total_s / launches)
