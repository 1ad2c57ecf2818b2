"""The fused SSIM kernel's launch geometry (``ssim_fused.launch_geometry``),
checked on the CPU.

The kernel (``csrc/ssim_fused.cu``) runs one block per strip of
``tile_h x tile_w`` output pixels of one channel; each block adds the SSIM
map over its own window positions into one double of the partial buffer,
and the last block adds those. The loss is right only if the blocks' own
positions cover each of the (H - 10) x (W - 10) window positions exactly
once and the buffer has one slot per block: both are checked here for the
training loss's shapes and for shapes whose last strip is partial in each
direction, at the H100's one wave of blocks and at others. The kernel
itself runs only on the card (``test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from gstex_torch.ops import ssim_fused

# (H, W): the Blender loss, 800x600 both ways (the DTU loss is 600 rows of
# 800), and small shapes whose last strips are partial
SHAPES = [(800, 800), (800, 600), (600, 800), (120, 100), (64, 96),
          (120, 64)]
IDS = [f"{h}x{w}" for h, w in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_own_windows_cover_each_position_once(shape):
    h, w = shape
    for slots in (ssim_fused.H100_SLOTS, 1, 7, 100_000):
        geo = ssim_fused.launch_geometry(h, w, 3, slots=slots)
        gx, gy, gz = geo.grid
        assert geo.n_partial == gx * gy * gz and gz == 3
        # the blocks cover every pixel, and no block starts past the image
        assert (gx - 1) * geo.tile_w < w <= gx * geo.tile_w
        assert (gy - 1) * geo.tile_h < h <= gy * geo.tile_h
        hits = np.zeros((h - ssim_fused.R, w - ssim_fused.R), dtype=np.int64)
        for by in range(gy):
            for bx in range(gx):
                rows, cols = geo.own_windows(bx, by)
                hits[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert hits.min() == 1 and hits.max() == 1, slots


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_last_strips_are_partial_where_the_shape_says(shape):
    """The shapes above include strips cut short by the image's last rows
    or columns, which the kernel must mask."""
    h, w = shape
    geo = ssim_fused.launch_geometry(h, w, 3)
    gx, gy, _ = geo.grid
    rows, cols = geo.own_windows(gx - 1, gy - 1)
    assert rows.stop == h - ssim_fused.R and cols.stop == w - ssim_fused.R
    assert len(rows) <= geo.tile_h and len(cols) <= geo.tile_w


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("shape", [(800, 800), (600, 800)],
                         ids=["800x800", "600x800"])
def test_the_grid_fills_one_wave(shape, c):
    """Strips as tall as one wave of blocks allows: the grid fits the
    card's slots, and one row fewer a strip would not."""
    h, w = shape
    slots = ssim_fused.H100_SLOTS
    geo = ssim_fused.launch_geometry(h, w, c, slots=slots)
    assert geo.n_partial <= slots
    assert geo.tile_h >= ssim_fused.MIN_TILE_H
    shorter = ssim_fused.launch_geometry(h, w, c, slots=slots,
                                         tile_h=geo.tile_h - 1)
    assert shorter.n_partial > slots or geo.tile_h == ssim_fused.MIN_TILE_H


@pytest.mark.parametrize("kwargs", [dict(tile_h=0), dict(tile_w=1)])
def test_launch_geometry_refuses_what_the_kernel_does_not_take(kwargs):
    with pytest.raises(ValueError, match="SSIM launch"):
        ssim_fused.launch_geometry(800, 800, 3, **kwargs)


def test_wrapper_on_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((64, 96, 3), generator=gen)
    b = torch.clamp(a + 0.1 * torch.randn(a.shape, generator=gen), 0, 1)
    before = ssim_fused.fused_ssim_value_and_grad.launches
    value, grad = ssim_fused.fused_ssim_value_and_grad(a, b)
    ref_value, ref_grad = ssim_fused.fused_ssim_reference(a, b)
    assert ssim_fused.fused_ssim_value_and_grad.launches == before
    assert torch.equal(value, ref_value) and torch.equal(grad, ref_grad)
