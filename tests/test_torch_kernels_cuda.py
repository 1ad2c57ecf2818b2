"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor gstex_tpu, so it also runs where only
the port is installed:

    python -m pytest --noconftest -o addopts='' tests/test_torch_kernels_cuda.py

The kernel and the plain version run the same float32 operations in the
same per-pixel order (the kernel is built without FMA contraction), so
they are held to 1e-4, the tolerance ``chip_smoke.py`` uses.
"""

import pytest
import torch

from gstex_torch.data.synthetic import orbit_camera, surface_scene
from gstex_torch.ops import rasterize_eval as reval
from gstex_torch.ops.binning import TileGrid, build_tile_bins_flat
from gstex_torch.ops.cull import make_pair_cull
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_torch.ops.sh import sh_to_rgb

H, W = 96, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def kernel_inputs(device, pad, tile, s_cap, n=2000):
    s = surface_scene(n, chart_pad=pad, seed=1, device=device)
    cam = orbit_camera(H, W, dist=3.0, azimuth=0.7, device=device)
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    grid = TileGrid(height=H, width=W, tile_h=tile, tile_w=tile)
    bins = build_tile_bins_flat(prep.centers, prep.extents, prep.depths,
                                prep.valid, grid, pair_cap=1 << 18,
                                s_cap=s_cap,
                                cull_fn=make_pair_cull(prep.geom, cam, grid))
    inputs = (assemble_records(prep.geom, cam.c2w[:3, 3], s["texture_hw"]),
              bins.gids, bins.starts, bins.counts,
              sh_to_rgb(s["texture"]).contiguous(), cam_info(cam))
    return inputs, grid, bins


@pytest.mark.cuda
@pytest.mark.parametrize("pad,tile,s_cap", [((8, 8), 32, 1024),
                                            ((4, 4), 16, 1024),
                                            ((8, 8), 32, 16)],
                         ids=["pad8_tile32", "pad4_tile16", "clamped_s_cap"])
def test_kernel_matches_plain(cuda, pad, tile, s_cap):
    inputs, grid, bins = kernel_inputs(cuda, pad, tile, s_cap)
    if s_cap == 16:
        assert bins.overflow > 0
    before = reval.rasterize_eval.launches
    out = reval.rasterize_eval(*inputs, grid, s_cap)
    torch.cuda.synchronize()
    assert reval.rasterize_eval.launches == before + 1
    ref, _ = reval.rasterize_eval_reference(*inputs, grid, s_cap)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert float(out[7].max()) > 0.3


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda):
    inputs, _, _ = kernel_inputs(cuda, (8, 8), 32, 1024, n=200)
    big_tiles = TileGrid(height=H, width=W, tile_h=64, tile_w=64)
    before = reval.rasterize_eval.launches
    with pytest.raises(ValueError, match="pixels"):
        reval.rasterize_eval(*inputs, big_tiles, 1024)
    assert reval.rasterize_eval.launches == before
