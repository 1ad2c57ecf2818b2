"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor gstex_tpu, so it also runs where only
the port is installed:

    python -m pytest --noconftest -o addopts='' tests/test_torch_kernels_cuda.py

The eval and forward kernels and their plain versions run the same
float32 operations in the same per-pixel order (the kernels are built
without FMA contraction): the flat eval kernel is held to its plain
version bit for bit, the others to 1e-4, the tolerance ``chip_smoke.py``
uses. The backward kernel sums over pixels and tiles in
another order (shuffles and atomics), so it is held to 1e-4 of each
field group's largest plain value, and the texture gradient to a sign
flip fraction of 1e-5. The SSIM kernel and its plain version both run in
float32 and carry float32 roundoff of ~1.2e-5 of the largest gradient at
800x800 (the variances are differences of near-equal blurs), so each is
held to a float64 evaluation: 1e-6 on the value, 3e-5 of the largest
gradient; and to each other: 1e-6 on the value, twice 3e-5 on the
gradient.

The chart pads include a non-square one, whose active charts are drawn
up to the full pad in each direction, and a scene-sized (40, 56), at
which the first eval kernel staged one splat a chunk. The three flat
kernels stage records only (no shared memory sized by the pad), so they
also run at (88, 88) and (128, 128), past what their first port staged,
and the training kernels on an 88x120 image whose last row and column of
tiles are partial.

The dense-list kernels run the same cases plus the pads that the dispatch
sends to them, (88, 88) and (128, 128). Their eval and forward kernels
follow their plain version operation for operation, bit for bit under
every tile order (the eval kernel's eight planes; the forward's maps and
ncontrib). Their backward's
plain version pulls the per-splat math back with autograd where the
kernel writes the chain rule out, so the two differ by rounding: the same
1e-4 of each field group's largest value and 1e-5 sign flips. On the pads
both tiers take, the dense kernels are also held to the flat ones.

The pair-space v3, v2 and v1 kernels run on per-(tile, slot) copies of
the dense lists' records and charts, at 32x32 tiles and pads up to their
limits (40 rows for v3, 42 for v2 and v1), one of them past what the v1
backward stages in shared memory. Each is held to its plain version by
the gates above (the v2 and v1 forwards bit for bit; v3's forward sums its chunks'
slots in another order than its plain version, so its maps to 1e-4, and
t_final and ncontrib exactly), v3 and v2, summed per gaussian, to the
dense kernels on the same pairs, and v1 to v2, which it equals but for its
rounding of the distortion depth. The six pair-space kernels take their
tiles in an order, and each is held to its
plain version under three (the forwards also bit for bit to their own
output under each): v3 also where its pixels apply slots in three or more
of its chunks of 16 and where tiles end inside a chunk, and v1 at the
nerfstudio path's pad and image.
"""

import pytest
import torch

from gstex_torch.data.synthetic import orbit_camera, surface_scene
from gstex_torch.ops import rasterize_bwd as rbwd
from gstex_torch.ops import rasterize_dense as rdense
from gstex_torch.ops import rasterize_eval as reval
from gstex_torch.ops import rasterize_fwd as rfwd
from gstex_torch.ops import rasterize_v1 as rv1
from gstex_torch.ops import rasterize_v2 as rv2
from gstex_torch.ops import rasterize_v3 as rv3
from gstex_torch.ops import ssim_fused
from gstex_torch.ops.binning import (TileGrid, build_tile_bins,
                                     build_tile_bins_flat)
from gstex_torch.ops.cull import make_pair_cull
from gstex_torch.ops.pair_inputs import bwd_launch_smem, pair_inputs
from gstex_torch.ops.rasterize_bwd import tile_planes
from gstex_torch.ops.rasterize_api import use_flat_path
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_torch.ops.sh import sh_to_rgb

H, W = 96, 128
# an image whose last row and column of 32x32 tiles are partial
PARTIAL = (88, 120)
CASES = [((8, 8), 32, 1024), ((4, 4), 16, 1024), ((8, 8), 32, 16),
         ((6, 10), 16, 1024), ((40, 56), 32, 1024)]
CASE_IDS = ["pad8_tile32", "pad4_tile16", "clamped_s_cap", "pad6x10_tile16",
            "pad40x56"]
SSIM_LOSS_TOL = 1e-6
SSIM_GRAD_TOL = 3e-5   # of the float64 gradient's max
# record fields by what they carry, for the backward's per-group gate
FIELD_GROUPS = {"normal": [0, 1, 2], "plane": [3], "axis1": [4, 5, 6, 7],
                "axis2": [8, 9, 10, 11], "uv": [15, 19], "opacity": [20],
                "rgb": [21, 22, 23], "xy": [24, 25]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert not torch.backends.cudnn.allow_tf32
    return torch.device("cuda")


def kernel_inputs(device, pad, tile, s_cap, n=2000, height=H, width=W,
                  dense=False):
    s = surface_scene(n, chart_pad=pad, seed=1, device=device)
    # active chart dims up to the pad in each direction
    gen = torch.Generator(device=device).manual_seed(4)
    s["texture_hw"] = torch.stack([
        torch.randint(1, pad[0] + 1, (n,), generator=gen, device=device),
        torch.randint(1, pad[1] + 1, (n,), generator=gen, device=device)],
        -1).to(torch.int32)
    cam = orbit_camera(height, width, dist=3.0, azimuth=0.7, device=device)
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    grid = TileGrid(height=height, width=width, tile_h=tile, tile_w=tile)
    binning = build_tile_bins if dense else build_tile_bins_flat
    bins = binning(prep.centers, prep.extents, prep.depths, prep.valid, grid,
                   1 << 18, s_cap,
                   cull_fn=make_pair_cull(prep.geom, cam, grid))
    lists = ((bins.ids, bins.counts) if dense
             else (bins.gids, bins.starts, bins.counts))
    inputs = (assemble_records(prep.geom, cam.c2w[:3, 3], s["texture_hw"]),
              *lists, sh_to_rgb(s["texture"]).contiguous(), cam_info(cam))
    return inputs, grid, bins


def cotangents(device, height=H, width=W, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((rfwd.NG, height, width), generator=gen, device=device)
    g[6] *= 0.1    # depth
    g[8:] *= 0.1   # normal, reg
    return g.contiguous()


def backward_errors(d_rec, d_ch, ref_rec, ref_ch):
    """Max abs error per field group over the plain version's max abs, and
    the fraction of texture gradient elements whose sign flips."""
    errs = {}
    for name, fields in FIELD_GROUPS.items():
        scale = float(ref_rec[:, fields].abs().max()) + 1e-12
        errs[name] = float((d_rec[:, fields] - ref_rec[:, fields]).abs()
                           .max()) / scale
    scale = float(ref_ch.abs().max()) + 1e-12
    errs["texture"] = float((d_ch - ref_ch).abs().max()) / scale
    big = ref_ch.abs() > 1e-6 * scale
    flips = (torch.sign(d_ch) != torch.sign(ref_ch)) & big
    errs["texture_flip_frac"] = float(flips.sum()) / max(int(big.sum()), 1)
    return errs


# the flat kernels also at pads past their first port's shared memory;
# few surfels where the charts are large (300 x (128, 128) is 59 MB)
FLAT_CASES = CASES + [((88, 88), 32, 1024), ((128, 128), 32, 1024)]
FLAT_IDS = CASE_IDS + ["pad88x88_past_staging", "pad128x128_max"]


def flat_inputs(cuda, pad, tile, s_cap, hw=(H, W), dense=False):
    n = 300 if pad[0] >= 88 else 2000
    return kernel_inputs(cuda, pad, tile, s_cap, n=n, height=hw[0],
                         width=hw[1], dense=dense)


@pytest.mark.cuda
@pytest.mark.parametrize("pad,tile,s_cap", FLAT_CASES, ids=FLAT_IDS)
def test_kernel_matches_plain(cuda, pad, tile, s_cap):
    """The flat eval kernel writes its plain version's maps bit for bit."""
    inputs, grid, bins = flat_inputs(cuda, pad, tile, s_cap)
    if s_cap == 16:
        assert bins.overflow > 0
    before = reval.rasterize_eval.launches
    out = reval.rasterize_eval(*inputs, grid, s_cap)
    torch.cuda.synchronize()
    assert reval.rasterize_eval.launches == before + 1
    ref, _ = reval.rasterize_eval_reference(*inputs, grid, s_cap)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert float(out[7].max()) > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad,tile,s_cap", FLAT_CASES, ids=FLAT_IDS)
def test_forward_kernel_matches_plain(cuda, pad, tile, s_cap, lean):
    inputs, grid, _ = flat_inputs(cuda, pad, tile, s_cap)
    before = rfwd.rasterize_fwd.launches
    maps, ncon = rfwd.rasterize_fwd(*inputs, grid, s_cap, lean=lean)
    torch.cuda.synchronize()
    assert rfwd.rasterize_fwd.launches == before + 1
    ref, ref_ncon = rfwd.rasterize_fwd_reference(*inputs, grid, s_cap,
                                                 lean=lean)
    torch.testing.assert_close(maps, ref, atol=1e-4, rtol=0)
    assert torch.equal(ncon, ref_ncon)
    assert float(maps[7].max()) > 0.3
    if lean:
        assert float(maps[8:12].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad,tile,s_cap", FLAT_CASES, ids=FLAT_IDS)
def test_backward_kernel_matches_plain(cuda, pad, tile, s_cap, lean):
    inputs, grid, _ = flat_inputs(cuda, pad, tile, s_cap)
    # the launch's shared memory is the tile's 14 planes and a fixed part
    assert (rbwd.launch_smem(tile, tile)
            == 14 * tile * tile * 4 + rbwd.launch_smem(0, 0))
    maps, ncon = rfwd.rasterize_fwd(*inputs, grid, s_cap, lean=lean)
    g = cotangents(cuda)
    before = rbwd.rasterize_bwd.launches
    d_rec, d_ch = rbwd.rasterize_bwd(*inputs, maps, ncon, g, grid, s_cap,
                                     lean=lean)
    torch.cuda.synchronize()
    assert rbwd.rasterize_bwd.launches == before + 1
    ref_rec, ref_ch = rbwd.rasterize_bwd_reference(*inputs, maps, ncon, g,
                                                   grid, s_cap, lean=lean)
    errs = backward_errors(d_rec, d_ch, ref_rec, ref_ch)
    flip = errs.pop("texture_flip_frac")
    assert max(errs.values()) <= 1e-4, errs
    assert flip <= 1e-5
    assert float(ref_rec.abs().max()) > 0
    assert float(d_rec[:, [12, 13, 14, 16, 17, 18]].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad", [(8, 8), (40, 80), (128, 128)],
                         ids=["pad8", "pad40x80", "pad128x128"])
def test_flat_training_kernels_on_partial_tiles(cuda, pad, lean):
    """An 88x120 image: the last row and column of 32x32 tiles are
    partial. The forward writes every pixel of the image bit for bit as
    its plain version; the backward holds the gates above."""
    inputs, grid, _ = flat_inputs(cuda, pad, 32, 1024, hw=PARTIAL)
    assert grid.height % 32 and grid.width % 32
    maps, ncon = rfwd.rasterize_fwd(*inputs, grid, 1024, lean=lean)
    ref, ref_ncon = rfwd.rasterize_fwd_reference(*inputs, grid, 1024,
                                                 lean=lean)
    assert torch.equal(maps, ref) and torch.equal(ncon, ref_ncon)
    assert float(maps[7].max()) > 0.3
    g = cotangents(cuda, *PARTIAL)
    d_rec, d_ch = rbwd.rasterize_bwd(*inputs, maps, ncon, g, grid, 1024,
                                     lean=lean)
    ref_rec, ref_ch = rbwd.rasterize_bwd_reference(*inputs, maps, ncon, g,
                                                   grid, 1024, lean=lean)
    errs = backward_errors(d_rec, d_ch, ref_rec, ref_ch)
    flip = errs.pop("texture_flip_frac")
    assert max(errs.values()) <= 1e-4, errs
    assert flip <= 1e-5
    assert float(ref_ch.abs().max()) > 0


@pytest.mark.cuda
def test_flat_training_kernels_shared_memory_is_pad_free(cuda):
    """No flat kernel keeps anything sized by the chart pad in shared
    memory: the eval and forward kernels have only their static arrays
    (the record ring, ids and camera), the backward those and the tile's
    14 planes. So at 32x32 tiles two backward blocks fit an SM's 228 KB."""
    fwd = rfwd.launch_smem()
    ev = reval.launch_smem()
    fixed = rbwd.launch_smem(0, 0)
    assert 0 < fwd <= 24 * 1024 and 0 < fixed <= 32 * 1024
    assert 0 < ev <= fwd
    assert 2 * (rbwd.launch_smem(32, 32) + 1024) <= 228 * 1024
    # and the kernels take pads far past any staging: (192, 256) charts
    inputs, grid, _ = kernel_inputs(cuda, (192, 256), 32, 1024, n=100)
    out = reval.rasterize_eval(*inputs, grid, 1024)
    ref, _ = reval.rasterize_eval_reference(*inputs, grid, 1024)
    assert torch.equal(out, ref) and float(out[7].max()) > 0.3
    maps, ncon = rfwd.rasterize_fwd(*inputs, grid, 1024, lean=True)
    ref, ref_ncon = rfwd.rasterize_fwd_reference(*inputs, grid, 1024,
                                                 lean=True)
    assert torch.equal(maps, ref) and torch.equal(ncon, ref_ncon)
    d_rec, d_ch = rbwd.rasterize_bwd(*inputs, maps, ncon, cotangents(cuda),
                                     grid, 1024, lean=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d_ch).all()) and float(d_ch.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "longest_first", "reversed"])
def test_flat_tile_schedules_agree(cuda, schedule):
    """The order in which blocks take tiles changes nothing a tile
    computes: the forward is bit for bit the same, the backward within the
    order of its atomics."""
    inputs, grid, _ = kernel_inputs(cuda, (16, 24), 16, 1024)
    counts = inputs[3]
    g = cotangents(cuda)
    maps, ncon = rfwd.rasterize_fwd(*inputs, grid, 1024)
    d_rec, d_ch = rbwd.rasterize_bwd(*inputs, maps, ncon, g, grid, 1024)
    order = {"block": torch.arange(grid.num_tiles, dtype=torch.int32,
                                   device=cuda),
             "longest_first": rfwd.tile_order(counts, 1024),
             "reversed": rfwd.tile_order(counts, 1024).flip(0)}[schedule]
    maps2, ncon2 = rfwd.rasterize_fwd(*inputs, grid, 1024, order=order)
    assert torch.equal(maps, maps2) and torch.equal(ncon, ncon2)
    assert torch.equal(reval.rasterize_eval(*inputs, grid, 1024, order=order),
                       maps[:8])
    d_rec2, d_ch2 = rbwd.rasterize_bwd(*inputs, maps, ncon, g, grid, 1024,
                                       order=order)
    errs = backward_errors(d_rec2, d_ch2, d_rec, d_ch)
    assert errs.pop("texture_flip_frac") <= 1e-5
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 96, 3), (120, 64, 3), (800, 800, 3),
                                   (800, 600, 3), (600, 800, 3),
                                   (120, 100, 3)])
def test_ssim_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.rand(shape, generator=gen, device=cuda)
    b = torch.clamp(a + 0.1 * torch.randn(shape, generator=gen, device=cuda),
                    0, 1)
    before = ssim_fused.fused_ssim_value_and_grad.launches
    value, grad = ssim_fused.fused_ssim_value_and_grad(a, b)
    torch.cuda.synchronize()
    assert ssim_fused.fused_ssim_value_and_grad.launches == before + 1
    assert grad.dtype == torch.float32
    plain_value, plain_grad = ssim_fused.fused_ssim_reference(a, b)
    exact_value, exact_grad = ssim_fused.fused_ssim_reference(a.double(),
                                                              b.double())
    scale = float(exact_grad.abs().max())

    def errors(v, g, ref_v, ref_g):
        return (abs(float(v) - float(ref_v)),
                float((g.double() - ref_g.double()).abs().max()) / scale)

    for v, g in ((value, grad), (plain_value, plain_grad)):
        loss_err, grad_err = errors(v, g, exact_value, exact_grad)
        assert loss_err <= SSIM_LOSS_TOL and grad_err <= SSIM_GRAD_TOL
    loss_err, grad_err = errors(value, grad, plain_value, plain_grad)
    assert loss_err <= SSIM_LOSS_TOL and grad_err <= 2 * SSIM_GRAD_TOL


@pytest.mark.cuda
def test_ssim_kernel_is_deterministic(cuda):
    """The last block adds the blocks' sums in a fixed order, and resets
    its ticket: two launches give the same loss and gradient to the bit,
    on two shapes in turn."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    runs = []
    for shape in ((800, 600, 3), (120, 100, 3), (800, 600, 3)):
        a = torch.rand(shape, generator=gen, device=cuda)
        b = torch.rand(shape, generator=gen, device=cuda)
        runs.append((a, b, ssim_fused.fused_ssim_value_and_grad(a, b)))
    a, b, (v0, g0) = runs[0]
    v1, g1 = ssim_fused.fused_ssim_value_and_grad(a, b)
    torch.cuda.synchronize()
    assert torch.equal(v0, v1) and torch.equal(g0, g1)
    ref_v, _ = ssim_fused.fused_ssim_reference(a.double(), b.double())
    assert abs(float(v0) - float(ref_v)) <= SSIM_LOSS_TOL
    assert abs(float(runs[2][2][0]) - float(v0)) > 0  # other inputs


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda):
    inputs, _, _ = kernel_inputs(cuda, (8, 8), 32, 1024, n=200)
    big_tiles = TileGrid(height=H, width=W, tile_h=64, tile_w=64)
    before = (reval.rasterize_eval.launches, rfwd.rasterize_fwd.launches)
    with pytest.raises(ValueError, match="pixels"):
        reval.rasterize_eval(*inputs, big_tiles, 1024)
    with pytest.raises(ValueError, match="pixels"):
        rfwd.rasterize_fwd(*inputs, big_tiles, 1024)
    assert (reval.rasterize_eval.launches,
            rfwd.rasterize_fwd.launches) == before


DENSE_CASES = CASES + [((88, 88), 32, 1024), ((128, 128), 32, 1024)]
DENSE_IDS = CASE_IDS + ["pad88x88_above_flat", "pad128x128_max"]


def dense_inputs(cuda, pad, tile, s_cap):
    # few surfels where the charts are large: 300 x (128, 128) is 59 MB
    n = 300 if pad[0] >= 88 else 2000
    return kernel_inputs(cuda, pad, tile, s_cap, n=n, dense=True)


@pytest.mark.cuda
@pytest.mark.parametrize("pad,tile,s_cap", DENSE_CASES, ids=DENSE_IDS)
def test_dense_eval_kernel_matches_plain(cuda, pad, tile, s_cap):
    inputs, grid, bins = dense_inputs(cuda, pad, tile, s_cap)
    if s_cap == 16:
        assert bins.overflow > 0
    before = rdense.rasterize_dense_eval.launches
    out = rdense.rasterize_dense_eval(*inputs, grid)
    torch.cuda.synchronize()
    assert rdense.rasterize_dense_eval.launches == before + 1
    ref = rdense.rasterize_dense_eval_reference(*inputs, grid)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert float(out[7].max()) > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad,tile,s_cap", DENSE_CASES, ids=DENSE_IDS)
def test_dense_forward_kernel_matches_plain(cuda, pad, tile, s_cap, lean):
    inputs, grid, _ = dense_inputs(cuda, pad, tile, s_cap)
    before = rdense.rasterize_dense_fwd.launches
    maps, ncon = rdense.rasterize_dense_fwd(*inputs, grid, lean=lean)
    torch.cuda.synchronize()
    assert rdense.rasterize_dense_fwd.launches == before + 1
    ref, ref_ncon = rdense.plain.forward_scan(*inputs, grid, lean=lean)
    assert torch.equal(maps, ref)
    assert torch.equal(ncon, ref_ncon)
    assert float(maps[7].max()) > 0.3
    if lean:
        assert float(maps[8:12].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad,tile,s_cap", DENSE_CASES, ids=DENSE_IDS)
def test_dense_backward_kernel_matches_plain(cuda, pad, tile, s_cap, lean):
    inputs, grid, _ = dense_inputs(cuda, pad, tile, s_cap)
    if pad[0] >= 88:
        assert not use_flat_path("pallas", pad, tile * tile)
    maps, ncon = rdense.rasterize_dense_fwd(*inputs, grid, lean=lean)
    g = cotangents(cuda)
    before = rdense.rasterize_dense_bwd.launches
    d_rec, d_ch = rdense.rasterize_dense_bwd(*inputs, maps, ncon, g, grid,
                                             lean=lean)
    torch.cuda.synchronize()
    assert rdense.rasterize_dense_bwd.launches == before + 1
    ref_rec, ref_ch = rdense.plain.backward_walk(*inputs, maps, ncon, g,
                                                 grid, lean=lean)
    errs = backward_errors(d_rec, d_ch, ref_rec, ref_ch)
    flip = errs.pop("texture_flip_frac")
    assert max(errs.values()) <= 1e-4, errs
    assert flip <= 1e-5
    assert float(ref_rec.abs().max()) > 0 and float(ref_ch.abs().max()) > 0
    assert float(d_rec[:, [12, 13, 14, 16, 17, 18]].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad,tile,s_cap", FLAT_CASES, ids=FLAT_IDS)
def test_dense_kernels_match_flat_kernels(cuda, pad, tile, s_cap, lean):
    """The two tiers compute one function: same maps (same operations in
    the same per-pixel order) and same gradients (sums in another order)."""
    flat, grid, _ = flat_inputs(cuda, pad, tile, s_cap)
    dense, _, _ = flat_inputs(cuda, pad, tile, s_cap, dense=True)
    torch.testing.assert_close(rdense.rasterize_dense_eval(*dense, grid),
                               reval.rasterize_eval(*flat, grid, s_cap),
                               atol=1e-4, rtol=0)
    maps, ncon = rdense.rasterize_dense_fwd(*dense, grid, lean=lean)
    fmaps, fncon = rfwd.rasterize_fwd(*flat, grid, s_cap, lean=lean)
    torch.testing.assert_close(maps, fmaps, atol=1e-4, rtol=0)
    # a pixel that never breaks reads s_max on the dense tier, s_cap on the
    # flat one: the same number here
    assert torch.equal(ncon, fncon)
    g = cotangents(cuda)
    d_rec, d_ch = rdense.rasterize_dense_bwd(*dense, maps, ncon, g, grid,
                                             lean=lean)
    f_rec, f_ch = rbwd.rasterize_bwd(*flat, fmaps, fncon, g, grid, s_cap,
                                     lean=lean)
    errs = backward_errors(d_rec, d_ch, f_rec, f_ch)
    flip = errs.pop("texture_flip_frac")
    assert max(errs.values()) <= 1e-4, errs
    assert flip <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "longest_first", "reversed"])
def test_dense_tile_schedules_agree(cuda, schedule):
    """The order in which the dense backward's blocks take tiles changes
    nothing a tile computes: the gradients agree within the order of the
    atomics. The dense lists are clamped at s_max = 128 (two chunks of the
    record ring) here, so that the capped counts, not the raw ones, decide
    the order."""
    inputs, grid, bins = kernel_inputs(cuda, (16, 24), 16, 128, dense=True)
    assert bins.overflow > 0
    counts, s_max = inputs[2], inputs[1].shape[1]
    g = cotangents(cuda)
    maps, ncon = rdense.rasterize_dense_fwd(*inputs, grid)
    d_rec, d_ch = rdense.rasterize_dense_bwd(*inputs, maps, ncon, g, grid)
    order = {"block": torch.arange(grid.num_tiles, dtype=torch.int32,
                                   device=cuda),
             "longest_first": rfwd.tile_order(counts, s_max),
             "reversed": rfwd.tile_order(counts, s_max).flip(0)}[schedule]
    d_rec2, d_ch2 = rdense.rasterize_dense_bwd(*inputs, maps, ncon, g, grid,
                                               order=order)
    errs = backward_errors(d_rec2, d_ch2, d_rec, d_ch)
    assert errs.pop("texture_flip_frac") <= 1e-5
    assert max(errs.values()) <= 1e-5, errs
    assert float(d_rec.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("schedule", ["block", "longest_first", "reversed"])
def test_dense_forward_tile_orders_bit_equal(cuda, schedule, lean):
    """The order in which the dense forward's blocks take tiles changes no
    pixel's operations: maps and ncontrib are bit-equal to the plain
    version under every order, with one launch each. The lists are clamped
    at s_max = 128 (two chunks of the record ring)."""
    inputs, grid, bins = kernel_inputs(cuda, (16, 24), 16, 128, dense=True)
    assert bins.overflow > 0
    counts, s_max = inputs[2], inputs[1].shape[1]
    order = {"block": torch.arange(grid.num_tiles, dtype=torch.int32,
                                   device=cuda),
             "longest_first": rfwd.tile_order(counts, s_max),
             "reversed": rfwd.tile_order(counts, s_max).flip(0)
             .contiguous()}[schedule]
    before = rdense.rasterize_dense_fwd.launches
    maps, ncon = rdense.rasterize_dense_fwd(*inputs, grid, lean=lean,
                                            order=order)
    torch.cuda.synchronize()
    assert rdense.rasterize_dense_fwd.launches == before + 1
    ref, ref_ncon = rdense.plain.forward_scan(*inputs, grid, lean=lean)
    assert torch.equal(maps, ref) and torch.equal(ncon, ref_ncon)
    assert float(maps[7].max()) > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "longest_first", "reversed"])
@pytest.mark.parametrize("pad", [(8, 8), (16, 24), (64, 128), (88, 88)],
                         ids=["pad8", "pad16x24", "pad64x128", "pad88x88"])
def test_dense_eval_tile_orders_bit_equal(cuda, pad, schedule):
    """The order in which the dense eval kernel's blocks take tiles changes
    no pixel's operations: its eight planes are bit-equal to the plain
    version under every order, at the pads the main path serves. The
    lists are clamped at s_max = 128 (two chunks of the record ring)."""
    inputs, grid, _ = kernel_inputs(cuda, pad, 16, 128, dense=True,
                                    n=300 if pad[0] >= 64 else 2000)
    counts, s_max = inputs[2], inputs[1].shape[1]
    order = {"block": torch.arange(grid.num_tiles, dtype=torch.int32,
                                   device=cuda),
             "longest_first": rfwd.tile_order(counts, s_max),
             "reversed": rfwd.tile_order(counts, s_max).flip(0)
             .contiguous()}[schedule]
    before = rdense.rasterize_dense_eval.launches
    out = rdense.rasterize_dense_eval(*inputs, grid, order=order)
    torch.cuda.synchronize()
    assert rdense.rasterize_dense_eval.launches == before + 1
    ref = rdense.rasterize_dense_eval_reference(*inputs, grid)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert float(out[7].max()) > 0.3


@pytest.mark.cuda
def test_dense_wrappers_raise_instead_of_falling_back(cuda):
    inputs, grid, _ = kernel_inputs(cuda, (8, 8), 32, 1024, n=200,
                                    dense=True)
    big_tiles = TileGrid(height=H, width=W, tile_h=64, tile_w=64)
    before = (rdense.rasterize_dense_eval.launches,
              rdense.rasterize_dense_fwd.launches)
    with pytest.raises(ValueError, match="pixels"):
        rdense.rasterize_dense_eval(*inputs, big_tiles)
    records, ids, counts, charts, info = inputs
    with pytest.raises(ValueError, match="ids"):
        rdense.rasterize_dense_fwd(records, ids[:-1].contiguous(), counts,
                                   charts, info, grid)
    with pytest.raises(ValueError, match="is on"):
        rdense.rasterize_dense_fwd(records, ids.cpu(), counts, charts, info,
                                   grid)
    maps, ncon = rdense.rasterize_dense_fwd(*inputs, grid)
    g = cotangents(cuda)
    bwd_before = rdense.rasterize_dense_bwd.launches
    short = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="order"):
        rdense.rasterize_dense_bwd(*inputs, maps, ncon, g, grid, order=short)
    with pytest.raises(ValueError, match="order"):
        rdense.rasterize_dense_fwd(*inputs, grid, order=short)
    with pytest.raises(ValueError, match="order"):
        rdense.rasterize_dense_eval(*inputs, grid, order=short)
    with pytest.raises(TypeError, match="order"):
        rdense.rasterize_dense_eval(*inputs, grid,
                                    order=rfwd.tile_order(counts, 1024).long())
    assert rdense.rasterize_dense_bwd.launches == bwd_before
    assert (rdense.rasterize_dense_eval.launches,
            rdense.rasterize_dense_fwd.launches) == (before[0], before[1] + 1)


# the pair-space kernels: 32x32 tiles only; charts of at most 40 rows for
# v3, 42 for v2. (40, 56) is past what the backward kernels stage in shared
# memory, so its chart gradients go to device memory. (pad, s_cap, image
# height and width): an 88x120 image ends in a partial row and column of
# tiles (the nerfstudio path's 600 rows are 18 tiles and 24 rows).
PAIR_CASES = [((4, 4), 1024, (H, W)), ((16, 24), 1024, (H, W)),
              ((16, 24), 16, (H, W)), ((40, 8), 1024, (H, W)),
              ((40, 56), 1024, (H, W)), ((16, 24), 1024, PARTIAL),
              ((40, 56), 1024, PARTIAL)]
PAIR_IDS = ["pad4", "pad16x24", "pad16x24_truncating", "pad40x8",
            "pad40x56_unstaged", "pad16x24_partial_tiles",
            "pad40x56_unstaged_partial_tiles"]
V2_CASES = PAIR_CASES + [((42, 8), 1024, (H, W)), ((40, 80), 1024, PARTIAL)]
V2_IDS = PAIR_IDS + ["pad42x8", "pad40x80_partial_tiles"]
PAIR_PARAMS = ([pytest.param(3, pad, s, hw, id=f"v3-{i}")
                for (pad, s, hw), i in zip(PAIR_CASES, PAIR_IDS)]
               + [pytest.param(v, pad, s, hw, id=f"v{v}-{i}")
                  for v in (2, 1)
                  for (pad, s, hw), i in zip(V2_CASES, V2_IDS)])


def pair_kernels(version):
    """(fwd, bwd, fwd_plain, bwd_plain) of one pair-space version."""
    mod = {3: rv3, 2: rv2, 1: rv1}[version]
    name = f"rasterize_v{version}"
    return tuple(getattr(mod, f"{name}_{k}") for k in (
        "fwd", "bwd", "fwd_reference", "bwd_reference"))


def pair_case(cuda, pad, s_cap, hw=(H, W)):
    """The dense inputs of a scene and their pair-space copies."""
    n = 600 if pad[0] * pad[1] > 1000 else 2000
    dense, grid, bins = kernel_inputs(cuda, pad, 32, s_cap, n=n, height=hw[0],
                                      width=hw[1], dense=True)
    records, _, _, charts, info = dense
    return dense, (*pair_inputs(records, charts, bins), info), grid, bins


def per_gaussian(d_rec_t, d_ch_g, ids, n):
    """Pair-space gradients summed per gaussian."""
    flat = ids.reshape(-1).long()
    d_rec = torch.zeros((n, d_rec_t.shape[-1]), device=d_rec_t.device)
    d_ch = torch.zeros((n, *d_ch_g.shape[2:]), device=d_ch_g.device)
    d_rec.index_add_(0, flat, d_rec_t.reshape(flat.numel(), -1))
    d_ch.index_add_(0, flat, d_ch_g.reshape(flat.numel(), *d_ch_g.shape[2:]))
    return d_rec, d_ch


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("version,pad,s_cap,hw", PAIR_PARAMS)
def test_pair_forward_kernel_matches_plain(cuda, version, pad, s_cap, hw,
                                           lean):
    """The kernel and its plain version run the same float32 operations
    (the v3 scan in the same association), so T and ncontrib agree bit
    for bit, and v2's and v1's maps too; v3's sums over a chunk's slots are
    reordered (1e-4), its t_final is bit-equal."""
    _, pairs, grid, bins = pair_case(cuda, pad, s_cap, hw)
    if s_cap == 16:
        assert bins.overflow > 0
    fwd, _, fwd_plain, _ = pair_kernels(version)
    before = fwd.launches
    maps, ncon = fwd(*pairs, grid, lean=lean)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    ref, ref_ncon = fwd_plain(*pairs, grid, lean=lean)
    torch.testing.assert_close(maps, ref, atol=1e-4, rtol=0)
    assert torch.equal(ncon, ref_ncon)
    if version != 3:
        assert torch.equal(maps, ref)
    if version == 3:
        assert torch.equal(maps[12], ref[12])
    assert float(maps[7].max()) > 0.3
    if lean:
        assert float(maps[8:12].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("version,pad,s_cap,hw", PAIR_PARAMS)
def test_pair_backward_kernel_matches_plain(cuda, version, pad, s_cap, hw,
                                            lean):
    _, pairs, grid, _ = pair_case(cuda, pad, s_cap, hw)
    fwd, bwd, _, bwd_plain = pair_kernels(version)
    maps, ncon = fwd(*pairs, grid, lean=lean)
    g = cotangents(cuda, *hw)
    before = bwd.launches
    d_rec, d_ch = bwd(*pairs, maps, ncon, g, grid, lean=lean)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    assert d_rec.shape == pairs[0].shape and d_ch.shape == pairs[1].shape
    ref_rec, ref_ch = bwd_plain(*pairs, maps, ncon, g, grid, lean=lean)
    errs = backward_errors(d_rec.reshape(-1, 32), d_ch,
                           ref_rec.reshape(-1, 32), ref_ch)
    flip = errs.pop("texture_flip_frac")
    assert max(errs.values()) <= 1e-4, errs
    assert flip <= 1e-5
    assert float(ref_rec.abs().max()) > 0 and float(ref_ch.abs().max()) > 0
    assert float(d_rec[..., [12, 13, 14, 16, 17, 18]].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("version", [3, 2], ids=["v3", "v2"])
@pytest.mark.parametrize("pad,s_cap", [((16, 24), 1024), ((4, 4), 16)],
                         ids=["pad16x24", "truncating"])
def test_pair_kernels_match_dense_kernels(cuda, pad, s_cap, version, lean):
    """On the same pairs the pair-space kernels compute the dense-list
    kernels' function: v2 the same maps and ncontrib (the same serial
    walk); v3 may break a pixel's walk one slot apart where its product
    scan and the serial product round to either side of T_EPS, at no more
    than 1e-5 of the pixels (and one), with the maps held to 1e-4
    elsewhere. Gradients summed per gaussian: 1e-4 of each field group's
    max, 1e-5 sign flips."""
    dense, pairs, grid, bins = pair_case(cuda, pad, s_cap)
    fwd, bwd, _, _ = pair_kernels(version)
    maps, ncon = fwd(*pairs, grid, lean=lean)
    dmaps, dncon = rdense.rasterize_dense_fwd(*dense, grid, lean=lean)
    same = ncon == dncon
    if version == 2:
        assert bool(same.all())
    assert int((~same).sum()) <= max(1, 1e-5 * same.numel())
    torch.testing.assert_close(maps[:, same], dmaps[:, same], atol=1e-4,
                               rtol=0)
    g = cotangents(cuda)
    d_rec_t, d_ch_g = bwd(*pairs, maps, ncon, g, grid, lean=lean)
    d_rec, d_ch = per_gaussian(d_rec_t, d_ch_g, bins.ids, dense[0].shape[0])
    ref_rec, ref_ch = rdense.rasterize_dense_bwd(*dense, dmaps, dncon, g, grid,
                                                 lean=lean)
    errs = backward_errors(d_rec, d_ch, ref_rec, ref_ch)
    flip = errs.pop("texture_flip_frac")
    assert max(errs.values()) <= 1e-4, errs
    assert flip <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("pad,s_cap,hw", [
    ((16, 24), 1024, (H, W)), ((4, 4), 16, (H, W)), ((40, 56), 1024, (H, W)),
    ((40, 80), 1024, PARTIAL)], ids=[
        "pad16x24", "truncating", "pad40x56_unstaged",
        "pad40x80_partial_tiles"])
def test_v1_kernels_match_v2_kernels(cuda, pad, s_cap, hw, lean):
    """On the same pairs the v1 kernels compute the v2 kernels' function
    with their own rounding of the distortion depth m: ncontrib and every
    plane but reg and m1 bit for bit (lean: all of them), reg and m1
    within 1e-6 of their max; the gradients within 1e-5 of each field
    group's max, no sign flips."""
    _, pairs, grid, _ = pair_case(cuda, pad, s_cap, hw)
    maps1, ncon1 = rv1.rasterize_v1_fwd(*pairs, grid, lean=lean)
    maps2, ncon2 = rv2.rasterize_v2_fwd(*pairs, grid, lean=lean)
    assert torch.equal(ncon1, ncon2)
    m_planes = [11, 13]
    rest = [c for c in range(14) if c not in m_planes]
    assert torch.equal(maps1[rest], maps2[rest])
    scale = float(maps2[m_planes].abs().max())
    assert (scale == 0.0) == lean
    assert float((maps1[m_planes] - maps2[m_planes]).abs().max()) <= (
        1e-6 * scale)
    g = cotangents(cuda, *hw)
    d1 = rv1.rasterize_v1_bwd(*pairs, maps1, ncon1, g, grid, lean=lean)
    d2 = rv2.rasterize_v2_bwd(*pairs, maps2, ncon2, g, grid, lean=lean)
    errs = backward_errors(d1[0].reshape(-1, 32), d1[1],
                           d2[0].reshape(-1, 32), d2[1])
    assert errs.pop("texture_flip_frac") == 0.0
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.cuda
def test_pair_wrappers_raise_instead_of_falling_back(cuda):
    _, pairs, grid, _ = pair_case(cuda, (8, 8), 1024)
    records_t, charts_g, counts, info = pairs
    small_tiles = TileGrid(height=H, width=W, tile_h=16, tile_w=16)
    before = (rv3.rasterize_v3_fwd.launches, rv2.rasterize_v2_fwd.launches,
              rv1.rasterize_v1_fwd.launches)
    for fwd in (rv3.rasterize_v3_fwd, rv2.rasterize_v2_fwd,
                rv1.rasterize_v1_fwd):
        with pytest.raises(ValueError, match="32x32"):
            fwd(*pairs, small_tiles)
        with pytest.raises(ValueError, match="is on"):
            fwd(records_t, charts_g, counts.cpu(), info, grid)
        with pytest.raises(ValueError, match="charts_g"):
            fwd(records_t, charts_g[:, :-1].contiguous(), counts, info, grid)
    tall = torch.zeros((*charts_g.shape[:2], 41, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="40 rows"):
        rv3.rasterize_v3_fwd(records_t, tall, counts, info, grid)
    tall = torch.zeros((*charts_g.shape[:2], 43, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="42 rows"):
        rv1.rasterize_v1_fwd(records_t, tall, counts, info, grid)
    # the forwards' tile orders and their cp.async record copies
    buf = torch.empty(records_t.numel() + 4, device=cuda)
    shifted = buf[1:1 + records_t.numel()].view(records_t.shape)
    shifted.copy_(records_t)
    for fwd in (rv3.rasterize_v3_fwd, rv2.rasterize_v2_fwd,
                rv1.rasterize_v1_fwd):
        with pytest.raises(ValueError, match="order"):
            fwd(*pairs, grid,
                order=torch.zeros(1, dtype=torch.int32, device=cuda))
        with pytest.raises(TypeError, match="order"):
            fwd(*pairs, grid, order=rfwd.tile_order(counts, 1024).long())
        with pytest.raises(ValueError, match="order"):
            fwd(*pairs, grid, order=rfwd.tile_order(counts, 1024).cpu())
        with pytest.raises(ValueError, match="aligned"):
            fwd(shifted, charts_g, counts, info, grid)
    assert (rv3.rasterize_v3_fwd.launches, rv2.rasterize_v2_fwd.launches,
            rv1.rasterize_v1_fwd.launches) == before
    # the backwards' tile orders and their cp.async record copies
    g = cotangents(cuda)
    for version in (3, 2, 1):
        fwd, bwd, _, _ = pair_kernels(version)
        maps, ncon = fwd(*pairs, grid)
        bwd_before = bwd.launches
        with pytest.raises(ValueError, match="order"):
            bwd(*pairs, maps, ncon, g, grid,
                order=torch.zeros(1, dtype=torch.int32, device=cuda))
        with pytest.raises(TypeError, match="order"):
            bwd(*pairs, maps, ncon, g, grid,
                order=rfwd.tile_order(counts, 1024).long())
        with pytest.raises(ValueError, match="order"):
            bwd(*pairs, maps, ncon, g, grid,
                order=rfwd.tile_order(counts, 1024).cpu())
        with pytest.raises(ValueError, match="aligned"):
            bwd(shifted, charts_g, counts, info, maps, ncon, g, grid)
        assert bwd.launches == bwd_before


@pytest.mark.cuda
def test_pair_backwards_shared_memory_is_pad_free(cuda):
    """The three pair-space backwards keep the tile's 14 per-pixel planes
    in dynamic shared memory and nothing that the chart pad sizes."""
    for version in (3, 2, 1):
        fixed = bwd_launch_smem(version, 0, 0, 0, 0)
        for pad in ((16, 24), (40, 40), (40, 80)):
            assert (bwd_launch_smem(version, 32, 32, *pad)
                    == 14 * 32 * 32 * 4 + fixed), (version, pad)
        assert 14 * 32 * 32 * 4 + fixed <= 227 * 1024


def applied_chunks(pairs, grid, ncon):
    """Per in-image pixel, the number of v3's chunks of 16 slots in which
    it applies a slot (alpha > 0 below its ncontrib)."""
    records_t, _, counts, info = pairs
    nt, s_max = records_t.shape[:2]
    gx, gy, dirs, inside = rfwd.pixel_grid(grid, info)
    ncon_t = tile_planes(ncon[None].to(torch.float32), grid)[0]
    records = records_t.reshape(nt * s_max, -1)
    act = torch.arange(nt, device=records.device)
    walk = torch.clamp(counts.long(), max=s_max)
    n = torch.zeros_like(ncon_t, dtype=torch.int32)
    for base in range(0, int(walk.max()), rv3.CHUNK):
        slot, valid, _, _, resp = rv3._chunk(records, act, base, s_max, walk,
                                             dirs, gx, gy)
        applied = (valid[..., None] & (resp["alpha"] > 0)
                   & (slot[None, :, None] < ncon_t[:, None]))
        n += applied.any(1).to(torch.int32)
    return n[inside]


def three_orders(counts, s_max):
    """Block order, longest first (the wrappers' own) and reversed."""
    first = rfwd.tile_order(counts, s_max)
    return {"block": torch.arange(counts.numel(), dtype=torch.int32,
                                  device=counts.device),
            "longest_first": first, "reversed": first.flip(0).contiguous()}


# (version, pad, s_cap, image): v3 at (16, 24), at its row limit (40, 40)
# and on lists cut at 48 slots, three chunks of 16 whose carries every
# walked pixel crosses; v2 at (16, 24) and its row limit (40, 42); v1 at
# (16, 24) and at the nerfstudio path's pad (40, 80) on an 800x600 image,
# whose last row of tiles is partial
ORDER_CASES = [(3, (16, 24), 1024, (H, W)), (3, (40, 40), 1024, (H, W)),
               (3, (8, 8), 48, (H, W)), (2, (16, 24), 1024, (H, W)),
               (2, (40, 42), 1024, (H, W)), (1, (16, 24), 1024, (H, W)),
               (1, (40, 80), 128, (600, 800))]
ORDER_IDS = ["v3-pad16x24", "v3-pad40x40", "v3-three_chunks",
             "v2-pad16x24", "v2-pad40x42", "v1-pad16x24",
             "v1-pad40x80_800x600"]


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("version,pad,s_cap,hw", ORDER_CASES, ids=ORDER_IDS)
def test_pair_backward_tile_orders_agree(cuda, version, pad, s_cap, hw,
                                         lean):
    """A pair-space backward under three tile orders (block, longest
    first, reversed): each within the backward gates of its plain
    version, and within 1e-5 of each field group's max of the wrapper's
    own order. Where v3's pixels apply slots in three or more chunks of 16,
    every chunk's carry of T, Bs, E and D is exercised."""
    _, pairs, grid, bins = pair_case(cuda, pad, s_cap, hw)
    assert bins.overflow == 0 or s_cap == 48
    counts, s_max = pairs[2], pairs[0].shape[1]
    fwd, bwd, _, bwd_plain = pair_kernels(version)
    maps, ncon = fwd(*pairs, grid, lean=lean)
    if version == 3:
        assert int((applied_chunks(pairs, grid, ncon) >= 3).sum()) > 0
    g = cotangents(cuda, *hw)
    ref_rec, ref_ch = bwd_plain(*pairs, maps, ncon, g, grid, lean=lean)
    d_rec, d_ch = bwd(*pairs, maps, ncon, g, grid, lean=lean)
    for name, order in three_orders(counts, s_max).items():
        before = bwd.launches
        o_rec, o_ch = bwd(*pairs, maps, ncon, g, grid, lean=lean,
                          order=order)
        torch.cuda.synchronize()
        assert bwd.launches == before + 1
        errs = backward_errors(o_rec.reshape(-1, 32), o_ch,
                               ref_rec.reshape(-1, 32), ref_ch)
        flip = errs.pop("texture_flip_frac")
        assert max(errs.values()) <= 1e-4 and flip <= 1e-5, (name, errs)
        errs = backward_errors(o_rec.reshape(-1, 32), o_ch,
                               d_rec.reshape(-1, 32), d_ch)
        flip = errs.pop("texture_flip_frac")
        assert max(errs.values()) <= 1e-5 and flip <= 1e-5, (name, errs)
        del o_rec, o_ch
    assert float(ref_rec.abs().max()) > 0 and float(ref_ch.abs().max()) > 0


# (version, pad, s_cap, image): v3 at (16, 24), at its row limit (40, 40),
# at (8, 8), on lists cut at 48 slots (three chunks of 16 whose carries
# every walked pixel crosses) and at 40 (cut tiles end half way through
# their third chunk); v2 at (16, 24), (8, 8) and its row limit (40, 42);
# v1 at (16, 24), (8, 8) and at the nerfstudio path's pad (40, 80) on an
# 800x600 image, whose last row of tiles is partial
FWD_ORDER_CASES = [(3, (16, 24), 1024, (H, W)), (3, (40, 40), 1024, (H, W)),
                   (3, (8, 8), 1024, (H, W)), (3, (8, 8), 48, (H, W)),
                   (3, (8, 8), 40, (H, W)), (2, (16, 24), 1024, (H, W)),
                   (2, (8, 8), 1024, (H, W)), (2, (40, 42), 1024, (H, W)),
                   (1, (16, 24), 1024, (H, W)), (1, (8, 8), 1024, (H, W)),
                   (1, (40, 80), 128, (600, 800))]
FWD_ORDER_IDS = ["v3-pad16x24", "v3-pad40x40", "v3-pad8", "v3-three_chunks",
                 "v3-ends_inside_a_chunk", "v2-pad16x24", "v2-pad8",
                 "v2-pad40x42", "v1-pad16x24", "v1-pad8",
                 "v1-pad40x80_800x600"]


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("version,pad,s_cap,hw", FWD_ORDER_CASES,
                         ids=FWD_ORDER_IDS)
def test_pair_forward_tile_orders_bit_equal(cuda, version, pad, s_cap, hw,
                                            lean):
    """The pair-space forwards under three tile orders (block, longest
    first, reversed): a tile order changes no pixel's operations, so each
    order's maps and ncontrib are bit-equal to the wrapper's own order's,
    and to the plain version's as that is: v2 and v1 every plane, v3
    t_final and ncontrib (its other planes within 1e-4: its sums run in another
    order). v3's pixels cross chunks of 16 (T carried by the scan) and
    walk the slots past a tile's count to its chunk's end."""
    _, pairs, grid, bins = pair_case(cuda, pad, s_cap, hw)
    counts, s_max = pairs[2], pairs[0].shape[1]
    fwd, _, fwd_plain, _ = pair_kernels(version)
    ref, ref_ncon = fwd_plain(*pairs, grid, lean=lean)
    maps, ncon = fwd(*pairs, grid, lean=lean)
    assert torch.equal(ncon, ref_ncon)
    if version != 3:
        assert torch.equal(maps, ref)
    else:
        assert torch.equal(maps[12], ref[12])
        torch.testing.assert_close(maps, ref, atol=1e-4, rtol=0)
    if s_cap == 48:
        assert int((applied_chunks(pairs, grid, ncon) >= 3).sum()) > 0
    if s_cap == 40:
        # the cut tiles walk 40 slots: their third chunk ends in padding
        assert bins.overflow > 0 and int(counts.max()) == 40
        assert int((counts == 40).sum()) > 0
    for name, order in three_orders(counts, s_max).items():
        before = fwd.launches
        o_maps, o_ncon = fwd(*pairs, grid, lean=lean, order=order)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        assert torch.equal(o_maps, maps) and torch.equal(o_ncon, ncon), name
    assert float(maps[7].max()) > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("pad,tile,s_cap", DENSE_CASES, ids=DENSE_IDS)
def test_texture_edit_kernel_matches_plain(cuda, pad, tile, s_cap):
    """The texture-edit kernel against its plain version on the dense
    lists: a seeded RGBA canvas (a third of it unpainted) and a depth
    window around the view's α-normalised depth. Its REDs add in no fixed
    order, so each accumulator channel is held to 1e-5 of its max, and the
    texels it reaches (weight > 0) to the plain version's exactly; under
    three tile orders alike."""
    from gstex_torch.ops import texture_edit as te

    inputs, grid, bins = dense_inputs(cuda, pad, tile, s_cap)
    records, ids, counts, charts, info = inputs
    maps = rdense.rasterize_dense_eval(*inputs, grid)
    depth = maps[6] / torch.clamp(maps[7], min=1e-6)
    gen = torch.Generator(device=cuda).manual_seed(9)
    canvas = torch.rand((grid.height, grid.width, 4), generator=gen,
                        device=cuda)
    canvas[..., 3] *= torch.rand((grid.height, grid.width), generator=gen,
                                 device=cuda) > 0.3
    planes = te.edit_planes(canvas[..., :3], canvas[..., 3:], depth - 0.02,
                            depth + 0.02)
    args = (records, ids, counts, planes, info, grid, *pad)
    ref = te.scatter_canvas_reference(*args)
    assert float(ref[..., 3].max()) > 0
    n_tiles = grid.num_tiles
    orders = {"longest_first": None,
              "block": torch.arange(n_tiles, dtype=torch.int32,
                                    device=cuda),
              "reversed": torch.arange(n_tiles - 1, -1, -1,
                                       dtype=torch.int32, device=cuda)}
    for name, order in orders.items():
        before = te.scatter_canvas.launches
        out = te.scatter_canvas(*args, order=order)
        torch.cuda.synchronize()
        assert te.scatter_canvas.launches == before + 1
        assert torch.equal(out[..., 4] > 0, ref[..., 4] > 0), name
        for c in range(te.ACCUM):
            scale = float(ref[..., c].abs().max())
            err = float((out[..., c] - ref[..., c]).abs().max())
            assert err <= 1e-5 * scale, (name, c, err, scale)
