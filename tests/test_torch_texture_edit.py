"""``gstex_torch.ops.texture_edit`` (the plain version of the texture-edit
kernel, as a CPU tensor runs it) against ``gstex_tpu.ops.texture_edit`` on
the same numpy scene, dense lists, canvas and depth window, at the JAX
package's editing test sizes (8x16 tiles, s_max 64, 48x64 images).

Tolerances: the accumulator within 1e-5 of each channel's max (float32
sums taken in another order; the packages compute a splat's response in
their own arithmetic, a few ulps apart). A texel whose window membership
sits within float error of the window's edge may be reached by one package
and not the other; such texels are found by moving the window's bounds by
four float32 ulps of the depth either way, exempted, and counted (at most
5 % of the texels reached; 4 of about 200 here). ``apply_edit`` to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import sh as tsh
from gstex_torch.ops import texture_edit as tte
from gstex_torch.ops.binning import build_tile_bins
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.rasterize_api import rasterize_pl_eval
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_torch.data.synthetic import orbit_c2w
from gstex_tpu.ops import binning as jbin
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import prepare as jprep
from gstex_tpu.ops import texture_edit as jte
from test_torch_render import jax_params, scene_np, to_numpy

H, W = 48, 64
CFG = dict(tile_h=8, tile_w=16, pair_cap=1 << 14, s_max=64)
TOL = 1e-5
EDGE_SHARE = 0.05
WINDOW = 1e-2
_CACHE = {}


def setup(pad, seed=0, n=300):
    """The port's and JAX's prepared view of one surface scene: (port
    prepare, port bins, JAX prepare, JAX bins, params, buffers, cameras,
    grid)."""
    s = scene_np("surface", n=n, pad=pad, seed=seed)
    jp, jb = jax_params(s)
    tp, tb = params_from_jax(to_numpy(jp), to_numpy(jb), device="cpu")
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * W
    jc = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    tc = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
    cfg = tmodel.GStexConfig(chart_pad=pad, **CFG)
    grid = cfg.grid(H, W)
    kw = dict(active_sh_degree=3, sh_degree=3, fix_init=False,
              extent_sigma=3.0)
    tpr = prepare_splats(tp.means, tp.log_scales, tp.quats,
                         tp.opacity_logits, tp.features_dc, tp.features_rest,
                         tb.mappings, tc, **kw)
    tbins = build_tile_bins(tpr.centers, tpr.extents, tpr.depths, tpr.valid,
                            grid, cfg.pair_cap, cfg.s_max)
    jpr = jprep.prepare_splats(jp.means, jp.log_scales, jp.quats,
                               jp.opacity_logits, jp.features_dc,
                               jp.features_rest, jb.mappings, jc, **kw)
    jgrid = jbin.TileGrid(height=H, width=W, tile_h=CFG["tile_h"],
                          tile_w=CFG["tile_w"])
    jbins = jbin.build_tile_bins(jpr.centers, jpr.extents, jpr.depths,
                                 jpr.valid, jgrid, pair_cap=cfg.pair_cap,
                                 s_max=cfg.s_max)
    return tpr, tbins, jpr, jbins, (jp, jb), (tp, tb), (jc, tc), grid, jgrid


def inputs(pad, seed=0):
    """A seeded RGBA canvas and the port's α-normalised depth ± WINDOW."""
    tpr, tbins, _, _, _, (tp, tb), (_, tc), grid, _ = setup(pad, seed)
    maps = rasterize_pl_eval(tpr.geom, tsh.sh_to_rgb(tp.texture).contiguous(),
                             tb.texture_hw, tbins, tc, grid)
    depth = (maps["depth"] / torch.clamp(maps["alpha"], min=1e-6)).numpy()
    rng = np.random.default_rng(seed)
    canvas = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    canvas[rng.uniform(size=(H, W)) < 0.3, 3] = 0.0
    return canvas, depth


def port_accum(pad, canvas, lo, hi, seed=0):
    tpr, tbins, _, _, _, (tp, tb), (_, tc), grid, _ = setup(pad, seed)
    return tte.texture_edit(
        tpr.geom, tp.texture.shape, tb.texture_hw, tbins, tc, grid,
        torch.from_numpy(canvas[..., :3]), torch.from_numpy(canvas[..., 3:]),
        torch.from_numpy(lo), torch.from_numpy(hi)).numpy()


def jax_accum(pad, seed=0):
    """JAX's accumulator on the port's inputs, cached per module."""
    key = (pad, seed)
    if key not in _CACHE:
        _, tbins, jpr, jbins, (jp, jb), _, (jc, _), _, jgrid = setup(pad,
                                                                     seed)
        assert np.array_equal(np.asarray(jbins.ids), tbins.ids.numpy())
        canvas, depth = inputs(pad, seed)
        _CACHE[key] = np.asarray(jte.texture_edit(
            jpr.geom, jp.texture.shape, jb.texture_hw, jbins, jc, jgrid,
            jnp.asarray(canvas[..., :3]), jnp.asarray(canvas[..., 3:]),
            jnp.asarray(depth - WINDOW), jnp.asarray(depth + WINDOW)))
    return _CACHE[key]


@pytest.mark.parametrize("pad", [(4, 4), (4, 8), (8, 4)],
                         ids=["4x4", "4x8", "8x4"])
def test_texture_edit_matches_jax(pad):
    canvas, depth = inputs(pad)
    lo, hi = depth - WINDOW, depth + WINDOW
    got = port_accum(pad, canvas, lo, hi)
    want = jax_accum(pad)
    assert got.shape == want.shape == (300, *pad, tte.ACCUM)
    # texels whose window membership is within float error of an edge
    eps = 4 * np.spacing(np.abs(depth).astype(np.float32))
    wide = port_accum(pad, canvas, lo - eps, hi + eps)
    narrow = port_accum(pad, canvas, lo + eps, hi - eps)
    edge = (wide != narrow).any(-1)
    reached = (want[..., 4] > 0) | (got[..., 4] > 0)
    assert reached.sum() > 100, "the canvas reached too few texels"
    assert edge.sum() <= EDGE_SHARE * reached.sum(), (edge.sum(),
                                                      reached.sum())
    np.testing.assert_array_equal((got[..., 4] > 0) & ~edge,
                                  (want[..., 4] > 0) & ~edge)
    for c in range(tte.ACCUM):
        scale = np.abs(want[..., c]).max()
        err = np.abs(got[..., c] - want[..., c])[~edge].max()
        assert err <= TOL * scale, (c, err, scale)


def test_apply_edit_matches_jax():
    rng = np.random.default_rng(3)
    cur = rng.uniform(0, 1, (20, 4, 8, 3)).astype(np.float32)
    acc = rng.uniform(0, 2, (20, 4, 8, 5)).astype(np.float32)
    acc[:5] = 0.0
    want = np.asarray(jte.apply_edit(jnp.asarray(cur), jnp.asarray(acc)))
    got = tte.apply_edit(torch.from_numpy(cur), torch.from_numpy(acc))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:5].numpy(), cur[:5])


def test_empty_canvas_is_a_noop():
    pad = (4, 4)
    _, depth = inputs(pad)
    canvas = np.zeros((H, W, 4), np.float32)
    acc = port_accum(pad, canvas, depth - WINDOW, depth + WINDOW)
    assert not acc[..., :4].any() and acc[..., 4].any()
    cur = torch.rand((300, *pad, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(tte.apply_edit(cur, torch.from_numpy(acc)), cur)


def test_scatter_canvas_refuses_bad_inputs():
    pad = (4, 4)
    tpr, tbins, *_, (tp, tb), (_, tc), grid, _ = setup(pad)
    records = assemble_records(tpr.geom, tc.c2w[:3, 3], tb.texture_hw)
    info = cam_info(tc)
    planes = torch.zeros((tte.PLANES, H, W))
    args = (records, tbins.ids, tbins.counts)
    out = tte.scatter_canvas(*args, planes, info, grid, *pad)
    assert out.shape == (300, *pad, tte.ACCUM) and not out[..., :4].any()
    with pytest.raises(ValueError, match="planes"):
        tte.scatter_canvas(*args, planes[:5], info, grid, *pad)
    with pytest.raises(TypeError, match="ids"):
        tte.scatter_canvas(records, tbins.ids.long(), tbins.counts, planes,
                           info, grid, *pad)
    with pytest.raises(ValueError, match="order"):
        tte.scatter_canvas(*args, planes, info, grid, *pad,
                           order=torch.zeros(3, dtype=torch.int32))
    misaligned = torch.zeros(records.numel() + 1)[1:].view(records.shape)
    with pytest.raises(ValueError, match="aligned"):
        tte.scatter_canvas(misaligned, tbins.ids, tbins.counts, planes, info,
                           grid, *pad)
