"""gstex_torch binning and cull against gstex_tpu.

Without the cull, the flat bins are compared EXACTLY (the same numpy
centers, extents and depths go into both), including capacities small
enough to overflow. With the cull, each package culls from its own
prepared geometry: rounding may flip a pair that sits right at the cull
threshold, so the kept-pair sets may differ in at most 0.1 % of pairs,
and the maps rendered from either set must agree within the render
tolerance (the cull only drops pairs of weight exactly 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene, surface_scene
from gstex_torch.ops import binning as tbin
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import prepare as tprep
from gstex_torch.ops.cull import make_pair_cull as t_make_cull
from gstex_torch.ops.rasterize_api import rasterize_pl5_eval
from gstex_tpu.ops import binning as jbin
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import prepare as jprep
from gstex_tpu.ops.cull import make_pair_cull as j_make_cull

H, W = 64, 96
JGRID = jbin.TileGrid(height=H, width=W, tile_h=32, tile_w=32)
TGRID = tbin.TileGrid(height=H, width=W, tile_h=32, tile_w=32)
KEYS = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
        "features_rest", "mappings")


def t(a):
    return torch.as_tensor(np.array(a))


def setup(kind="random", n=300, seed=0, dist=3.0):
    gen = random_scene if kind == "random" else surface_scene
    scene = {k: v.numpy() for k, v in
             gen(n, chart_pad=(4, 4), seed=seed, device="cpu").items()}
    c2w = orbit_c2w(dist, 0.3)
    f = 1.2 * max(H, W)
    jc = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    tc = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
    jp = jprep.prepare_splats(*(jnp.asarray(scene[k]) for k in KEYS), jc,
                              active_sh_degree=3)
    tp = tprep.prepare_splats(*(t(scene[k]) for k in KEYS), tc,
                              active_sh_degree=3)
    return scene, jc, tc, jp, tp


def assert_bins_equal(tb, jb):
    for name in ("gids", "slot_valid", "starts", "counts", "num_tiles_hit"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.total_pairs == int(jb.total_pairs)
    assert tb.overflow == int(jb.overflow)


@pytest.mark.parametrize("pair_cap,s_cap", [(8192, 64), (8192, 8),
                                            (256, 64)],
                         ids=["fits", "s_cap_overflow", "pair_cap_overflow"])
@pytest.mark.parametrize("kind", ["random", "surface"])
def test_flat_bins_exact_without_cull(kind, pair_cap, s_cap):
    _, _, _, jp, _ = setup(kind)
    inputs = [np.asarray(x) for x in (jp.centers, jp.extents, jp.depths,
                                      jp.valid)]
    jb = jbin.build_tile_bins_flat(*map(jnp.asarray, inputs), JGRID,
                                   pair_cap=pair_cap, s_cap=s_cap)
    tb = tbin.build_tile_bins_flat(*map(t, inputs), TGRID,
                                   pair_cap=pair_cap, s_cap=s_cap)
    assert_bins_equal(tb, jb)
    if (pair_cap, s_cap) != (8192, 64):
        assert tb.overflow > 0


def _pairs(bins):
    """Kept (tile, gid) pairs of flat bins as a set."""
    starts = np.asarray(bins.starts)
    counts = np.asarray(bins.counts)
    gids = np.asarray(bins.gids)
    return {(tile, int(g)) for tile in range(len(starts))
            for g in gids[starts[tile]:starts[tile] + counts[tile]]}


@pytest.mark.parametrize("kind", ["random", "surface"])
def test_flat_bins_with_cull(kind):
    scene, jc, tc, jp, tp = setup(kind)
    jb = jbin.build_tile_bins_flat(jp.centers, jp.extents, jp.depths,
                                   jp.valid, JGRID, pair_cap=8192, s_cap=256,
                                   cull_fn=j_make_cull(jp.geom, jc, JGRID))
    tb = tbin.build_tile_bins_flat(tp.centers, tp.extents, tp.depths,
                                   tp.valid, TGRID, pair_cap=8192, s_cap=256,
                                   cull_fn=t_make_cull(tp.geom, tc, TGRID))
    assert int(jb.overflow) == 0 and tb.overflow == 0
    jpairs, tpairs = _pairs(jb), _pairs(tb)
    assert len(jpairs) < tb.total_pairs          # the cull did drop pairs
    assert len(jpairs ^ tpairs) <= 1e-3 * len(jpairs)

    # the same geometry rendered from either pair list
    jb_t = tbin.FlatBins(*(t(x) if i < 5 else int(x)
                           for i, x in enumerate(jb)))
    maps = [rasterize_pl5_eval(tp.geom, t(scene["texture"]),
                               t(scene["texture_hw"]), b, tc, TGRID,
                               s_cap=256) for b in (tb, jb_t)]
    for k in ("img", "texture_rgb", "depth", "alpha"):
        np.testing.assert_allclose(maps[0][k].numpy(), maps[1][k].numpy(),
                                   atol=5e-5, err_msg=k)


def test_cull_table_matches():
    _, jc, tc, jp, tp = setup("surface")
    jt = j_make_cull(jp.geom, jc, JGRID).table
    tt = t_make_cull(tp.geom, tc, TGRID).table
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4,
                               rtol=1e-4)


def test_tile_ranges_exact():
    _, _, _, jp, _ = setup("random")
    inputs = [np.asarray(x) for x in (jp.centers, jp.extents)]
    valid = np.asarray(jp.valid)
    jr = jbin.tile_ranges(*map(jnp.asarray, inputs), JGRID,
                          jnp.asarray(valid))
    tr = tbin.tile_ranges(*map(t, inputs), TGRID, t(valid))
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("total,hottest", [(0, 0), (1000, 17),
                                           (393_000, 1500),
                                           (9_000_000, 9000)])
def test_caps_identical(total, hottest):
    assert tbin.settle_caps(total, hottest) == jbin.settle_caps(total,
                                                                hottest)
    assert (tbin.flat_slot_cap(total, hottest)
            == jbin.flat_slot_cap(total, hottest))
    assert tbin.SLOT_ALIGN == jbin.SLOT_ALIGN


def test_pair_cap_limit():
    with pytest.raises(ValueError):
        tbin.build_tile_bins_flat(torch.zeros((1, 2)), torch.ones((1, 2)),
                                  torch.ones(1), torch.ones(1, dtype=bool),
                                  TGRID, pair_cap=(1 << 24) + 1, s_cap=16)
