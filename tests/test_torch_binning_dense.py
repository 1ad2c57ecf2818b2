"""gstex_torch ``build_tile_bins`` (the dense per-tile lists) against
gstex_tpu ``build_tile_bins``.

Without the cull every field is compared EXACTLY (the same numpy centers,
extents and depths go into both), including capacities small enough to
truncate. With the cull each package culls from its own prepared geometry,
so a pair right at the threshold may flip: the kept-pair sets may differ
in at most 0.1 % of pairs, as ``test_torch_binning.py`` allows for the
flat lists. The port's dense and flat lists hold the same pairs in the
same order.
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
from gstex_tpu.ops import binning as jbin
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import prepare as jprep
from gstex_tpu.ops.cull import make_pair_cull as j_make_cull

H, W = 64, 96
KEYS = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
        "features_rest", "mappings")
# (pair_cap, s_max): roomy, truncating lists, truncating pair expansion
CAPS = [(8192, 64), (8192, 8), (256, 64)]
CAP_IDS = ["fits", "s_max_overflow", "pair_cap_overflow"]


def t(a):
    return torch.as_tensor(np.array(a))


def grids(tile):
    kw = dict(height=H, width=W, tile_h=tile, tile_w=tile)
    return jbin.TileGrid(**kw), tbin.TileGrid(**kw)


def setup(kind="random", n=300, seed=0):
    gen = random_scene if kind == "random" else surface_scene
    scene = {k: v.numpy() for k, v in
             gen(n, chart_pad=(4, 4), seed=seed, device="cpu").items()}
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * max(H, W)
    jc = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    tc = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
    jp = jprep.prepare_splats(*(jnp.asarray(scene[k]) for k in KEYS), jc,
                              active_sh_degree=3)
    tp = tprep.prepare_splats(*(t(scene[k]) for k in KEYS), tc,
                              active_sh_degree=3)
    return jc, tc, jp, tp


def aabbs(jp):
    return [np.asarray(x) for x in (jp.centers, jp.extents, jp.depths,
                                    jp.valid)]


def assert_bins_equal(tb, jb):
    for name in ("ids", "mask", "counts", "num_tiles_hit"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.ids.dtype == torch.int32 and tb.mask.dtype == torch.bool
    assert tb.total_pairs == int(jb.total_pairs)
    assert tb.overflow == int(jb.overflow)


@pytest.mark.parametrize("tile", [32, 16])
@pytest.mark.parametrize("pair_cap,s_max", CAPS, ids=CAP_IDS)
@pytest.mark.parametrize("kind", ["random", "surface"])
def test_dense_bins_exact_without_cull(kind, pair_cap, s_max, tile):
    _, _, jp, _ = setup(kind)
    jgrid, tgrid = grids(tile)
    inputs = aabbs(jp)
    jb = jbin.build_tile_bins(*map(jnp.asarray, inputs), jgrid,
                              pair_cap=pair_cap, s_max=s_max)
    tb = tbin.build_tile_bins(*map(t, inputs), tgrid, pair_cap=pair_cap,
                              s_max=s_max)
    assert_bins_equal(tb, jb)
    if (pair_cap, s_max) != (8192, 64):
        assert tb.overflow > 0
    assert int(tb.mask.sum()) == int(torch.clamp(tb.counts, max=s_max).sum())


@pytest.mark.parametrize("kind", ["random", "surface"])
def test_coverage_method_gives_the_sort_lists(kind):
    """JAX's ``method="coverage"`` is a second way to the same lists; the
    port keeps the argument and one path. Held to JAX's coverage output
    and to the port's own sort output."""
    _, _, jp, _ = setup(kind)
    jgrid, tgrid = grids(32)
    inputs = aabbs(jp)
    jb = jbin.build_tile_bins(*map(jnp.asarray, inputs), jgrid,
                              pair_cap=8192, s_max=64, method="coverage")
    cov = tbin.build_tile_bins(*map(t, inputs), tgrid, pair_cap=8192,
                               s_max=64, method="coverage")
    srt = tbin.build_tile_bins(*map(t, inputs), tgrid, pair_cap=8192,
                               s_max=64, method="sort")
    assert_bins_equal(cov, jb)
    assert torch.equal(cov.ids, srt.ids) and torch.equal(cov.mask, srt.mask)


def test_method_argument_is_checked():
    args = (torch.zeros((1, 2)), torch.ones((1, 2)), torch.ones(1),
            torch.ones(1, dtype=bool), grids(32)[1])
    with pytest.raises(ValueError, match="method"):
        tbin.build_tile_bins(*args, pair_cap=64, s_max=8, method="radix")
    with pytest.raises(ValueError, match="cull_fn"):
        tbin.build_tile_bins(*args, pair_cap=64, s_max=8, method="coverage",
                             cull_fn=lambda g, x, y: g >= 0)
    with pytest.raises(ValueError, match="pair_cap"):
        tbin.build_tile_bins(*args, pair_cap=(1 << 24) + 1, s_max=8)


def _pairs(bins):
    """Kept (tile, gid) pairs of dense bins as a set."""
    ids, mask = np.asarray(bins.ids), np.asarray(bins.mask)
    tiles, ranks = np.nonzero(mask)
    return set(zip(tiles.tolist(), ids[tiles, ranks].tolist()))


@pytest.mark.parametrize("kind", ["random", "surface"])
def test_dense_bins_with_cull(kind):
    jc, tc, jp, tp = setup(kind)
    jgrid, tgrid = grids(32)
    jb = jbin.build_tile_bins(jp.centers, jp.extents, jp.depths, jp.valid,
                              jgrid, pair_cap=8192, s_max=256,
                              cull_fn=j_make_cull(jp.geom, jc, jgrid))
    tb = tbin.build_tile_bins(tp.centers, tp.extents, tp.depths, tp.valid,
                              tgrid, pair_cap=8192, s_max=256,
                              cull_fn=t_make_cull(tp.geom, tc, tgrid))
    assert int(jb.overflow) == 0 and tb.overflow == 0
    jpairs, tpairs = _pairs(jb), _pairs(tb)
    assert len(jpairs) < tb.total_pairs          # the cull did drop pairs
    assert len(jpairs ^ tpairs) <= 1e-3 * len(jpairs)
    assert tb.total_pairs == int(jb.total_pairs)


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
@pytest.mark.parametrize("pair_cap,s_max", CAPS, ids=CAP_IDS)
def test_dense_and_flat_lists_agree(pair_cap, s_max, cull):
    """One pair expansion and one order behind both layouts: each tile's
    dense row equals its flat segment, and the counters are the same."""
    _, tc, _, tp = setup("surface")
    _, tgrid = grids(32)
    cull_fn = t_make_cull(tp.geom, tc, tgrid) if cull else None
    args = (tp.centers, tp.extents, tp.depths, tp.valid, tgrid, pair_cap,
            s_max)
    dense = tbin.build_tile_bins(*args, cull_fn=cull_fn)
    flat = tbin.build_tile_bins_flat(*args, cull_fn=cull_fn)
    assert torch.equal(dense.counts, flat.counts)
    assert torch.equal(dense.num_tiles_hit, flat.num_tiles_hit)
    assert (dense.total_pairs, dense.overflow) == (flat.total_pairs,
                                                   flat.overflow)
    for tile in range(tgrid.num_tiles):
        n = min(int(dense.counts[tile]), s_max)
        start = int(flat.starts[tile])
        assert torch.equal(dense.ids[tile, :n], flat.gids[start:start + n])
        assert bool(dense.mask[tile, :n].all())
        assert not bool(dense.mask[tile, n:].any())
        assert int(dense.ids[tile, n:].abs().sum()) == 0
