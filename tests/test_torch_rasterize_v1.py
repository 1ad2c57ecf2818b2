"""The v1 pair-space tier: gstex_torch ``rasterize_pl(version=1)`` (on CPU
tensors: the plain versions of the v1 kernels, ``ops/rasterize_v1.py``)
against gstex_tpu, maps and gradients of all seven param leaves, lean and
full, on lists that truncate; and against the port's own v2 tier, which v1
equals but for its rounding of the distortion depth.

The references are the JAX package's XLA tier ``rasterize`` and its v1
kernels run in interpret mode (``rasterize_pl(..., interpret=True,
version=1)``, as ``tests/test_pallas.py`` runs them), at that file's
tolerances: atol 2e-5 / rtol 1e-4 on the maps, atol 3e-4 on gradients
scaled by the reference's max abs. Each JAX run is made once per module:
an interpreted v1 kernel takes tens of seconds on the CPU.

Also here: the shapes both packages refuse, and the wrappers' input
checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_rasterize_pairs as pairs
import test_torch_rasterize_xla as xla
from gstex_torch.ops import rasterize_v1 as rv1
from gstex_torch.ops import rasterize_v2 as rv2
from gstex_torch.ops.binning import TileGrid
from gstex_torch.ops.pair_inputs import check_pair_shapes, pair_inputs
from gstex_tpu.ops import binning as jbinning
from gstex_tpu.ops import rasterize_pallas as jrp
from gstex_tpu.ops.rasterize_pallas_api import rasterize_pl as jrasterize_pl

# (tile, s_max, chart pad, surfels): lists that truncate (overflow > 0)
CASE = pairs.CASES["truncating"]
EVAL_MAPS = pairs.EVAL_MAPS
# the planes that carry the distortion depth m: reg and the residual m1
M_PLANES = [11, 13]


def scene():
    tile, s_max, pad, n = CASE
    return xla.scene_np(n=n, pad=pad), tile, s_max


@pytest.fixture(scope="module")
def runs():
    """JAX's XLA tier (lean: with no cotangent on the maps lean leaves
    out), JAX's v1 kernels interpreted (likewise) and the port's v1 tier, each
    on the same truncating lists, each made once."""
    cache = {}

    def get(what, lean=False):
        key = (what, lean)
        if key not in cache:
            s, tile, s_max = scene()
            cot = pairs.cotangents(lean)
            if what == "jax_xla":
                cache[key] = xla.jax_run(s, tile, s_max, cot)
            elif what == "jax_v1":
                cache[key] = xla.jax_run(s, tile, s_max, cot,
                                         render=pairs.jax_kernel(1))
            else:
                cache[key] = xla.torch_run(s, tile, s_max, cot,
                                           render=pairs.port(1, lean))
        return cache[key]

    return get


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_training_maps_match_jax(runs, lean):
    want, _, want_ovf = runs("jax_xla", lean)
    got, _, got_ovf = runs("port", lean)
    assert got_ovf == want_ovf > 0
    xla.assert_maps_close(got, want, keys=EVAL_MAPS if lean else xla.MAPS)
    assert got["alpha"].max() > 0.3
    if lean:
        assert np.abs(got["normal"]).max() == 0 == np.abs(got["reg"]).max()


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_gradients_match_jax(runs, lean):
    _, want, _ = runs("jax_xla", lean)
    _, got, _ = runs("port", lean)
    xla.assert_grads_close(got, want)
    assert np.abs(got["texture"]).max() > 0


def test_maps_match_jax_v1_kernel_interpret(runs):
    want, _, want_ovf = runs("jax_v1")
    got, _, got_ovf = runs("port")
    assert got_ovf == want_ovf > 0
    xla.assert_maps_close(got, want)


def test_gradients_match_jax_v1_kernel_interpret(runs):
    _, want, _ = runs("jax_v1")
    _, got, _ = runs("port")
    xla.assert_grads_close(got, want)


def test_gradients_under_a_given_order_match_jax_v1_kernel_interpret(
        runs, monkeypatch):
    """``_RasterizePairs`` hands the v1 backward the tile order it computes
    in its forward; given another order (here the reversed one), the
    backward still gives JAX's interpreted ``_bwd_kernel``'s gradients."""
    _, want, _ = runs("jax_v1")
    got, made, passed = pairs.run_under_reversed_order(
        monkeypatch, pairs.port(1), 1)
    assert len(made) == 1 and len(passed) == 1 and passed[0] is made[0]
    xla.assert_grads_close(got, want)


def test_lean_maps_match_jax_v1_kernel_interpret(runs):
    """JAX's kernel always computes the normal and reg chains; under the
    lean cotangents (none on the maps lean leaves out) its eval maps and
    gradients are what the port's lean walk computes."""
    want, _, want_ovf = runs("jax_v1", lean=True)
    got, _, got_ovf = runs("port", lean=True)
    assert got_ovf == want_ovf > 0
    xla.assert_maps_close(got, want, keys=EVAL_MAPS)
    assert np.abs(got["normal"]).max() == 0 == np.abs(got["reg"]).max()


def test_lean_gradients_match_jax_v1_kernel_interpret(runs):
    _, want, _ = runs("jax_v1", lean=True)
    _, got, _ = runs("port", lean=True)
    xla.assert_grads_close(got, want)
    assert np.abs(got["texture"]).max() > 0


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_v1_matches_v2(lean):
    """On the same pairs, v1's plain versions compute v2's to the bit but
    where the distortion depth m enters: the forward's reg and m1 planes
    (1e-6 of their max) and, in full mode, the record gradients, which
    take m through the reg chain (1e-5 of each field group's max). The
    chart gradients do not depend on m."""
    records, bins, charts, info, grid = pairs.dense_inputs(s_max=16)
    pin = (*pair_inputs(records, charts, bins), info)
    maps1, ncon1 = rv1.rasterize_v1_fwd_reference(*pin, grid, lean=lean)
    maps2, ncon2 = rv2.rasterize_v2_fwd_reference(*pin, grid, lean=lean)
    assert torch.equal(ncon1, ncon2)
    rest = [c for c in range(14) if c not in M_PLANES]
    assert torch.equal(maps1[rest], maps2[rest])
    for c in M_PLANES:
        scale = float(maps2[c].abs().max())
        if lean:
            assert scale == 0.0 and float(maps1[c].abs().max()) == 0.0
            continue
        assert scale > 0
        torch.testing.assert_close(maps1[c] / scale, maps2[c] / scale,
                                   atol=1e-6, rtol=0)
    g = torch.tensor(np.random.default_rng(2).standard_normal(
        (12, xla.H, xla.W)).astype(np.float32))
    d1 = rv1.rasterize_v1_bwd_reference(*pin, maps1, ncon1, g, grid,
                                        lean=lean)
    d2 = rv2.rasterize_v2_bwd_reference(*pin, maps2, ncon2, g, grid,
                                        lean=lean)
    assert torch.equal(d1[1], d2[1])
    rec1, rec2 = d1[0].reshape(-1, 32), d2[0].reshape(-1, 32)
    if lean:
        assert torch.equal(rec1, rec2)
        return
    for group in pairs.FIELD_GROUPS:
        scale = float(rec2[:, group].abs().max())
        assert scale > 0
        torch.testing.assert_close(rec1[:, group] / scale,
                                   rec2[:, group] / scale, atol=1e-5, rtol=0,
                                   msg=str(group))


@pytest.mark.parametrize("pad,tile,ok", [
    ((42, 8), 32, True), ((43, 8), 32, False), ((4, 4), 16, False)])
def test_v1_shapes_refused_where_jax_refuses(pad, tile, ok):
    """Charts taller than v1's a-major lane packing takes (3·Ch <= 128: 42
    rows) and tiles other than 32 x 32 raise in both packages."""
    grid = TileGrid(height=64, width=96, tile_h=tile, tile_w=tile)
    jgrid = jbinning.TileGrid(height=64, width=96, tile_h=tile, tile_w=tile)
    texture = jnp.zeros((2, *pad, 3), jnp.float32)
    if ok:
        check_pair_shapes(1, pad, grid)
        jrp.pack_charts(texture)
        return
    with pytest.raises(ValueError, match="pallas4"):
        check_pair_shapes(1, pad, grid)
    with pytest.raises((AssertionError, ValueError)):
        jrasterize_pl(None, texture, None, None, None, jgrid, version=1)


def test_v1_wrappers_check_their_inputs():
    grid = TileGrid(height=32, width=32, tile_h=32, tile_w=32)
    records_t = torch.zeros((1, 16, 32))
    charts_g = torch.zeros((1, 16, 4, 4, 3))
    counts = torch.zeros(1, dtype=torch.int32)
    info = torch.zeros(18)
    maps, ncon = rv1.rasterize_v1_fwd(records_t, charts_g, counts, info, grid)
    assert maps.shape == (14, 32, 32) and float(maps[:12].abs().max()) == 0
    assert int(ncon.min()) == 16
    assert rv1.rasterize_v1_fwd.launches == 0      # CPU calls do not count
    d_rec, d_ch = rv1.rasterize_v1_bwd(records_t, charts_g, counts, info,
                                       maps, ncon, torch.zeros((12, 32, 32)),
                                       grid)
    assert d_rec.shape == records_t.shape and d_ch.shape == charts_g.shape
    assert rv1.rasterize_v1_bwd.launches == 0
    with pytest.raises(TypeError, match="counts"):
        rv1.rasterize_v1_fwd(records_t, charts_g, counts.long(), info, grid)
    with pytest.raises(ValueError, match="32x32"):
        rv1.rasterize_v1_fwd(records_t, charts_g, counts, info,
                             TileGrid(height=32, width=32, tile_h=16,
                                      tile_w=16))
    with pytest.raises(ValueError, match="gmaps"):
        rv1.rasterize_v1_bwd(records_t, charts_g, counts, info, maps, ncon,
                             torch.zeros((14, 32, 32)), grid)
    with pytest.raises(ValueError, match="42 rows"):
        rv1.rasterize_v1_fwd(records_t, torch.zeros((1, 16, 43, 4, 3)),
                             counts, info, grid)
