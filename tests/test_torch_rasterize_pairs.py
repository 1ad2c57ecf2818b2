"""The pair-space render API: gstex_torch ``rasterize_pl(version=3)`` and
``rasterize_pl(version=2)`` (on CPU tensors: the plain versions of the v3
chunk-scan and v2 serial kernels, ``ops/rasterize_v3.py`` and
``ops/rasterize_v2.py``) against gstex_tpu, maps and gradients of all
seven param leaves, lean and full, with lists that truncate.

As the JAX package's own tests do (``tests/test_pallas.py``), the
reference is its XLA tier ``rasterize``, which its v3 and v2 kernels are
held to, at that file's tolerances: atol 2e-5 / rtol 1e-4 on the maps,
atol 3e-4 on gradients scaled by the reference's max abs. The v3 and v2
kernels themselves run in interpret mode once per version, on the
truncating case (tens of seconds each on the CPU).

Also here: the pair-space plain backwards, reduced to per-gaussian
gradients, against ``rasterize.backward_walk`` on the dense lists; the
shapes both packages refuse; the wrappers' input checks; and the v3
forward kernel's streamed product scan (``csrc/tile_walk.cuh``, ``kV3``)
against the scan of the plain version and of JAX's kernel, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_rasterize_xla as xla
from gstex_torch.ops import rasterize as plain
from gstex_torch.ops import rasterize_v2 as rv2
from gstex_torch.ops import rasterize_v3 as rv3
from gstex_torch.ops.binning import TileGrid, build_tile_bins
from gstex_torch.ops.pair_inputs import check_pair_shapes, pair_inputs
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.rasterize_api import rasterize_pl
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_tpu.ops import binning as jbinning
from gstex_tpu.ops import rasterize_pallas as jrp
from gstex_tpu.ops import rasterize_pallas3 as jrp3
from gstex_tpu.ops.rasterize_pallas_api import rasterize_pl as jrasterize_pl
from jax.experimental import pallas as pl

EVAL_MAPS = ("img", "texture_rgb", "depth", "alpha")
# (tile, s_max, chart pad, surfels)
CASES = {"tile32": (32, 64, (4, 4), 48), "truncating": (32, 16, (4, 4), 96)}
VERSIONS = (3, 2)
PLAIN = {3: (rv3.rasterize_v3_fwd_reference, rv3.rasterize_v3_bwd_reference),
         2: (rv2.rasterize_v2_fwd_reference, rv2.rasterize_v2_bwd_reference)}
# record fields by what they carry
FIELD_GROUPS = ([0, 1, 2], [3], [4, 5, 6, 7], [8, 9, 10, 11], [15, 19], [20],
                [21, 22, 23], [24, 25])


def port(version, lean=False):
    def render(geom, texture, hw, bins, cam, grid, extra_channels=False):
        return rasterize_pl(geom, texture, hw, bins, cam, grid,
                            version=version, lean=lean)
    return render


def jax_kernel(version):
    def render(geom, texture, hw, bins, cam, grid, extra_channels=False):
        return jrasterize_pl(geom, texture, hw, bins, cam, grid,
                             interpret=True, version=version)
    return render


def cotangents(lean):
    return xla.cotangents_np(EVAL_MAPS if lean else xla.MAPS)


@pytest.fixture(scope="module")
def results():
    """Each (case, lean) runs once through JAX's XLA tier and once per
    version through the port; lean has no cotangent on the maps it leaves
    out."""
    jax_cache, port_cache = {}, {}

    def get(name, lean, version):
        tile, s_max, pad, n = CASES[name]
        s = xla.scene_np(n=n, pad=pad)
        if (name, lean) not in jax_cache:
            jax_cache[name, lean] = xla.jax_run(s, tile, s_max,
                                                cotangents(lean))
        if (name, lean, version) not in port_cache:
            port_cache[name, lean, version] = xla.torch_run(
                s, tile, s_max, cotangents(lean), render=port(version, lean))
        return jax_cache[name, lean], port_cache[name, lean, version]

    return get


@pytest.mark.parametrize("version", VERSIONS, ids=["v3", "v2"])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_training_maps_match_jax(results, case, lean, version):
    (want, _, want_ovf), (got, _, got_ovf) = results(case, lean, version)
    assert got_ovf == want_ovf and (got_ovf > 0) == (case == "truncating")
    xla.assert_maps_close(got, want, keys=EVAL_MAPS if lean else xla.MAPS)
    assert got["alpha"].max() > 0.3
    if lean:
        assert np.abs(got["normal"]).max() == 0 == np.abs(got["reg"]).max()


@pytest.mark.parametrize("version", VERSIONS, ids=["v3", "v2"])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(results, case, lean, version):
    (_, want, _), (_, got, _) = results(case, lean, version)
    xla.assert_grads_close(got, want)
    assert np.abs(got["texture"]).max() > 0


@pytest.fixture(scope="module")
def kernels():
    """JAX's own v3 or v2 kernels, interpreted, and the port on the same
    truncating lists; once per version."""
    cache = {}

    def get(version):
        if version not in cache:
            tile, s_max, pad, n = CASES["truncating"]
            s = xla.scene_np(n=n, pad=pad)
            cot = cotangents(False)
            cache[version] = (
                xla.jax_run(s, tile, s_max, cot, render=jax_kernel(version)),
                xla.torch_run(s, tile, s_max, cot, render=port(version)))
        return cache[version]

    return get


@pytest.mark.parametrize("version", VERSIONS, ids=["v3", "v2"])
def test_maps_match_jax_kernels_interpret(kernels, version):
    (want, _, want_ovf), (got, _, got_ovf) = kernels(version)
    assert got_ovf == want_ovf > 0
    xla.assert_maps_close(got, want)


@pytest.mark.parametrize("version", VERSIONS, ids=["v3", "v2"])
def test_gradients_match_jax_kernels_interpret(kernels, version):
    (_, want, _), (_, got, _) = kernels(version)
    xla.assert_grads_close(got, want)


@pytest.mark.parametrize("version", VERSIONS, ids=["v3", "v2"])
def test_gradients_under_a_given_order_match_jax_kernels_interpret(
        kernels, monkeypatch, version):
    """``_RasterizePairs`` computes one tile order in its forward and hands
    it to the version's backward; given another order (here the reversed
    one), the backward still gives JAX's interpreted ``_bwd_kernel3``'s or
    ``_bwd_kernel2``'s gradients, at the tolerances above."""
    (_, want, _), _ = kernels(version)
    got, made, passed = run_under_reversed_order(monkeypatch, port(version),
                                                 version)
    assert len(made) == 1 and len(passed) == 1 and passed[0] is made[0]
    xla.assert_grads_close(got, want)


def run_under_reversed_order(monkeypatch, render, version):
    """The port's truncating case through ``render`` with
    ``_RasterizePairs``' tile order reversed: (gradients, the orders made,
    the orders the version's backward was given)."""
    from gstex_torch.ops import rasterize_api

    made, passed = [], []
    real_order = rasterize_api.tile_order
    fwd, bwd = rasterize_api._PAIR_IMPLS[version]

    def reversed_order(counts, n):
        made.append(real_order(counts, n).flip(0).contiguous())
        return made[-1]

    def bwd_spy(*args, order=None, **kwargs):
        passed.append(order)
        return bwd(*args, order=order, **kwargs)
    monkeypatch.setattr(rasterize_api, "tile_order", reversed_order)
    monkeypatch.setitem(rasterize_api._PAIR_IMPLS, version, (fwd, bwd_spy))
    tile, s_max, pad, n = CASES["truncating"]
    _, got, _ = xla.torch_run(xla.scene_np(n=n, pad=pad), tile, s_max,
                              cotangents(False), render=render)
    return got, made, passed


def dense_inputs(n=48, s_max=64, pad=(4, 4)):
    """The port's records, dense lists, charts and camera of the test
    scene."""
    s = {k: torch.tensor(v) for k, v in xla.scene_np(n=n, pad=pad).items()}
    f = 1.2 * max(xla.H, xla.W)
    cam = xla.tcam.make_camera(f, f, xla.W / 2, xla.H / 2, xla.H, xla.W,
                               xla.c2w(), device="cpu")
    grid = TileGrid(height=xla.H, width=xla.W, tile_h=32, tile_w=32)
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    bins = build_tile_bins(prep.centers, prep.extents, prep.depths,
                           prep.valid, grid, 8192, s_max)
    records = assemble_records(prep.geom, cam.c2w[:3, 3], s["texture_hw"])
    return records, bins, s["texture"].contiguous(), cam_info(cam), grid


def reduce_pairs(d_rec_t, d_ch_g, ids, n):
    """Pair-space gradients summed per gaussian, as autograd sums them
    through the gathers."""
    flat = ids.reshape(-1).long()
    d_rec = torch.zeros((n, d_rec_t.shape[-1])).index_add_(
        0, flat, d_rec_t.reshape(flat.numel(), -1))
    d_ch = torch.zeros((n, *d_ch_g.shape[2:])).index_add_(
        0, flat, d_ch_g.reshape(flat.numel(), *d_ch_g.shape[2:]))
    return d_rec, d_ch


@pytest.mark.parametrize("version", VERSIONS, ids=["v3", "v2"])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_pair_backward_reduces_to_dense_walk(version, lean):
    """Under the same maps, ncontrib and cotangents, the pair-space plain
    backward summed per gaussian is ``rasterize.backward_walk`` on the
    dense lists: v2's is that walk on the pair-space view; v3's recovers T
    by suffix products and writes the chain rule out (1e-5 of each field
    group's max). Its forward gives the dense walk's maps and ncontrib."""
    records, bins, charts, info, grid = dense_inputs(s_max=16)
    n = records.shape[0]
    pairs = pair_inputs(records, charts, bins)
    maps, ncon = plain.forward_scan(records, bins.ids, bins.counts, charts,
                                    info, grid, lean=lean)
    fwd, bwd = PLAIN[version]
    pmaps, pncon = fwd(*pairs, info, grid, lean=lean)
    assert torch.equal(pncon, ncon)
    torch.testing.assert_close(pmaps, maps, atol=1e-6, rtol=0)
    g = torch.tensor(np.random.default_rng(2).standard_normal(
        (12, xla.H, xla.W)).astype(np.float32))
    want_rec, want_ch = plain.backward_walk(records, bins.ids, bins.counts,
                                            charts, info, maps, ncon, g, grid,
                                            lean=lean)
    d_rec_t, d_ch_g = bwd(*pairs, info, maps, ncon, g, grid, lean=lean)
    assert d_rec_t.shape == pairs.records_t.shape
    assert d_ch_g.shape == pairs.charts_g.shape
    got_rec, got_ch = reduce_pairs(d_rec_t, d_ch_g, bins.ids, n)
    for group in FIELD_GROUPS:
        scale = float(want_rec[:, group].abs().max())
        assert scale > 0
        torch.testing.assert_close(got_rec[:, group] / scale,
                                   want_rec[:, group] / scale, atol=1e-5,
                                   rtol=0, msg=str(group))
    scale = float(want_ch.abs().max())
    torch.testing.assert_close(got_ch / scale, want_ch / scale, atol=1e-5,
                               rtol=0)
    assert float(got_rec[:, [12, 13, 14, 16, 17, 18]].abs().max()) == 0.0


@pytest.mark.parametrize("version,pad,tile,ok", [
    (3, (40, 8), 32, True), (3, (41, 8), 32, False), (3, (4, 4), 16, False),
    (2, (42, 8), 32, True), (2, (43, 8), 32, False), (2, (4, 4), 16, False)])
def test_pair_shapes_refused_where_jax_refuses(version, pad, tile, ok):
    """Charts taller than the JAX kernels' lane packing takes (40 rows for
    v3, 42 for v2) and tiles other than 32 x 32 raise in both packages."""
    grid = TileGrid(height=64, width=96, tile_h=tile, tile_w=tile)
    jgrid = jbinning.TileGrid(height=64, width=96, tile_h=tile, tile_w=tile)
    texture = jnp.zeros((2, *pad, 3), jnp.float32)
    pack = jrp3.pack_charts_cmajor if version == 3 else jrp.pack_charts
    if ok:
        check_pair_shapes(version, pad, grid)
        pack(texture)
        return
    with pytest.raises(ValueError, match="pallas4"):
        check_pair_shapes(version, pad, grid)
    with pytest.raises((AssertionError, ValueError)):
        jrasterize_pl(None, texture, None, None, None, jgrid,
                      version=version)


def test_wrappers_check_their_inputs():
    grid = TileGrid(height=32, width=32, tile_h=32, tile_w=32)
    records_t = torch.zeros((1, 16, 32))
    charts_g = torch.zeros((1, 16, 4, 4, 3))
    counts = torch.zeros(1, dtype=torch.int32)
    info = torch.zeros(18)
    for fwd, bwd in ((rv3.rasterize_v3_fwd, rv3.rasterize_v3_bwd),
                     (rv2.rasterize_v2_fwd, rv2.rasterize_v2_bwd)):
        maps, ncon = fwd(records_t, charts_g, counts, info, grid)
        assert maps.shape == (14, 32, 32) and float(maps[:12].abs().max()) == 0
        assert int(ncon.min()) == 16           # s_max where no walk broke
        assert fwd.launches == 0               # CPU calls do not count
        d_rec, d_ch = bwd(records_t, charts_g, counts, info, maps, ncon,
                          torch.zeros((12, 32, 32)), grid)
        assert d_rec.shape == records_t.shape and d_ch.shape == charts_g.shape
        with pytest.raises(TypeError, match="counts"):
            fwd(records_t, charts_g, counts.long(), info, grid)
        with pytest.raises(ValueError, match="charts_g"):
            fwd(records_t, charts_g[:, :8], counts, info, grid)
        with pytest.raises(ValueError, match="records_t"):
            fwd(records_t[0], charts_g, counts, info, grid)
        with pytest.raises(ValueError, match="32x32"):
            fwd(records_t, charts_g, counts, info,
                TileGrid(height=32, width=32, tile_h=16, tile_w=16))
        with pytest.raises(ValueError, match="gmaps"):
            bwd(records_t, charts_g, counts, info, maps, ncon,
                torch.zeros((14, 32, 32)), grid)
    tall = torch.zeros((1, 16, 41, 4, 3))
    with pytest.raises(ValueError, match="40 rows"):
        rv3.rasterize_v3_fwd(records_t, tall, counts, info, grid)
    rv2.rasterize_v2_fwd(records_t, tall, counts, info, grid)


def streamed_incl(q, t_in, unroll):
    """The v3 forward kernel's transmittance after each slot of a chunk,
    as its walk streams the scan (``csrc/tile_walk.cuh``, ``kV3``), in
    float32: slot k's products over 2, 4, 8 and 16 slots from windows of
    the last q, p2, p4 and p8, kept in runs of ``unroll`` slots and 1
    before the chunk. ``q`` (16, P), ``t_in`` (P,)."""
    ones = np.ones(q.shape[1], np.float32)
    q1, q2, q4, q8 = ([ones] * unroll for _ in range(4))
    incl = np.empty_like(q)
    for h in range(0, rv3.CHUNK, unroll):
        for i in range(unroll):
            p2 = q[h + i] * q1[(i - 1) % unroll]
            p4 = p2 * q2[(i - 2) % unroll]
            p8 = p4 * q4[(i - 4) % unroll]
            incl[h + i] = (p8 * q8[(i - 8) % unroll]) * t_in
            q1[i], q2[i], q4[i], q8[i] = q[h + i], p2, p4, p8
    return incl


def jax_cumprod_incl(q):
    """JAX's kernel helper ``_cumprod_incl`` on a (16, P) block, run as
    its kernel runs it (interpreted: it rolls sublanes)."""
    def kernel(q_ref, o_ref):
        o_ref[...] = jrp3._cumprod_incl(q_ref[...])
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(q.shape, jnp.float32),
        interpret=True)(jnp.asarray(q)))


@pytest.mark.parametrize("unroll", [8, 16])
def test_v3_streamed_scan_is_the_scan_bit_for_bit(unroll):
    """On seeded chunks (40 % of alpha zero; slots past a random count
    padded with alpha 0, as the kernel pads a tile's last chunk), the
    kernel's streamed scan equals ``rasterize_v3.cumprod_incl`` and JAX's
    ``_cumprod_incl``, times T_in, bit for bit; the serial product does
    not."""
    rng = np.random.default_rng(11)
    n = 2048
    alpha = rng.uniform(1.0 / 255.0, 0.999, (rv3.CHUNK, n)).astype(np.float32)
    alpha[rng.random((rv3.CHUNK, n)) < 0.4] = 0.0
    count = rng.integers(1, rv3.CHUNK + 1, n)
    alpha[np.arange(rv3.CHUNK)[:, None] >= count[None]] = 0.0
    q = np.float32(1.0) - alpha
    t_in = rng.uniform(1e-4, 1.0, n).astype(np.float32)
    t_in[:64] = 1.0
    got = streamed_incl(q, t_in, unroll)
    port = (rv3.cumprod_incl(torch.from_numpy(q)[None])[0]
            * torch.from_numpy(t_in)[None]).numpy()
    jax_scan = jax_cumprod_incl(q) * t_in[None]
    assert np.array_equal(got.view(np.uint32), port.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), jax_scan.view(np.uint32))
    serial = np.cumprod(q, 0, dtype=np.float32) * t_in[None]
    assert not np.array_equal(serial.view(np.uint32), got.view(np.uint32))
