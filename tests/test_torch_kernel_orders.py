"""The tile orders and record alignment that the flat eval kernel, the
three dense-list kernels and the six pair-space kernels take, checked by
their wrappers on the CPU.

These kernels copy records 16 B at a time (cp.async) and take their tiles
longest first, in an order computed once a frame (``rasterize_pl5_eval``,
``rasterize_pl_eval``) or once a training step (``_Rasterize4``, in its
forward, for the dense forward and backward both; ``_RasterizePairs``, in
its forward, for the v3, v2 or v1 forward and backward). The wrappers
refuse misaligned records and orders of the wrong type or length before
they dispatch, so the CPU path checks what the card path would launch. The
kernels themselves run only on the card (``test_torch_kernels_cuda.py``).
"""

import functools

import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_camera, surface_scene
from gstex_torch.ops import rasterize_api
from gstex_torch.ops import rasterize_dense as rdense
from gstex_torch.ops import rasterize_eval as reval
from gstex_torch.ops import rasterize_fwd as rfwd
from gstex_torch.ops import rasterize_v1 as rv1
from gstex_torch.ops import rasterize_v2 as rv2
from gstex_torch.ops import rasterize_v3 as rv3
from gstex_torch.ops.binning import (TileGrid, build_tile_bins,
                                     build_tile_bins_flat)
from gstex_torch.ops.cull import make_pair_cull
from gstex_torch.ops.pair_inputs import pair_inputs
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_torch.ops.sh import sh_to_rgb

H, W = 48, 64
S_MAX = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small tensor ops; one intra-op thread keeps
    them from contending with the other test workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene():
    """A small surface scene, its camera and its prepared splats."""
    s = surface_scene(300, chart_pad=(4, 6), seed=2, device="cpu")
    cam = orbit_camera(H, W, dist=3.0, azimuth=0.4, device="cpu")
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    return s, cam, prep


def bin_scene(cam, prep, dense, tile=16):
    """The grid and the dense or flat lists of the scene's splats."""
    grid = TileGrid(height=H, width=W, tile_h=tile, tile_w=tile)
    build = build_tile_bins if dense else build_tile_bins_flat
    return grid, build(prep.centers, prep.extents, prep.depths, prep.valid,
                       grid, 1 << 14, S_MAX,
                       cull_fn=make_pair_cull(prep.geom, cam, grid))


def inputs(dense, tile=16):
    """The scene's kernel inputs on the CPU: (records, ids, counts, charts,
    info) or (records, gids, starts, counts, charts, info); the grid; the
    bins."""
    s, cam, prep = scene()
    grid, bins = bin_scene(cam, prep, dense, tile)
    lists = ((bins.ids, bins.counts) if dense
             else (bins.gids, bins.starts, bins.counts))
    records = assemble_records(prep.geom, cam.c2w[:3, 3], s["texture_hw"])
    return ((records, *lists, sh_to_rgb(s["texture"]).contiguous(),
             cam_info(cam)), grid, bins)


def misaligned(records):
    """A contiguous copy of ``records`` 4 B past a 16-byte boundary."""
    buf = torch.empty(records.numel() + 4)
    off = next(k for k in range(4) if (buf.data_ptr() + 4 * k) % 16)
    shifted = buf[off:off + records.numel()].view(records.shape)
    shifted.copy_(records)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    return shifted


def residuals(records, ids, counts, charts, info, grid):
    maps, ncon = rdense.rasterize_dense_fwd(records, ids, counts, charts,
                                            info, grid)
    gmaps = torch.zeros((rfwd.NG, H, W))
    return maps, ncon, gmaps


def test_eval_refuses_misaligned_records():
    (records, *rest), grid, _ = inputs(dense=False)
    with pytest.raises(ValueError, match="aligned"):
        reval.rasterize_eval(misaligned(records), *rest, grid, S_MAX)


@pytest.mark.parametrize("bad", ["int64", "short", "on_other_shape"])
def test_eval_refuses_a_bad_tile_order(bad):
    args, grid, _ = inputs(dense=False)
    order = rfwd.tile_order(args[3], S_MAX)
    wrong = {"int64": order.long(), "short": order[:-1],
             "on_other_shape": order.reshape(1, -1)}[bad]
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err, match="order"):
        reval.rasterize_eval(*args, grid, S_MAX, order=wrong)


def test_eval_takes_an_order_and_computes_the_same_maps():
    """On the CPU the order only passes the checks: the plain version
    computes each tile whatever the order, so any permutation gives the
    same maps."""
    args, grid, _ = inputs(dense=False)
    base = reval.rasterize_eval(*args, grid, S_MAX)
    order = rfwd.tile_order(args[3], S_MAX).flip(0).contiguous()
    assert torch.equal(reval.rasterize_eval(*args, grid, S_MAX, order=order),
                       base)
    assert float(base[7].max()) > 0.3


def test_dense_backward_refuses_misaligned_records():
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    maps, ncon, gmaps = residuals(records, ids, counts, charts, info, grid)
    with pytest.raises(ValueError, match="aligned"):
        rdense.rasterize_dense_bwd(misaligned(records), ids, counts, charts,
                                   info, maps, ncon, gmaps, grid)
    # the dense eval kernel copies its records through the ring as well
    with pytest.raises(ValueError, match="aligned"):
        rdense.rasterize_dense_eval(misaligned(records), ids, counts, charts,
                                    info, grid)


def test_dense_eval_refuses_misaligned_records():
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    before = rdense.rasterize_dense_eval.launches
    with pytest.raises(ValueError, match="aligned"):
        rdense.rasterize_dense_eval(misaligned(records), ids, counts, charts,
                                    info, grid)
    assert rdense.rasterize_dense_eval.launches == before


@pytest.mark.parametrize("bad", ["int64", "short", "on_other_shape"])
def test_dense_eval_refuses_a_bad_tile_order(bad):
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    order = rfwd.tile_order(counts, ids.shape[1])
    wrong = {"int64": order.long(), "short": order[:-1],
             "on_other_shape": order.reshape(1, -1)}[bad]
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err, match="order"):
        rdense.rasterize_dense_eval(records, ids, counts, charts, info, grid,
                                    order=wrong)


def test_dense_eval_takes_an_order_and_computes_the_same_maps():
    """On the CPU the order only passes the checks: the plain version
    computes each tile whatever the order, so any permutation gives the
    same maps."""
    args, grid, _ = inputs(dense=True)
    base = rdense.rasterize_dense_eval(*args, grid)
    order = rfwd.tile_order(args[2], S_MAX).flip(0).contiguous()
    assert torch.equal(rdense.rasterize_dense_eval(*args, grid, order=order),
                       base)
    assert float(base[7].max()) > 0.3


@pytest.mark.parametrize("bad", ["int64", "short", "on_other_shape"])
def test_dense_backward_refuses_a_bad_tile_order(bad):
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    maps, ncon, gmaps = residuals(records, ids, counts, charts, info, grid)
    order = rfwd.tile_order(counts, ids.shape[1])
    wrong = {"int64": order.long(), "short": order[:-1],
             "on_other_shape": order.reshape(1, -1)}[bad]
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err, match="order"):
        rdense.rasterize_dense_bwd(records, ids, counts, charts, info, maps,
                                   ncon, gmaps, grid, order=wrong)


def test_dense_forward_refuses_misaligned_records():
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    before = rdense.rasterize_dense_fwd.launches
    with pytest.raises(ValueError, match="aligned"):
        rdense.rasterize_dense_fwd(misaligned(records), ids, counts, charts,
                                   info, grid)
    assert rdense.rasterize_dense_fwd.launches == before


@pytest.mark.parametrize("bad", ["int64", "short", "on_other_shape"])
def test_dense_forward_refuses_a_bad_tile_order(bad):
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    order = rfwd.tile_order(counts, ids.shape[1])
    wrong = {"int64": order.long(), "short": order[:-1],
             "on_other_shape": order.reshape(1, -1)}[bad]
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err, match="order"):
        rdense.rasterize_dense_fwd(records, ids, counts, charts, info, grid,
                                   order=wrong)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_dense_forward_takes_an_order_and_computes_the_same_maps(lean):
    """On the CPU the order only passes the checks: the plain version
    computes each tile whatever the order, so any permutation gives the
    same maps and ncontrib."""
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    maps, ncon = rdense.rasterize_dense_fwd(records, ids, counts, charts,
                                            info, grid, lean=lean)
    order = rfwd.tile_order(counts, ids.shape[1]).flip(0).contiguous()
    maps2, ncon2 = rdense.rasterize_dense_fwd(records, ids, counts, charts,
                                              info, grid, lean=lean,
                                              order=order)
    assert torch.equal(maps2, maps) and torch.equal(ncon2, ncon)
    assert float(maps[7].max()) > 0.3


def test_tile_order_clamps_dense_counts_at_s_max():
    """The dense lists' counts are raw pair counts; the dense backward
    walks at most s_max slots a tile, so tiles at or past s_max tie and
    keep their relative order below the shorter ones."""
    _, grid, bins = inputs(dense=True)
    counts = bins.counts
    assert int(counts.max()) > S_MAX      # the raw counts pass s_max
    order = rfwd.tile_order(counts, S_MAX)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(grid.num_tiles))
    capped = torch.clamp(counts, max=S_MAX)[order.long()]
    assert bool((capped[:-1] >= capped[1:]).all())
    full = int((counts >= S_MAX).sum())
    assert bool((capped[:full] == S_MAX).all())
    assert torch.equal(order, rfwd.tile_order(torch.clamp(counts, max=S_MAX),
                                              S_MAX))


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_rasterize4_computes_one_order_for_its_backward(monkeypatch, lean):
    """``_Rasterize4`` computes the tile order once, in its forward, and
    hands that tensor to the dense backward."""
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    made, passed = [], []
    real_order = rasterize_api.tile_order
    real_bwd = rasterize_api.rasterize_dense_bwd

    def order_spy(c, s):
        made.append(real_order(c, s))
        return made[-1]

    def bwd_spy(*args, order=None, **kwargs):
        passed.append(order)
        return real_bwd(*args, order=order, **kwargs)
    monkeypatch.setattr(rasterize_api, "tile_order", order_spy)
    monkeypatch.setattr(rasterize_api, "rasterize_dense_bwd", bwd_spy)
    rec = records.clone().requires_grad_()
    ch = charts.clone().requires_grad_()
    maps, _ = rasterize_api._Rasterize4.apply(rec, ch, ids, counts, info,
                                              grid, lean)
    assert len(made) == 1 and not passed
    maps[:8].sum().backward()
    assert len(made) == 1 and len(passed) == 1
    assert passed[0] is made[0]
    assert torch.equal(passed[0], real_order(counts, ids.shape[1]))
    assert float(rec.grad.abs().max()) > 0 and float(ch.grad.abs().max()) > 0


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_rasterize4_hands_one_order_to_both_kernels(monkeypatch, lean):
    """A training step through ``_Rasterize4`` calls ``tile_order`` once
    and hands that one tensor to the dense forward and the dense
    backward."""
    (records, ids, counts, charts, info), grid, _ = inputs(dense=True)
    calls, fwd_orders, bwd_orders = [], [], []
    real_order = rasterize_api.tile_order
    real_fwd = rasterize_api.rasterize_dense_fwd
    real_bwd = rasterize_api.rasterize_dense_bwd

    def order_spy(c, s):
        calls.append(real_order(c, s))
        return calls[-1]

    def fwd_spy(*args, order=None, **kwargs):
        fwd_orders.append(order)
        return real_fwd(*args, order=order, **kwargs)

    def bwd_spy(*args, order=None, **kwargs):
        bwd_orders.append(order)
        return real_bwd(*args, order=order, **kwargs)
    monkeypatch.setattr(rasterize_api, "tile_order", order_spy)
    monkeypatch.setattr(rasterize_api, "rasterize_dense_fwd", fwd_spy)
    monkeypatch.setattr(rasterize_api, "rasterize_dense_bwd", bwd_spy)
    rec = records.clone().requires_grad_()
    ch = charts.clone().requires_grad_()
    maps, _ = rasterize_api._Rasterize4.apply(rec, ch, ids, counts, info,
                                              grid, lean)
    maps[:8].sum().backward()
    assert len(calls) == 1
    assert len(fwd_orders) == 1 and len(bwd_orders) == 1
    assert fwd_orders[0] is calls[0] and bwd_orders[0] is calls[0]
    assert torch.equal(calls[0], real_order(counts, ids.shape[1]))


def test_pl5_eval_computes_one_order_a_frame(monkeypatch):
    """``rasterize_pl5_eval`` hands the eval kernel the frame's tile order,
    by capped count, longest first."""
    s, cam, prep = scene()
    grid, fbins = bin_scene(cam, prep, dense=False)
    passed = []
    real_eval = rasterize_api.rasterize_eval

    def eval_spy(*args, order=None):
        passed.append(order)
        return real_eval(*args, order=order)
    monkeypatch.setattr(rasterize_api, "rasterize_eval", eval_spy)
    out = rasterize_api.rasterize_pl5_eval(prep.geom, s["texture"],
                                           s["texture_hw"], fbins, cam, grid,
                                           S_MAX)
    assert len(passed) == 1
    assert torch.equal(passed[0], rfwd.tile_order(fbins.counts, S_MAX))
    assert float(out["alpha"].max()) > 0.3


def test_pl_eval_computes_one_order_a_frame(monkeypatch):
    """``rasterize_pl_eval`` computes the frame's tile order once, by
    capped count, longest first, and hands it to the dense eval kernel,
    which then computes none of its own."""
    s, cam, prep = scene()
    grid, bins = bin_scene(cam, prep, dense=True)
    made, passed, inner = [], [], []
    real_order = rasterize_api.tile_order
    real_eval = rasterize_api.rasterize_dense_eval

    def order_spy(c, n):
        made.append(real_order(c, n))
        return made[-1]

    def eval_spy(*args, order=None):
        passed.append(order)
        return real_eval(*args, order=order)
    monkeypatch.setattr(rasterize_api, "tile_order", order_spy)
    monkeypatch.setattr(rasterize_api, "rasterize_dense_eval", eval_spy)
    monkeypatch.setattr(rdense, "tile_order",
                        lambda *a: inner.append(a) or real_order(*a))
    out = rasterize_api.rasterize_pl_eval(prep.geom, s["texture"],
                                          s["texture_hw"], bins, cam, grid)
    assert len(made) == 1 and len(passed) == 1 and not inner
    assert passed[0] is made[0]
    assert torch.equal(made[0], rfwd.tile_order(bins.counts, S_MAX))
    assert float(out["alpha"].max()) > 0.3


def pair_case():
    """A small surface scene's per-slot copies on the CPU, at the 32x32
    tiles the pair-space kernels take: ((records_t, charts_g, counts,
    info), grid)."""
    (records, _, _, charts, info), grid, bins = inputs(dense=True, tile=32)
    return (*pair_inputs(records, charts, bins), info), grid


# each pair-space version's (forward, backward)
PAIR = {3: (rv3.rasterize_v3_fwd, rv3.rasterize_v3_bwd),
        2: (rv2.rasterize_v2_fwd, rv2.rasterize_v2_bwd),
        1: (rv1.rasterize_v1_fwd, rv1.rasterize_v1_bwd)}
VERSIONS = pytest.mark.parametrize("version", [2, 3, 1],
                                   ids=["v2", "v3", "v1"])
# every pair-space forward takes a tile order and aligned records (v2's
# against its plain version under three orders: test_v2_forward_under_...)
ORDERED_FWD = VERSIONS


def pair_residuals(pairs, grid, version, lean=False):
    maps, ncon = PAIR[version][0](*pairs, grid, lean=lean)
    g = torch.tensor(np.random.default_rng(1).standard_normal(
        (rfwd.NG, H, W)).astype(np.float32))
    return maps, ncon, g


@VERSIONS
def test_pair_backward_refuses_misaligned_records(version):
    fwd, bwd = PAIR[version]
    pairs, grid = pair_case()
    maps, ncon, g = pair_residuals(pairs, grid, version)
    records_t = pairs[0]
    shifted = misaligned(records_t.reshape(-1, 32)).view(records_t.shape)
    before = bwd.launches
    with pytest.raises(ValueError, match="aligned"):
        bwd(shifted, *pairs[1:], maps, ncon, g, grid)
    assert bwd.launches == before
    # the forward copies the same records through its cp.async ring
    with pytest.raises(ValueError, match="aligned"):
        fwd(shifted, *pairs[1:], grid)


@ORDERED_FWD
def test_pair_forward_refuses_misaligned_records(version):
    """The pair-space forwards copy their records through the cp.async
    ring."""
    fwd = PAIR[version][0]
    pairs, grid = pair_case()
    records_t = pairs[0]
    shifted = misaligned(records_t.reshape(-1, 32)).view(records_t.shape)
    before = fwd.launches
    with pytest.raises(ValueError, match="aligned"):
        fwd(shifted, *pairs[1:], grid)
    assert fwd.launches == before


@ORDERED_FWD
@pytest.mark.parametrize("bad", ["int64", "short", "on_other_shape"])
def test_pair_forward_refuses_a_bad_tile_order(bad, version):
    pairs, grid = pair_case()
    order = rfwd.tile_order(pairs[2], pairs[0].shape[1])
    wrong = {"int64": order.long(), "short": order[:-1],
             "on_other_shape": order.reshape(1, -1)}[bad]
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err, match="order"):
        PAIR[version][0](*pairs, grid, order=wrong)


@pytest.mark.parametrize("version", [3, 1], ids=["v3", "v1"])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_pair_forward_takes_an_order_and_computes_the_same_maps(lean,
                                                                version):
    """On the CPU the order only passes the checks: the plain version
    computes each tile whatever the order, so any permutation gives the
    same maps and ncontrib."""
    fwd = PAIR[version][0]
    pairs, grid = pair_case()
    maps, ncon = fwd(*pairs, grid, lean=lean)
    order = rfwd.tile_order(pairs[2], pairs[0].shape[1]).flip(0).contiguous()
    maps2, ncon2 = fwd(*pairs, grid, lean=lean, order=order)
    assert torch.equal(maps2, maps) and torch.equal(ncon2, ncon)
    assert float(maps[7].max()) > 0.3


@functools.lru_cache(maxsize=1)
def v2_plain():
    """The pair case and the v2 forward's plain version on it (lean),
    computed once for the tests that hold the wrapper to it."""
    pairs, grid = pair_case()
    return pairs, grid, rv2.rasterize_v2_fwd_reference(*pairs, grid,
                                                       lean=True)


@pytest.mark.parametrize("schedule", ["block", "longest_first",
                                      "reversed"])
def test_v2_forward_under_an_order_is_its_plain_version(schedule):
    """On the CPU the v2 forward under a given order is its plain version,
    which takes no order, bit for bit."""
    pairs, grid, (ref, ref_ncon) = v2_plain()
    first = rfwd.tile_order(pairs[2], pairs[0].shape[1])
    order = {"block": torch.arange(grid.num_tiles, dtype=torch.int32),
             "longest_first": first,
             "reversed": first.flip(0).contiguous()}[schedule]
    maps, ncon = rv2.rasterize_v2_fwd(*pairs, grid, lean=True, order=order)
    assert torch.equal(maps, ref) and torch.equal(ncon, ref_ncon)
    assert float(maps[7].max()) > 0.3


@VERSIONS
@pytest.mark.parametrize("bad", ["int64", "short", "on_other_shape"])
def test_pair_backward_refuses_a_bad_tile_order(bad, version):
    pairs, grid = pair_case()
    maps, ncon, g = pair_residuals(pairs, grid, version)
    order = rfwd.tile_order(pairs[2], pairs[0].shape[1])
    wrong = {"int64": order.long(), "short": order[:-1],
             "on_other_shape": order.reshape(1, -1)}[bad]
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err, match="order"):
        PAIR[version][1](*pairs, maps, ncon, g, grid, order=wrong)


@VERSIONS
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_pair_backward_takes_an_order_and_computes_the_same_gradients(
        lean, version):
    """On the CPU the order only passes the checks: the plain version
    computes each tile whatever the order."""
    bwd = PAIR[version][1]
    pairs, grid = pair_case()
    maps, ncon, g = pair_residuals(pairs, grid, version, lean)
    d_rec, d_ch = bwd(*pairs, maps, ncon, g, grid, lean=lean)
    order = rfwd.tile_order(pairs[2], pairs[0].shape[1]).flip(0).contiguous()
    d_rec2, d_ch2 = bwd(*pairs, maps, ncon, g, grid, lean=lean, order=order)
    assert torch.equal(d_rec2, d_rec) and torch.equal(d_ch2, d_ch)
    assert float(d_rec.abs().max()) > 0 and float(d_ch.abs().max()) > 0


@VERSIONS
def test_rasterize_pairs_computes_an_order_for_each_version(monkeypatch,
                                                            version):
    """``_RasterizePairs`` computes one tile order, in its forward, and
    hands that tensor to the version's backward."""
    pairs, grid = pair_case()
    made, passed = [], []
    real_order = rasterize_api.tile_order

    def order_spy(c, n):
        made.append(real_order(c, n))
        return made[-1]

    def bwd_spy(real):
        def bwd(*args, **kwargs):
            passed.append(kwargs.get("order"))
            return real(*args, **kwargs)
        return bwd
    monkeypatch.setattr(rasterize_api, "tile_order", order_spy)
    monkeypatch.setattr(rasterize_api, "_PAIR_IMPLS", {
        v: (f, bwd_spy(b)) for v, (f, b) in rasterize_api._PAIR_IMPLS.items()})
    rec = pairs[0].clone().requires_grad_()
    ch = pairs[1].clone().requires_grad_()
    maps, _ = rasterize_api._RasterizePairs.apply(rec, ch, pairs[2], pairs[3],
                                                  grid, version, True)
    assert len(made) == 1 and not passed
    maps[:8].sum().backward()
    assert len(made) == 1 and len(passed) == 1
    assert passed[0] is made[0]
    assert torch.equal(passed[0], real_order(pairs[2], S_MAX))
    assert float(rec.grad.abs().max()) > 0 and float(ch.grad.abs().max()) > 0


@VERSIONS
def test_rasterize_pairs_hands_one_order_to_both_kernels(monkeypatch,
                                                         version):
    """A training step through ``_RasterizePairs`` calls ``tile_order``
    once, before the forward, and hands that one tensor to the version's
    forward and backward."""
    pairs, grid = pair_case()
    calls, fwd_orders, bwd_orders = [], [], []
    real_order = rasterize_api.tile_order

    def order_spy(c, n):
        calls.append(real_order(c, n))
        return calls[-1]

    def spy(real, seen):
        def kernel(*args, **kwargs):
            assert len(calls) == 1    # the order exists before the forward
            seen.append(kwargs.get("order"))
            return real(*args, **kwargs)
        return kernel
    monkeypatch.setattr(rasterize_api, "tile_order", order_spy)
    monkeypatch.setattr(rasterize_api, "_PAIR_IMPLS", {
        v: (spy(f, fwd_orders), spy(b, bwd_orders))
        for v, (f, b) in rasterize_api._PAIR_IMPLS.items()})
    rec = pairs[0].clone().requires_grad_()
    ch = pairs[1].clone().requires_grad_()
    maps, _ = rasterize_api._RasterizePairs.apply(rec, ch, pairs[2], pairs[3],
                                                  grid, version, True)
    maps[:8].sum().backward()
    assert len(calls) == 1
    assert len(fwd_orders) == 1 and len(bwd_orders) == 1
    assert bwd_orders[0] is calls[0] and fwd_orders[0] is calls[0]
    assert torch.equal(calls[0], real_order(pairs[2], S_MAX))
