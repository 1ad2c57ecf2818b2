"""The tile orders and record alignment that the flat eval kernel and the
dense training kernels take, checked by their wrappers on the CPU.

These kernels copy records 16 B at a time (cp.async) and take their tiles
longest first, in an order computed once a frame (``rasterize_pl5_eval``)
or once a training step (``_Rasterize4``, in its forward, for the dense
forward and backward both). The wrappers refuse misaligned records and
orders of the wrong type or length before they dispatch, so the CPU path
checks what the card path would launch. The kernels themselves run only
on the card (``test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from gstex_torch.data.synthetic import orbit_camera, surface_scene
from gstex_torch.ops import rasterize_api
from gstex_torch.ops import rasterize_dense as rdense
from gstex_torch.ops import rasterize_eval as reval
from gstex_torch.ops import rasterize_fwd as rfwd
from gstex_torch.ops.binning import (TileGrid, build_tile_bins,
                                     build_tile_bins_flat)
from gstex_torch.ops.cull import make_pair_cull
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_torch.ops.sh import sh_to_rgb

H, W = 48, 64
S_MAX = 24


def inputs(dense, s_max=S_MAX, n=300):
    """A small surface scene's kernel inputs on the CPU: (records, ids,
    counts, charts, info) or (records, gids, starts, counts, charts,
    info); the grid; the bins."""
    s = surface_scene(n, chart_pad=(4, 6), seed=2, device="cpu")
    cam = orbit_camera(H, W, dist=3.0, azimuth=0.4, device="cpu")
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    grid = TileGrid(height=H, width=W, tile_h=16, tile_w=16)
    build = build_tile_bins if dense else build_tile_bins_flat
    bins = build(prep.centers, prep.extents, prep.depths, prep.valid, grid,
                 1 << 14, s_max, cull_fn=make_pair_cull(prep.geom, cam, grid))
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
    # the dense eval kernel stages records with plain loads
    out = rdense.rasterize_dense_eval(misaligned(records), ids, counts,
                                      charts, info, grid)
    assert out.shape == (8, H, W)


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
    s = surface_scene(300, chart_pad=(4, 6), seed=2, device="cpu")
    cam = orbit_camera(H, W, dist=3.0, azimuth=0.4, device="cpu")
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    grid = TileGrid(height=H, width=W, tile_h=16, tile_w=16)
    fbins = build_tile_bins_flat(prep.centers, prep.extents, prep.depths,
                                 prep.valid, grid, 1 << 14, S_MAX,
                                 cull_fn=make_pair_cull(prep.geom, cam, grid))
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
