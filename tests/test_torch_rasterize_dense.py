"""The dense-list render API: gstex_torch ``rasterize_pl_eval`` and
``rasterize_pl`` (on CPU tensors: the plain versions of the dense-list
kernels) against gstex_tpu, maps and gradients of all seven param leaves,
lean and full, with a truncating ``s_max``, a multi-block chart pad and
16x16 tiles.

As the JAX package's own tests do (``tests/test_pallas.py``), the
reference throughout is its XLA tier ``rasterize``, which its v4 kernels
are held to; the v4 kernels themselves run in interpret mode in two small
cases only (each costs tens of seconds on the CPU). Tolerances are that
file's: atol 2e-5 / rtol 1e-4 on the maps, atol 3e-4 on gradients scaled
by the reference's max abs. One exception, stated at ``MAP_ATOL``: the
tall-chart case.
"""

import numpy as np
import pytest
import torch

import test_torch_rasterize_xla as xla
from gstex_torch.ops import rasterize_dense as rdense
from gstex_torch.ops.rasterize_api import (dense_pallas_fits, rasterize_pl,
                                           rasterize_pl_eval, use_flat_path)
from gstex_tpu.ops.rasterize_pallas_api import rasterize_pl as jrasterize_pl
from gstex_tpu.ops.rasterize_pallas_api import (
    rasterize_pl_eval as jrasterize_pl_eval)

EVAL_MAPS = ("img", "texture_rgb", "depth", "alpha")
# (tile, s_max, chart pad, surfels)
CASES = {"tile32": (32, 64, (4, 4), 48), "tile16": (16, 64, (4, 4), 48),
         "truncating": (32, 16, (4, 4), 96), "pad48x24": (32, 64, (48, 24), 32)}


# Charts of up to 48 rows scale a rounding difference in uv (records here,
# geom fields in the JAX XLA tier) by 48 texels of N(0, 0.3) values: on
# this scene JAX's own v4 (interpret) and XLA tiers differ by 4.2e-5 in
# texture_rgb, the port and JAX v4 by 3.0e-5. Its maps are held to 1e-4.
MAP_ATOL = {"pad48x24": 1e-4}


def scene_np(pad, n):
    s = xla.scene_np(n=n, pad=pad)
    if pad == (48, 24):
        # charts taller than 41 rows, as the JAX multi-block test draws them
        rng = np.random.default_rng(5)
        s["texture"] = (0.3 * rng.standard_normal((n, *pad, 3))
                        ).astype(np.float32)
        s["texture_hw"] = np.stack([rng.integers(41, pad[0] + 1, n),
                                    rng.integers(1, pad[1] + 1, n)],
                                   -1).astype(np.int32)
    return s


def port(lean=False, eval_only=False):
    def render(geom, texture, hw, bins, cam, grid, extra_channels=False):
        if eval_only:
            return rasterize_pl_eval(geom, texture, hw, bins, cam, grid)
        return rasterize_pl(geom, texture, hw, bins, cam, grid, lean=lean)
    return render


def jax_v4(eval_only=False):
    def render(geom, texture, hw, bins, cam, grid, extra_channels=False):
        fn = jrasterize_pl_eval if eval_only else jrasterize_pl
        return fn(geom, texture, hw, bins, cam, grid, interpret=True)
    return render


@pytest.fixture(scope="module")
def results():
    """Each (case, lean) runs once through both packages; lean has no
    cotangent on the maps it leaves out."""
    cache = {}

    def get(name, lean):
        if (name, lean) not in cache:
            tile, s_max, pad, n = CASES[name]
            s = scene_np(pad, n)
            cot = xla.cotangents_np(EVAL_MAPS if lean else xla.MAPS)
            cache[name, lean] = (
                xla.jax_run(s, tile, s_max, cot),
                xla.torch_run(s, tile, s_max, cot, render=port(lean)))
        return cache[name, lean]

    return get


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_training_maps_match_jax(results, case, lean):
    (want, _, want_ovf), (got, _, got_ovf) = results(case, lean)
    assert got_ovf == want_ovf and (got_ovf > 0) == (case == "truncating")
    xla.assert_maps_close(got, want, keys=EVAL_MAPS if lean else xla.MAPS,
                          atol=MAP_ATOL.get(case, 2e-5))
    assert got["alpha"].max() > 0.3
    if lean:
        assert np.abs(got["normal"]).max() == 0 == np.abs(got["reg"]).max()
    if case == "pad48x24":
        assert np.abs(got["texture_rgb"]).max() > 0.01


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(results, case, lean):
    (_, want, _), (_, got, _) = results(case, lean)
    xla.assert_grads_close(got, want)
    assert np.abs(got["texture"]).max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_eval_maps_match_jax(results, case):
    tile, s_max, pad, n = CASES[case]
    (want, _, _), _ = results(case, False)
    got, _, _ = xla.torch_run(scene_np(pad, n), tile, s_max, {},
                              render=port(eval_only=True))
    assert set(got) == set(EVAL_MAPS)
    xla.assert_maps_close(got, want, keys=EVAL_MAPS,
                          atol=MAP_ATOL.get(case, 2e-5))


def test_eval_matches_jax_v4_interpret():
    """The eval entry point against the TPU kernel itself, interpreted."""
    tile, s_max, pad, n = CASES["tile32"]
    s = scene_np(pad, n)
    want, _, _ = xla.jax_run(s, tile, s_max, {}, render=jax_v4(True))
    got, _, _ = xla.torch_run(s, tile, s_max, {}, render=port(eval_only=True))
    xla.assert_maps_close(got, want, keys=EVAL_MAPS)


def test_training_matches_jax_v4_interpret():
    """Forward and gradients against the TPU kernels themselves,
    interpreted, on lists that truncate."""
    tile, s_max, pad, n = CASES["truncating"]
    s = scene_np(pad, n)
    cot = xla.cotangents_np(xla.MAPS)
    want, want_grads, want_ovf = xla.jax_run(s, tile, s_max, cot,
                                             render=jax_v4())
    got, got_grads, got_ovf = xla.torch_run(s, tile, s_max, cot,
                                            render=port())
    assert got_ovf == want_ovf > 0
    xla.assert_maps_close(got, want)
    xla.assert_grads_close(got_grads, want_grads)


def test_rgb_composite_and_unported_versions():
    tile, s_max, pad, n = CASES["tile32"]
    s = scene_np(pad, n)
    bg = torch.tensor([0.1, 0.3, 0.6])

    def with_bg(geom, texture, hw, bins, cam, grid, extra_channels=False):
        return rasterize_pl(geom, texture, hw, bins, cam, grid, background=bg)

    got, _, _ = xla.torch_run(s, tile, s_max, {}, render=with_bg)
    rgb = got["img"] + got["texture_rgb"] + (1 - got["alpha"][..., None]
                                             ) * bg.numpy()
    np.testing.assert_allclose(got["rgb"], np.clip(rgb, 0, 1), atol=1e-6)

    def version(v):
        def render(geom, texture, hw, bins, cam, grid, extra_channels=False):
            return rasterize_pl(geom, texture, hw, bins, cam, grid,
                                version=v)
        return render
    # v1, ported since, renders v2's maps but for the distortion depth's
    # rounding (reg); a version the JAX package has no kernel for raises
    v1, _, _ = xla.torch_run(s, tile, s_max, {}, render=version(1))
    v2, _, _ = xla.torch_run(s, tile, s_max, {}, render=version(2))
    for k in ("img", "texture_rgb", "depth", "alpha", "normal"):
        np.testing.assert_array_equal(v1[k], v2[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown kernel version"):
        xla.torch_run(s, tile, s_max, {}, render=version(5))


@pytest.mark.parametrize("pad,flat", [((8, 8), True), ((40, 80), True),
                                      ((80, 88), True), ((88, 88), False),
                                      ((64, 128), False),
                                      ((128, 128), False)])
def test_dispatch_rule(pad, flat):
    """Flat where the dispatch rule (the first flat backward's shared
    memory) keeps the pad at 32x32 tiles, dense above; ``pallas4`` is always dense; the dense kernels take
    every pad."""
    for renderer in ("pallas", "pallas5", "pallas_interpret"):
        assert use_flat_path(renderer, pad, 32 * 32) == flat
    for renderer in ("pallas4", "pallas4_interpret", "xla", "oracle"):
        assert not use_flat_path(renderer, pad, 32 * 32)
    assert use_flat_path("pallas", pad, 16 * 16) == (pad != (128, 128))
    assert dense_pallas_fits(pad, 4096)


def test_tiers_agree_at_exact_texel_ties():
    """Where a sample sits exactly on a texel row or column, or exactly on
    the last texel, the fetch's derivative is a matter of convention. The
    plain versions of every tier (the flat one written out by hand, the
    dense one pulled back by autograd, the pair-space v3 and v2 ones) take
    the TPU kernels': two-sided at a tie, passed at the bounds. Every
    splat here samples its 8 x 8 chart at x = 2.0 and y = 7.0 in every
    pixel."""
    from gstex_torch.ops import rasterize as plain
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_v2 as rv2
    from gstex_torch.ops import rasterize_v3 as rv3
    from gstex_torch.ops.binning import (TileGrid, build_tile_bins,
                                         build_tile_bins_flat)
    from gstex_torch.ops.pair_inputs import pair_inputs
    from gstex_torch.ops.prepare import prepare_splats
    from gstex_torch.ops.records import assemble_records, cam_info

    s = {k: torch.tensor(v) for k, v in xla.scene_np(n=24, pad=(8, 8)).items()}
    f = 1.2 * max(xla.H, xla.W)
    cam = xla.tcam.make_camera(f, f, xla.W / 2, xla.H / 2, xla.H, xla.W,
                               xla.c2w(), device="cpu")
    grid = TileGrid(height=xla.H, width=xla.W, tile_h=32, tile_w=32)
    prep = prepare_splats(s["means"], s["log_scales"], s["quats"],
                          s["opacity_logits"], s["features_dc"],
                          s["features_rest"], s["mappings"], cam,
                          active_sh_degree=3)
    hw = torch.full((24, 2), 8, dtype=torch.int32)
    records = assemble_records(prep.geom, cam.c2w[:3, 3], hw)
    records[:, 12:20] = 0.0
    records[:, 15] = -0.25     # uvu_raw = 0.25: x = 2.0, an interior tie
    records[:, 19] = 0.375     # uvv_raw = 0.875: y = 7.0, the last texel
    args = (prep.centers, prep.extents, prep.depths, prep.valid, grid, 8192,
            64)
    dense, flat = build_tile_bins(*args), build_tile_bins_flat(*args)
    info = cam_info(cam)
    charts = s["texture"].contiguous()
    maps, ncon = plain.forward_scan(records, dense.ids, dense.counts, charts,
                                    info, grid)
    g = torch.tensor(np.random.default_rng(1).standard_normal(
        (12, xla.H, xla.W)).astype(np.float32))
    d_rec, d_ch = plain.backward_walk(records, dense.ids, dense.counts,
                                      charts, info, maps, ncon, g, grid)
    f_rec, f_ch = rbwd.rasterize_bwd_reference(
        records, flat.gids, flat.starts, flat.counts, charts, info, maps,
        ncon, g, grid, 64)
    assert float(f_rec[:, [15, 19]].abs().max(0).values.min()) > 0.1
    # the pair-space tiers' plain backwards on the same lists, their
    # gradients summed per gaussian
    pairs = pair_inputs(records, charts, dense)
    ids = dense.ids.reshape(-1).long()
    tiers = {"dense": (d_rec, d_ch)}
    for name, bwd in (("v3", rv3.rasterize_v3_bwd_reference),
                      ("v2", rv2.rasterize_v2_bwd_reference)):
        p_rec, p_ch = bwd(*pairs, info, maps, ncon, g, grid)
        tiers[name] = (
            torch.zeros_like(records).index_add_(
                0, ids, p_rec.reshape(ids.numel(), -1)),
            torch.zeros_like(charts).index_add_(
                0, ids, p_ch.reshape(ids.numel(), *charts.shape[1:])))
    for name, (t_rec, t_ch) in tiers.items():
        for group in ([15], [19], [0, 1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11],
                      [20, 21, 22, 23, 24, 25]):
            scale = float(f_rec[:, group].abs().max())
            torch.testing.assert_close(t_rec[:, group] / scale,
                                       f_rec[:, group] / scale, atol=1e-5,
                                       rtol=0, msg=f"{name} {group}")
        torch.testing.assert_close(t_ch / float(f_ch.abs().max()),
                                   f_ch / float(f_ch.abs().max()), atol=1e-5,
                                   rtol=0, msg=name)


def test_wrappers_check_their_inputs():
    from gstex_torch.ops.binning import TileGrid

    grid = TileGrid(height=32, width=32, tile_h=32, tile_w=32)
    records = torch.zeros((3, 32))
    ids = torch.zeros((1, 8), dtype=torch.int32)
    counts = torch.zeros(1, dtype=torch.int32)
    charts = torch.zeros((3, 4, 4, 3))
    info = torch.zeros(18)
    out = rdense.rasterize_dense_eval(records, ids, counts, charts, info, grid)
    assert out.shape == (8, 32, 32) and float(out.abs().max()) == 0
    assert rdense.rasterize_dense_eval.launches == 0   # CPU calls do not count
    with pytest.raises(TypeError, match="ids"):
        rdense.rasterize_dense_eval(records, ids.long(), counts, charts,
                                    info, grid)
    with pytest.raises(ValueError, match="ids"):
        rdense.rasterize_dense_fwd(records, ids.reshape(-1), counts, charts,
                                   info, grid)
    with pytest.raises(ValueError, match="charts"):
        rdense.rasterize_dense_fwd(records, ids, counts, charts[:2], info,
                                   grid)
    maps, ncon = rdense.rasterize_dense_fwd(records, ids, counts, charts,
                                            info, grid)
    assert int(ncon.min()) == 8        # s_max where no walk broke
    with pytest.raises(ValueError, match="gmaps"):
        rdense.rasterize_dense_bwd(records, ids, counts, charts, info, maps,
                                   ncon, torch.zeros((14, 32, 32)), grid)
