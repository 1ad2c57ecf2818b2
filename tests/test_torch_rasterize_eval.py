"""The eval render's plain PyTorch version against gstex_tpu: the v5 eval
kernel in interpret mode (``rasterize_pl5_eval(..., interpret=True)``)
and the XLA tile renderer (``rasterize.rasterize``), on the same prepared
splats and the same bins. Tolerance atol 2e-5 / rtol 1e-4, the tolerance
the JAX package holds its Pallas tiers to against the XLA tier (the sums
run in another order).

The CUDA kernel itself is compared with the plain version in
``test_torch_kernels_cuda.py``, which needs a CUDA device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene, surface_scene
from gstex_torch.ops import binning as tbin
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import rasterize_bwd as rbwd
from gstex_torch.ops import rasterize_eval as treval
from gstex_torch.ops import rasterize_fwd as rfwd
from gstex_torch.ops import surfel as tsurf
from gstex_torch.ops.rasterize_api import rasterize_pl5_eval as t_pl5_eval
from gstex_torch.ops.records import assemble_records, cam_info
from gstex_tpu.ops import binning as jbin
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import prepare as jprep
from gstex_tpu.ops.rasterize import rasterize
from gstex_tpu.ops.rasterize_pallas_api import rasterize_pl5_eval

H, W = 64, 96
JGRID = jbin.TileGrid(height=H, width=W, tile_h=32, tile_w=32)
TGRID = tbin.TileGrid(height=H, width=W, tile_h=32, tile_w=32)
KEYS = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
        "features_rest", "mappings")
MAPS = ("img", "texture_rgb", "depth", "alpha")
BG = np.array([0.2, 0.5, 0.9], np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def case(kind, pad, n, s_cap, seed=0):
    """JAX-prepared splats and bins, and the same inputs for the port."""
    gen = random_scene if kind == "random" else surface_scene
    scene = {k: v.numpy() for k, v in
             gen(n, chart_pad=pad, seed=seed, device="cpu").items()}
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * max(H, W)
    jc = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    tc = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
    prep = jprep.prepare_splats(*(jnp.asarray(scene[k]) for k in KEYS), jc,
                                active_sh_degree=3)
    fbins = jbin.build_tile_bins_flat(prep.centers, prep.extents,
                                      prep.depths, prep.valid, JGRID,
                                      pair_cap=8192, s_cap=s_cap)
    tgeom = tsurf.SplatGeom(*(t(x) for x in prep.geom))
    tbins = tbin.FlatBins(*(t(x) if i < 5 else int(x)
                            for i, x in enumerate(fbins)))
    return scene, jc, tc, prep, fbins, tgeom, tbins


CASES = {
    "random_pad8": ("random", (8, 8), 200, 64),
    "random_pad4": ("random", (4, 4), 200, 64),
    "surface_early_exit": ("surface", (8, 8), 300, 256),
    "clamped_s_cap": ("random", (4, 4), 300, 16),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_eval(name):
    kind, pad, n, s_cap = CASES[name]
    scene, jc, tc, prep, fbins, tgeom, tbins = case(kind, pad, n, s_cap)
    if name == "clamped_s_cap":
        assert int(fbins.overflow) > 0
    jout = rasterize_pl5_eval(prep.geom, jnp.asarray(scene["texture"]),
                              jnp.asarray(scene["texture_hw"]), fbins, jc,
                              JGRID, s_cap=s_cap, interpret=True,
                              background=jnp.asarray(BG))
    tout = t_pl5_eval(tgeom, t(scene["texture"]), t(scene["texture_hw"]),
                      tbins, tc, TGRID, s_cap=s_cap, background=t(BG))
    for k in MAPS + ("rgb",):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    assert float(tout["alpha"].max()) > 0.3


@pytest.mark.parametrize("name", ["random_pad4", "surface_early_exit",
                                  "clamped_s_cap"])
def test_plain_matches_xla_tier(name):
    kind, pad, n, s_cap = CASES[name]
    scene, jc, tc, prep, _, tgeom, tbins = case(kind, pad, n, s_cap)
    bins = jbin.build_tile_bins(prep.centers, prep.extents, prep.depths,
                                prep.valid, JGRID, pair_cap=8192,
                                s_max=s_cap)
    jout = rasterize(prep.geom, jnp.asarray(scene["texture"]),
                     jnp.asarray(scene["texture_hw"]), bins, jc, JGRID)
    tout = t_pl5_eval(tgeom, t(scene["texture"]), t(scene["texture_hw"]),
                      tbins, tc, TGRID, s_cap=s_cap)
    for k in MAPS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def _kernel_inputs(s_cap=256):
    scene, _, tc, _, _, tgeom, tbins = case("surface", (8, 8), 300, s_cap)
    records = assemble_records(tgeom, tc.c2w[:3, 3], t(scene["texture_hw"]))
    return (records, tbins.gids, tbins.starts, tbins.counts,
            t(scene["texture"]), cam_info(tc))


def test_walk_stops_early():
    """On an opaque surface the walk ends before the tiles' lists do."""
    inputs = _kernel_inputs()
    _, stats = treval.rasterize_eval_reference(*inputs, TGRID, 256)
    n = torch.clamp(inputs[3].long(), max=256)
    walked = stats.walked
    assert bool((walked <= n).all()) and int(walked.sum()) < int(n.sum())
    # every blend is a response, and the early exit skips responses
    assert 0 < int(stats.blended) <= int(stats.evaluated)
    assert int(stats.evaluated) < int(walked.sum()) * 32 * 32


def test_wrapper_checks_inputs():
    records, gids, starts, counts, charts, info = _kernel_inputs()
    with pytest.raises(TypeError):
        treval.rasterize_eval(records.double(), gids, starts, counts, charts,
                              info, TGRID, 256)
    with pytest.raises(ValueError):
        treval.rasterize_eval(records, gids, starts[:-1], counts, charts,
                              info, TGRID, 256)
    with pytest.raises(ValueError):
        treval.rasterize_eval(records, gids, starts, counts,
                              charts.transpose(1, 2), info, TGRID, 256)


def test_training_wrappers_check_alignment_and_order():
    """The flat training kernels copy records 16 B at a time (cp.async), so
    a contiguous view at an offset that is not a multiple of 16 B is
    refused, as is a tile order of the wrong type or length."""
    records, gids, starts, counts, charts, info = _kernel_inputs()
    buf = torch.empty(records.numel() + 1)
    shifted = buf[1:].view(records.shape)
    shifted.copy_(records)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    maps = torch.zeros((rfwd.NCH, H, W))
    ncon = torch.zeros((H, W), dtype=torch.int32)
    gmaps = torch.zeros((rfwd.NG, H, W))
    with pytest.raises(ValueError, match="aligned"):
        rfwd.rasterize_fwd(shifted, gids, starts, counts, charts, info,
                           TGRID, 256)
    with pytest.raises(ValueError, match="aligned"):
        rbwd.rasterize_bwd(shifted, gids, starts, counts, charts, info, maps,
                           ncon, gmaps, TGRID, 256)
    order = rfwd.tile_order(counts, 256)
    with pytest.raises(TypeError):
        rfwd.rasterize_fwd(records, gids, starts, counts, charts, info,
                           TGRID, 256, order=order.long())
    with pytest.raises(ValueError):
        rbwd.rasterize_bwd(records, gids, starts, counts, charts, info, maps,
                           ncon, gmaps, TGRID, 256, order=order[:-1])


def test_tile_order_is_longest_first():
    """Blocks take the tiles by capped count, longest first: a permutation
    of the tiles."""
    counts = torch.tensor([3, 900, 0, 40, 700, 40], dtype=torch.int32)
    order = rfwd.tile_order(counts, 256)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(6))
    capped = torch.clamp(counts, max=256)[order.long()]
    assert bool((capped[:-1] >= capped[1:]).all())
    assert set(order[:2].tolist()) == {1, 4}


def test_cpu_calls_do_not_count_launches():
    before = treval.rasterize_eval.launches
    out = treval.rasterize_eval(*_kernel_inputs(), TGRID, 256)
    assert out.shape == (8, H, W)
    assert treval.rasterize_eval.launches == before

