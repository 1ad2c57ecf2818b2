"""The training render: gstex_torch ``rasterize_pl5`` (the plain versions
of the forward and backward kernels, as any CPU tensor runs them) against
gstex_tpu ``rasterize_pl5(..., interpret=True)`` on the same numpy scene,
for the six maps and the gradients of all seven param leaves under random
cotangents, lean and full; a truncating case at a size with edge tiles;
the hand-derived backward against ``torch.autograd`` through the plain
forward; and the detached uv frame of the records.

Tolerances are the JAX package's own (``tests/test_pallas.py``): atol
2e-5 / rtol 1e-4 on the maps, atol 3e-4 on gradients scaled by the
reference's max abs. The JAX interpret runs are the slow part, so each
one runs once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import rasterize_bwd as rbwd
from gstex_torch.ops import rasterize_fwd as rfwd
from gstex_torch.ops import records as trecords
from gstex_torch.ops.binning import TileGrid, build_tile_bins_flat
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.rasterize_api import rasterize_pl5
from gstex_torch.ops.surfel import reg_depth_map
from gstex_tpu.ops import binning as jbinning
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops.prepare import prepare_splats as jprepare
from gstex_tpu.ops.rasterize_pallas_api import rasterize_pl5 as jrasterize

PAD = (4, 4)
MAPS = ("img", "texture_rgb", "depth", "alpha", "normal", "reg")
LEAVES = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
          "features_rest", "texture")
# (height, width, s_cap): the main case, and a truncating one whose edge
# tiles hold pixels outside the image
MAIN = (64, 96, 64)
TRUNC = (56, 88, 16)


def scene_np(n=48, seed=3):
    return {k: v.numpy() for k, v in
            random_scene(n, chart_pad=PAD, seed=seed, device="cpu").items()}


def cotangents_np(h, w, seed=9):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"img": f(h, w, 3), "texture_rgb": f(h, w, 3),
            "depth": 0.1 * f(h, w), "alpha": f(h, w),
            "normal": 0.1 * f(h, w, 3), "reg": 0.1 * f(h, w)}


def c2w():
    return orbit_c2w(3.0, 0.3)


def jax_run(s, h, w, s_cap, lean):
    """JAX maps and leaf gradients of sum(maps · cotangents)."""
    f = 1.2 * max(h, w)
    cam = jcam.make_camera(f, f, w / 2, h / 2, h, w, c2w())
    grid = jbinning.TileGrid(height=h, width=w, tile_h=32, tile_w=32)
    cot = cotangents_np(h, w)

    def loss(d):
        p = jprepare(d["means"], d["log_scales"], d["quats"],
                     d["opacity_logits"], d["features_dc"],
                     d["features_rest"], jnp.asarray(s["mappings"]), cam,
                     active_sh_degree=3)
        fb = jbinning.build_tile_bins_flat(p.centers, p.extents, p.depths,
                                           p.valid, grid, pair_cap=8192,
                                           s_cap=s_cap)
        out = jrasterize(p.geom, d["texture"], jnp.asarray(s["texture_hw"]),
                         fb, cam, grid, s_cap=s_cap, interpret=True,
                         lean=lean)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), (out,
                                                            fb.overflow)

    (_, (out, overflow)), grads = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(s[k]) for k in LEAVES})
    return ({k: np.asarray(out[k]) for k in MAPS},
            {k: np.asarray(grads[k]) for k in LEAVES}, int(overflow))


def torch_run(s, h, w, s_cap, lean):
    """The port's maps and leaf gradients, same inputs."""
    f = 1.2 * max(h, w)
    cam = tcam.make_camera(f, f, w / 2, h / 2, h, w, c2w(), device="cpu")
    grid = TileGrid(height=h, width=w, tile_h=32, tile_w=32)
    leaves = {k: torch.tensor(s[k], requires_grad=True) for k in LEAVES}
    p = prepare_splats(leaves["means"], leaves["log_scales"],
                       leaves["quats"], leaves["opacity_logits"],
                       leaves["features_dc"], leaves["features_rest"],
                       torch.tensor(s["mappings"]), cam, active_sh_degree=3)
    fb = build_tile_bins_flat(p.centers.detach(), p.extents.detach(),
                              p.depths.detach(), p.valid, grid,
                              pair_cap=8192, s_cap=s_cap)
    out = rasterize_pl5(p.geom, leaves["texture"],
                        torch.tensor(s["texture_hw"]), fb, cam, grid,
                        s_cap=s_cap, lean=lean)
    cot = cotangents_np(h, w)
    sum(torch.sum(out[k] * torch.tensor(cot[k])) for k in cot).backward()
    grads = {k: (leaves[k].grad.numpy() if leaves[k].grad is not None
                 else np.zeros_like(s[k])) for k in LEAVES}
    return {k: out[k].detach().numpy() for k in MAPS}, grads, fb.overflow


@pytest.fixture(scope="module")
def jax_results():
    s = scene_np()
    return {lean: jax_run(s, *MAIN, lean) for lean in (True, False)}


def assert_grads_close(got, want):
    for k in LEAVES:
        scale = np.abs(want[k]).max() + 1e-8
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=3e-4, err_msg=f"grad {k}")


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_forward_matches_jax(jax_results, lean):
    want, _, _ = jax_results[lean]
    got, _, overflow = torch_run(scene_np(), *MAIN, lean)
    assert overflow == 0
    for k in MAPS:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)
    assert got["alpha"].max() > 0.3
    if lean:
        assert np.abs(got["normal"]).max() == 0 and np.abs(
            got["reg"]).max() == 0
    else:
        assert np.abs(got["reg"]).max() > 0


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_gradients_match_jax(jax_results, lean):
    _, want, _ = jax_results[lean]
    _, got, _ = torch_run(scene_np(), *MAIN, lean)
    assert_grads_close(got, want)
    assert np.abs(got["texture"]).max() > 0


def test_truncation_matches_jax():
    """s_cap clamps the tiles' walks (overflow > 0) and the edge tiles
    hold out-of-image pixels, which the port does not walk: maps and
    gradients still match."""
    s = scene_np(n=96, seed=5)
    want_maps, want_grads, want_ovf = jax_run(s, *TRUNC, False)
    got_maps, got_grads, got_ovf = torch_run(s, *TRUNC, False)
    assert got_ovf > 0 and got_ovf == want_ovf
    for k in MAPS:
        np.testing.assert_allclose(got_maps[k], want_maps[k], atol=2e-5,
                                   rtol=1e-4, err_msg=k)
    assert_grads_close(got_grads, want_grads)


def _undetached_build_records(geom, origin):
    om = origin - geom.mean
    b1 = geom.ax1 / geom.l0[:, None]
    b2 = geom.ax2 / geom.l1[:, None]
    b1u = geom.uv_scale[:, 0:1] * geom.ax1
    b2u = geom.uv_scale[:, 1:2] * geom.ax2
    dot = lambda a, b: (a * b).sum(-1, keepdim=True)
    return torch.cat([geom.normal, -dot(om, geom.normal), b1, dot(om, b1),
                      b2, dot(om, b2), b1u, dot(om, b1u), b2u, dot(om, b2u),
                      geom.opacity[:, None], geom.rgb, geom.xy], dim=-1)


def test_uv_frame_is_detached(jax_results, monkeypatch):
    """The chart uv frame (record fields 12-19) is detached, as in the JAX
    package: with it attached, the rotations would get gradient terms
    through fields 15 and 19 that the reference does not have. (The
    means' gradient is the same either way: fields 15 and 19 reach them
    through o − μ, which is attached in both packages.)"""
    _, want, _ = jax_results[False]
    scale = np.abs(want["quats"]).max()
    _, got, _ = torch_run(scene_np(), *MAIN, False)
    np.testing.assert_allclose(got["quats"] / scale, want["quats"] / scale,
                               atol=3e-4)
    monkeypatch.setattr(trecords, "build_records", _undetached_build_records)
    _, bad, _ = torch_run(scene_np(), *MAIN, False)
    assert np.abs(bad["quats"] - want["quats"]).max() / scale > 3e-3
    np.testing.assert_allclose(bad["means"], got["means"], rtol=1e-5,
                               atol=1e-6 * np.abs(got["means"]).max())


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_backward_matches_autograd(lean):
    """The hand-derived back-to-front walk against torch.autograd through
    the plain forward, on records and charts: an independent check of
    the recovery T_k = T_{k+1} / (1 − α_k) and of the chain rule."""
    h, w, s_cap = MAIN
    s = scene_np()
    f = 1.2 * max(h, w)
    cam = tcam.make_camera(f, f, w / 2, h / 2, h, w, c2w(), device="cpu")
    grid = TileGrid(height=h, width=w, tile_h=32, tile_w=32)
    t = {k: torch.tensor(v) for k, v in s.items()}
    p = prepare_splats(t["means"], t["log_scales"], t["quats"],
                       t["opacity_logits"], t["features_dc"],
                       t["features_rest"], t["mappings"], cam,
                       active_sh_degree=3)
    fb = build_tile_bins_flat(p.centers, p.extents, p.depths, p.valid, grid,
                              pair_cap=8192, s_cap=s_cap)
    records = trecords.assemble_records(p.geom, cam.c2w[:3, 3],
                                        t["texture_hw"]).requires_grad_(True)
    charts = t["texture"].clone().requires_grad_(True)
    info = trecords.cam_info(cam)
    args = (fb.gids, fb.starts, fb.counts)
    g = torch.tensor(np.stack(
        [*cotangents_np(h, w)["img"].transpose(2, 0, 1),
         *cotangents_np(h, w, seed=4)["img"].transpose(2, 0, 1),
         0.1 * cotangents_np(h, w, seed=5)["depth"],
         cotangents_np(h, w, seed=6)["alpha"],
         *(0.1 * cotangents_np(h, w, seed=7)["normal"]).transpose(2, 0, 1),
         0.1 * cotangents_np(h, w, seed=8)["reg"]]))
    if lean:
        g[8:12] = 0
    maps, ncon = rfwd.rasterize_fwd_reference(records, *args, charts, info,
                                              grid, s_cap, lean=lean)
    want_rec, want_ch = torch.autograd.grad((maps[:12] * g).sum(),
                                            (records, charts))
    got_rec, got_ch = rbwd.rasterize_bwd_reference(
        records.detach(), *args, charts.detach(), info, maps.detach(), ncon,
        g, grid, s_cap, lean=lean)
    fields = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 15, 19, 20, 21, 22, 23,
              24, 25]
    for f_ in fields:
        scale = float(want_rec[:, f_].abs().max()) + 1e-8
        torch.testing.assert_close(got_rec[:, f_] / scale,
                                   want_rec[:, f_] / scale, atol=1e-4,
                                   rtol=0, msg=f"record field {f_}")
    scale = float(want_ch.abs().max())
    torch.testing.assert_close(got_ch / scale, want_ch / scale, atol=1e-4,
                               rtol=0)
    assert float(got_rec[:, [12, 13, 14, 16, 17, 18]].abs().max()) == 0.0


def test_depth_map_matches_kernel_form():
    """``response``'s m (1/t written as n·d / a_n) is the distortion depth
    map ``reg_depth_map(t)``."""
    rng = np.random.default_rng(0)
    r = torch.tensor(rng.standard_normal((64, 32, 1)).astype(np.float32))
    r[:, 3] = torch.tensor(rng.uniform(0.05, 8.0, (64, 1)), dtype=torch.float32)
    dirs = [torch.tensor(rng.standard_normal((64, 1)).astype(np.float32))
            for _ in range(3)]
    resp = rfwd.response(r, dirs, torch.zeros(64, 1), torch.zeros(64, 1))
    keep = resp["t"] > 0
    torch.testing.assert_close(resp["m"][keep], reg_depth_map(resp["t"])[keep],
                               atol=1e-5, rtol=1e-5)
