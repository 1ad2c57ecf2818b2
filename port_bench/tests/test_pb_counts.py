"""The work the rooflines count (``gstex_ref.view_counts``) against a
brute-force count: every pixel walks every surfel in depth order, with
the ray-plane hit written directly (not as the reference's affine
coefficients) in float64."""

from __future__ import annotations

import math

import torch

from port_bench import scene
from port_bench.reference import gstex_ref as ref
from port_bench.tests.tiny import SMALL

import json
from port_bench.tests.tiny import PB


def brute_force(params, buffers, view, step, st):
    d = lambda t: t.detach().to(torch.float64)
    campos, ex, ey, ez = (d(t) for t in ref.camera_frame(view))
    rot = d(ref.rotation(params["quats"]))
    scale = d(torch.exp(params["log_scales"]))
    op = d(torch.sigmoid(params["opacity_logits"].reshape(-1)))
    means = d(params["means"])
    hw = buffers["texture_hw"].long()
    maps = d(buffers["mappings"])
    ch, cw = params["texture"].shape[1:3]
    h, w = view.height, view.width
    iy, ix = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    dirs = (((ix + 0.5 - view.cx) / view.fx)[..., None] * ex
            + ((iy + 0.5 - view.cy) / view.fy)[..., None] * ey + ez)
    depth = (means - campos) @ ez
    T = torch.ones(h, w, dtype=torch.float64)
    done = torch.zeros(h, w, dtype=torch.bool)
    blends, surfels, texels = 0, set(), set()
    for g in torch.argsort(depth.float(), stable=True).tolist():
        if depth[g] <= 1e-6:
            continue
        n, a1, a2 = rot[g, :, 2], rot[g, :, 0], rot[g, :, 1]
        om = campos - means[g]
        dn = dirs @ n
        t = -(om @ n) / dn
        hit = om + t[..., None] * dirs
        u, v = hit @ a1 / scale[g, 0], hit @ a2 / scale[g, 1]
        r2 = u * u + v * v
        gs = torch.where(r2 <= 9, torch.exp(-0.5 * r2), 0.0)
        cx, cy = (means[g] - campos) @ ex, (means[g] - campos) @ ey
        px = view.fx * cx / depth[g] + view.cx - 0.5
        py = view.fy * cy / depth[g] + view.cy - 0.5
        gl = torch.exp(-((ix - px) ** 2 + (iy - py) ** 2))
        alpha = torch.clamp(op[g] * torch.maximum(gs, gl), max=0.999)
        live = (alpha >= 1 / 255) & (t > 1e-6) & ~done
        stop = live & (T * (1 - alpha) <= 1e-4)
        done |= stop
        applied = live & ~stop
        if not applied.any():
            continue
        blends += int(applied.sum())
        surfels.add(g)
        T = torch.where(applied, T * (1 - alpha), T)
        uu = (0.5 + maps[g, 0] * (hit @ a1)).clamp(0, 1)[applied]
        vv = (0.5 + maps[g, 1] * (hit @ a2)).clamp(0, 1)[applied]
        hh, ww = float(hw[g, 0]), float(hw[g, 1])
        x = torch.minimum((uu * hh).clamp(min=0), torch.tensor(hh - 1))
        y = torch.minimum((vv * ww).clamp(min=0), torch.tensor(ww - 1))
        x0, y0 = x.floor(), y.floor()
        x1 = torch.minimum(x0 + 1, torch.tensor(hh - 1))
        y1 = torch.minimum(y0 + 1, torch.tensor(ww - 1))
        for xs, ys in ((x0, y0), (x0, y1), (x1, y0), (x1, y1)):
            texels.update((g * ch * cw + xs.long() * cw + ys.long()).tolist())
    return {"blends": blends, "surfels": len(surfels), "texels": len(texels)}


def test_counts_against_brute_force():
    with open(PB / "configs" / "blender-nvs.json") as f:
        cfg = dict(json.load(f), **SMALL)
    geo = scene.surfels(cfg, "cpu")
    cols = scene.colours(cfg, cfg["surfels"], (24, 24), 9, 1, "cpu")
    params = dict(geo, **cols)
    st = scene.settings(cfg)
    buffers = ref.initial_buffers(params, st)
    for view in scene.views(cfg, "cpu")[:2]:
        got = ref.view_counts(params, buffers, view, 3000, st)
        want = brute_force(params, buffers, view, 3000, st)
        assert got["surfels"] == want["surfels"]
        # float32 against float64: a pair at a threshold may fall either side
        for k in ("blends", "texels"):
            assert math.isclose(got[k], want[k], rel_tol=2e-3), (k, got, want)
        assert want["blends"] > 1000
