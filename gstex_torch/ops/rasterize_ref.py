"""Per-pixel oracle renderer (plain torch, O(H·W·N): small scenes and
images only). Counterpart of ``gstex_tpu/ops/rasterize_ref.py``.

Every pixel blends over all splats in one global (depth, id) order, with
the per-pixel break of the kernels' blend loop and no binning, so it
cannot overflow. It shares with the tile renderers only the response of
one splat at one pixel (``rasterize_fwd.response`` on the splat's
record, in the kernels' arithmetic), as the JAX package's oracle shares
``surfel.intersect`` with its tile renderer: a pixel whose transmittance
reaches ``T_EPS`` at a splat breaks there in both, where two float32
forms of the response, a few ulps apart, would break on either side of
the threshold at scattered pixels. Its order, blend, chart fetch and
accumulation are its own: no binning, no cull, no per-tile lists, no
ncontrib. ``torch.autograd`` differentiates it as it stands: the referee
for the tiers' maps and gradients.
"""

from __future__ import annotations

import torch

from .camera import Camera, project_points, viewmat_from_c2w
from .rasterize_fwd import response
from .records import assemble_records, cam_info
from .surfel import SplatGeom, T_EPS


def render_oracle(geom: SplatGeom, texture: torch.Tensor,
                  texture_hw: torch.Tensor, cam: Camera,
                  extra_channels: bool = False) -> dict:
    """Render all output maps by per-pixel front-to-back blending.

    ``texture`` (N, Ch, Cw, C) dense padded charts, ``texture_hw`` (N, 2)
    active dims. Returns (H, W, ...) maps: img, texture_rgb, depth, alpha,
    normal, reg (and uv with ``extra_channels``).

    The splats are taken in chunks of K (about 4M pixel-splat pairs a
    chunk), each chunk's responses evaluated at every pixel at once. A
    pixel's transmittance runs through the chunk's splats one at a time,
    T ← T·(1 − α); the first splat whose ``T·(1 − α) <= T_EPS`` breaks
    the pixel, and neither it nor any later splat blends.
    """
    H, W = cam.height, cam.width
    dev = texture.device
    _, depths = project_points(geom.mean.detach(),
                               viewmat_from_c2w(cam.c2w), cam.intrins)
    # global front-to-back order (depth, id); splats behind the camera
    # never blend
    in_front = depths > 1e-6
    key = torch.where(in_front, depths, torch.full_like(depths, torch.inf))
    order = torch.sort(key, stable=True).indices
    order = order[in_front[order]]
    _, ch, cw, nc = texture.shape
    flat_tex = texture.reshape(-1, nc)
    records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
    # each pixel's coordinates and world ray, as the tiles form them
    # (``rasterize_fwd.pixel_grid``)
    info = cam_info(cam)
    gx = torch.arange(W, device=dev).to(torch.float32)[None, :] + info[4]
    gy = torch.arange(H, device=dev).to(torch.float32)[:, None] + info[5]
    dx = (gx + 0.5 - info[2]) / info[0]
    dy = (gy + 0.5 - info[3]) / info[1]
    dirs = [info[3 * i + 9] * dx + info[3 * i + 10] * dy + info[3 * i + 11]
            for i in range(3)]

    zeros = lambda *c: torch.zeros((H, W, *c), dtype=torch.float32,
                                   device=dev)
    acc = {"img": zeros(3), "tex": zeros(nc), "depth": zeros(),
           "alpha": zeros(), "normal": zeros(3), "reg": zeros(),
           "m1": zeros(), "uv": zeros(3)}
    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    broken = torch.zeros((H, W), dtype=torch.bool, device=dev)
    chunk = max(1, (1 << 22) // (H * W))
    for start in range(0, order.shape[0], chunk):
        idx = order[start:start + chunk]
        k = idx.shape[0]
        resp = response(records[idx][:, :, None, None], dirs, gx, gy)
        a = resp["alpha"]                                  # (K, H, W)
        uv = torch.stack([torch.clamp(resp["uvu_raw"], 0.0, 1.0),
                          torch.clamp(resp["uvv_raw"], 0.0, 1.0)], -1)
        texel = _chart_samples(flat_tex, texture_hw[idx], idx, ch, cw, uv)
        # T before each splat of the chunk, one splat at a time
        before = []
        for j in range(k):
            before.append(T)
            T = T * (1.0 - a[j])
        t_before = torch.stack(before)
        next_t = t_before * (1.0 - a)
        would = (a > 0.0) & (next_t <= T_EPS)
        would_i = would.to(torch.int32)
        broken_before = broken[None] | ((torch.cumsum(would_i, 0) - would_i)
                                        > 0)
        considered = ~broken_before & (a > 0.0)
        applied = considered & ~would
        w = torch.where(applied, a * t_before, 0.0)
        m = resp["m"]
        w3 = w[..., None]
        wm = w * m
        g = SplatGeom(*(f[idx].reshape(k, 1, 1, *f.shape[1:]) for f in geom))
        # the running alpha and m1 before each splat, for the distortion
        alpha_before = acc["alpha"][None] + torch.cumsum(w, 0) - w
        m1_before = acc["m1"][None] + torch.cumsum(wm, 0) - wm
        acc = {
            "img": acc["img"] + (w3 * g.rgb).sum(0),
            "tex": acc["tex"] + (w3 * texel).sum(0),
            "depth": acc["depth"] + (w * resp["t"]).sum(0),
            "normal": acc["normal"] + (
                w3 * g.normal * resp["flip"][..., None]).sum(0),
            "reg": acc["reg"] + (2.0 * w * (m * alpha_before
                                            - m1_before)).sum(0),
            "alpha": acc["alpha"] + w.sum(0),
            "m1": acc["m1"] + wm.sum(0),
            "uv": acc["uv"] + (w3 * torch.cat(
                [uv, torch.full_like(uv[..., :1], 0.5)], -1)).sum(0),
        }
        broken = broken | (considered & would).any(0)

    out = {"img": acc["img"], "texture_rgb": acc["tex"],
           "depth": acc["depth"], "alpha": acc["alpha"],
           "normal": acc["normal"], "reg": acc["reg"]}
    if extra_channels:
        out["uv"] = acc["uv"]
    return out


def _chart_samples(flat_tex: torch.Tensor, hw: torch.Tensor,
                   idx: torch.Tensor, ch: int, cw: int,
                   uv: torch.Tensor) -> torch.Tensor:
    """``surfel.chart_sample_bilinear`` for K charts at once: the charts
    ``idx`` (K,) of the flattened ``(N·Ch·Cw, C)`` texture, their active
    dims ``hw`` (K, 2), at ``uv`` (K, H, W, 2); returns (K, H, W, C)."""
    k = idx.shape[0]
    h = hw[:, 0].reshape(k, 1, 1)
    w = hw[:, 1].reshape(k, 1, 1)
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    x = torch.minimum(torch.clamp(uv[..., 0] * hf, min=0.0), hf - 1.0)
    y = torch.minimum(torch.clamp(uv[..., 1] * wf, min=0.0), wf - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.minimum(x0i + 1, h.long() - 1)
    y1i = torch.minimum(y0i + 1, w.long() - 1)
    row = idx.reshape(k, 1, 1) * ch

    def at(xi, yi):
        return flat_tex[(row + xi) * cw + yi]

    return ((1 - fx) * ((1 - fy) * at(x0i, y0i) + fy * at(x0i, y1i))
            + fx * ((1 - fy) * at(x1i, y0i) + fy * at(x1i, y1i)))
