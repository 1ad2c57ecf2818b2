"""Per-pixel oracle renderer (plain torch, O(H·W·N): tiny scenes only).
Counterpart of ``gstex_tpu/ops/rasterize_ref.py``.

Every pixel blends over all splats in one global (depth, id) order, with
the per-pixel break of the kernels' blend loop and no binning, so it
cannot overflow. It shares no code with the tile renderers beyond
``surfel.intersect`` and ``surfel.chart_sample_bilinear``, and
``torch.autograd`` differentiates it as it stands: the independent referee
for their maps and gradients.
"""

from __future__ import annotations

import torch

from . import surfel
from .camera import (Camera, camera_origin, pixel_ray_dirs, project_points,
                     viewmat_from_c2w)
from .surfel import SplatGeom, T_EPS


def render_oracle(geom: SplatGeom, texture: torch.Tensor,
                  texture_hw: torch.Tensor, cam: Camera,
                  extra_channels: bool = False) -> dict:
    """Render all output maps by per-pixel front-to-back blending.

    ``texture`` (N, Ch, Cw, C) dense padded charts, ``texture_hw`` (N, 2)
    active dims. Returns (H, W, ...) maps: img, texture_rgb, depth, alpha,
    normal, reg (and uv with ``extra_channels``).
    """
    H, W = cam.height, cam.width
    dev = texture.device
    origin = camera_origin(cam.c2w)
    _, depths = project_points(geom.mean.detach(),
                               viewmat_from_c2w(cam.c2w), cam.intrins)
    # global front-to-back order (depth, id); splats behind the camera
    # never blend
    in_front = depths > 1e-6
    key = torch.where(in_front, depths, torch.full_like(depths, torch.inf))
    order = torch.sort(key, stable=True).indices
    order = order[in_front[order]].tolist()
    hw = texture_hw.tolist()

    px_y, px_x = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    px = torch.stack([px_x, px_y], dim=-1)
    dirs = pixel_ray_dirs(px_x, px_y, cam)

    zeros = lambda *c: torch.zeros((H, W, *c), dtype=torch.float32,
                                   device=dev)
    acc = {"img": zeros(3), "tex": zeros(texture.shape[-1]),
           "depth": zeros(), "alpha": zeros(), "normal": zeros(3),
           "reg": zeros(), "m1": zeros(), "uv": zeros(3)}
    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    broken = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for i in order:
        g = SplatGeom(*(f[i] for f in geom))
        hit = surfel.intersect(g, origin, dirs, px)
        a = hit["alpha"]
        texel = surfel.chart_sample_bilinear(texture[i], hw[i][0], hw[i][1],
                                             hit["uv"])
        considered = ~broken & (a > 0.0)
        next_T = T * (1.0 - a)
        would_break = considered & (next_T <= T_EPS)
        applied = considered & ~would_break
        w = torch.where(applied, a * T, 0.0)
        m = surfel.reg_depth_map(hit["t"])
        w3 = w[..., None]
        acc = {
            "img": acc["img"] + w3 * g.rgb,
            "tex": acc["tex"] + w3 * texel,
            "depth": acc["depth"] + w * hit["t"],
            "normal": acc["normal"] + w3 * hit["n_eff"],
            "reg": acc["reg"] + 2.0 * w * (m * acc["alpha"] - acc["m1"]),
            "alpha": acc["alpha"] + w,
            "m1": acc["m1"] + w * m,
            "uv": acc["uv"] + w3 * torch.cat(
                [hit["uv"], torch.full_like(hit["uv"][..., :1], 0.5)], -1),
        }
        T = torch.where(applied, next_T, T)
        broken = broken | would_break

    out = {"img": acc["img"], "texture_rgb": acc["tex"],
           "depth": acc["depth"], "alpha": acc["alpha"],
           "normal": acc["normal"], "reg": acc["reg"]}
    if extra_channels:
        out["uv"] = acc["uv"]
    return out
