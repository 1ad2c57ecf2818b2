"""Ray–surfel intersection, Gaussian falloff and chart sampling
(counterpart of ``gstex_tpu/ops/surfel.py``): the per-(pixel, splat) math
the renderer's blend loop runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# 2DGS object-space low-pass filter: screen-space fallback Gaussian with
# sigma^2 = 0.5 px^2
AA_SIGMA2 = 0.5
ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
T_EPS = 1e-4
# view depth -> [0, 1] mapping of the 2DGS distortion regularizer
REG_NEAR = 0.2
REG_FAR = 100.0
# hard support cutoff in sigma units: the surfel response is zero beyond
# the ±EXTENT_SIGMA ellipse, consistent with the 3σ screen AABB used for
# tile binning
EXTENT_SIGMA = 3.0


class SplatGeom(NamedTuple):
    """Activated per-splat fields consumed by the blend loop."""

    mean: torch.Tensor      # (..., 3) world
    ax1: torch.Tensor       # (..., 3) unit u axis (R[:,0])
    ax2: torch.Tensor       # (..., 3) unit v axis (R[:,1])
    normal: torch.Tensor    # (..., 3) unit normal (R[:,2])
    l0: torch.Tensor        # (...,) scale along ax1 (sigma)
    l1: torch.Tensor        # (...,) scale along ax2
    opacity: torch.Tensor   # (...,)
    rgb: torch.Tensor       # (..., 3) view-dependent SH color
    xy: torch.Tensor        # (..., 2) projected center, for the AA filter
    uv_scale: torch.Tensor  # (..., 2) chart mapping = 1/(2·σf·l)


def intersect(geom: SplatGeom, origin: torch.Tensor, dirs: torch.Tensor,
              px: torch.Tensor) -> dict:
    """Ray–surfel-plane intersection and Gaussian response.

    Broadcasts geom fields against pixel arrays (``dirs`` (..., 3) world
    ray dirs with unit view-space z, ``px`` (..., 2) continuous pixel
    coords). Returns ``t`` (view depth of the hit), ``alpha`` (after the
    cutoffs), ``uv`` (chart coordinates in [0,1], in a detached frame) and
    ``n_eff`` (normal flipped toward the camera).
    """
    om = origin - geom.mean
    denom = (dirs * geom.normal).sum(-1)
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-9),
                       torch.full_like(denom, 1e-9))
    safe_denom = torch.where(denom.abs() < 1e-9, tiny, denom)
    numer = -(om * geom.normal).sum(-1)
    t = numer / safe_denom

    a1 = (om * geom.ax1).sum(-1)
    a2 = (om * geom.ax2).sum(-1)
    b1 = (dirs * geom.ax1).sum(-1)
    b2 = (dirs * geom.ax2).sum(-1)
    u_sig = (a1 + t * b1) / geom.l0
    v_sig = (a2 + t * b2) / geom.l1
    r2_sig = u_sig * u_sig + v_sig * v_sig
    g_surf = torch.exp(-0.5 * r2_sig)
    g_surf = torch.where(r2_sig <= EXTENT_SIGMA * EXTENT_SIGMA, g_surf,
                         torch.zeros_like(g_surf))

    dpx = px - geom.xy
    r2 = (dpx * dpx).sum(-1)
    g_screen = torch.exp(-0.5 * r2 / AA_SIGMA2)

    g = torch.maximum(g_surf, g_screen)
    alpha = torch.clamp(geom.opacity * g, max=ALPHA_CLAMP)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(alpha < ALPHA_CUTOFF, zero, alpha)
    alpha = torch.where(t > 1e-6, alpha, zero)

    # the chart uv frame (axes and mapping) is detached: the uv reaches
    # the means through o − μ and t only
    ax1_d, ax2_d = geom.ax1.detach(), geom.ax2.detach()
    uv_scale = geom.uv_scale.detach()
    uv_u = 0.5 + uv_scale[..., 0] * ((om * ax1_d).sum(-1)
                                     + t * (dirs * ax1_d).sum(-1))
    uv_v = 0.5 + uv_scale[..., 1] * ((om * ax2_d).sum(-1)
                                     + t * (dirs * ax2_d).sum(-1))
    uv = torch.stack([uv_u.clamp(0.0, 1.0), uv_v.clamp(0.0, 1.0)], dim=-1)

    facing = torch.where(denom > 0.0, -1.0, 1.0)
    n_eff = geom.normal * facing[..., None]
    return {"t": t, "alpha": alpha, "uv": uv, "n_eff": n_eff}


def reg_depth_map(t: torch.Tensor) -> torch.Tensor:
    """Map view depth to [0, 1] for the distortion regularizer
    (2DGS NDC-style)."""
    tc = torch.clamp(t, min=REG_NEAR)
    return (REG_FAR / (REG_FAR - REG_NEAR)) * (1.0 - REG_NEAR / tc)


def chart_sample_bilinear(chart: torch.Tensor, h, w,
                          uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one dense padded chart ``(Ch, Cw, C)`` at
    ``uv`` (..., 2) in [0,1].

    Texel (a, b) of the active h×w region sits at uv = (a/h, b/w); samples
    are clamped into the active region, so padded texels are never read.
    """
    hf = torch.as_tensor(h, dtype=torch.float32, device=uv.device)
    wf = torch.as_tensor(w, dtype=torch.float32, device=uv.device)
    x = torch.minimum(torch.clamp(uv[..., 0] * hf, min=0.0), hf - 1.0)
    y = torch.minimum(torch.clamp(uv[..., 1] * wf, min=0.0), wf - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=int(h) - 1)
    y1i = torch.clamp(y0i + 1, max=int(w) - 1)
    c00 = chart[x0i, y0i]
    c01 = chart[x0i, y1i]
    c10 = chart[x1i, y0i]
    c11 = chart[x1i, y1i]
    return ((1 - fx) * ((1 - fy) * c00 + fy * c01)
            + fx * ((1 - fy) * c10 + fy * c11))
