"""The pure-torch tile renderer over the dense per-tile lists, with a
hand-derived backward (counterpart of ``gstex_tpu/ops/rasterize.py``:
``_forward_scan``, ``_raster_core`` with its custom VJP, ``rasterize``).

This is ``renderer="xla"``, the target of ``extra=True``, and the plain
PyTorch version of the dense-list kernels (``ops/rasterize_dense.py``).
It consumes ``TileBins`` and blends one splat rank per step, vectorized
over (tiles x pixels). It works on the ``(N, 32)`` records the kernels
read (``ops/records.py``), so its gradients with respect to records and
charts are the kernels' outputs; ``rasterize`` builds the records from a
``SplatGeom`` and autograd carries their gradient on to the params.

The forward is ``rasterize_fwd.forward_walk`` on the dense lists seen as
a flat one: one plain forward serves both list layouts, in the kernels'
per-pixel order and arithmetic.

The backward does not differentiate the blend scan (that would store a
carry per step). As in the JAX package it is the back-to-front walk that
recovers the transmittance as ``T_k = T_{k+1} / (1 − α_k)`` and keeps
per-pixel suffix sums, while the local per-splat math (ray-plane hit,
falloff, bilinear fetch in its hat-function form, distortion depth) is
pulled back by ``torch.autograd`` inside each step. Per pixel, k indexing the tile's
front-to-back list:

  w_k = α_k·T_k,  T_{k+1} = T_k(1−α_k)   (applied iff k < ncontrib and α>0)
  O_ch = Σ_k w_k y_k,ch                   for img/tex/depth/alpha/normal
  O_reg = Σ_k 2 w_k (m_k A_k − C_k),      A_k = Σ_{j<k} w_j, C_k = Σ_{j<k} w_j m_j
  ∂L/∂w_k = s_k = Σ_ch g_ch y_k,ch + 2 g_reg [(m_k A_k − C_k) + (D_k − m_k E_k)]
  ∂L/∂α_k = T_k s_k − (Σ_{j>k} s_j w_j)/(1−α_k)
  ∂L/∂m_k = 2 g_reg w_k (A_k − E_k)

with the suffix sums E_k = Σ_{j>k} w_j and D_k = Σ_{j>k} w_j m_j kept
back to front, and the prefixes recovered as A_k = M0 − w_k − E_k and
C_k = M1 − w_k m_k − D_k from the forward's totals M0 (the alpha map) and
M1.
"""

from __future__ import annotations

import torch

from .binning import TileBins, TileGrid
from .camera import Camera
from .rasterize_bwd import tile_planes, walk_starts
from .rasterize_fwd import NG, forward_walk, pixel_grid, response
from .records import F_REC, assemble_records, cam_info
from .surfel import SplatGeom

# record fields that carry no gradient: the detached uv frame's axes and
# the chart dims
NO_GRAD_FIELDS = [12, 13, 14, 16, 17, 18, 26, 27, 28, 29, 30, 31]


def flat_view(ids: torch.Tensor, counts: torch.Tensor):
    """The dense ``(T, s_max)`` lists as one flat list with per-tile
    segment starts: ``(gids, starts, counts)``."""
    nt, s_max = ids.shape
    starts = torch.arange(nt, dtype=torch.int32, device=ids.device) * s_max
    return ids.reshape(-1), starts, counts


def forward_scan(records, ids, counts, charts, cam_info, grid: TileGrid,
                 lean: bool = False, extra: bool = False, v1: bool = False):
    """Front-to-back blend over the dense lists: the ``(14, H, W)`` maps in
    ``rasterize_fwd.CH_NAMES`` order (plus three ``uv`` planes with
    ``extra``) and ncontrib ``(H, W)`` int32, which is ``s_max`` where a
    pixel's walk never broke. ``v1`` takes the v1 kernels' arithmetic
    (``rasterize_fwd.response``)."""
    maps, ncon, _ = forward_walk(records, *flat_view(ids, counts), charts,
                                 cam_info, grid, ids.shape[1], lean=lean,
                                 extra=extra, v1=v1)
    return maps, ncon


def _hat_fetch(charts_flat, gid, ch, cw, r, uvu_raw, uvv_raw):
    """The bilinear fetch written with hat-function weights ``max(0, 1 −
    |x − a|)`` over the 3 x 3 texels around the sample, on texel leaves
    that autograd can pull back to: ``(tex (A, P, 3), texel indices,
    texel leaves)``.

    Its value is the forward's 2 x 2 fetch. Its derivative differs from
    the 2 x 2 form's only where a sample sits exactly on a texel (which
    float32 charts of 8 or 16 texels do a few times a frame): there
    autograd's rules for ``abs`` and ``clamp`` give the two-sided
    ``row(x0 + 1) − row(x0 − 1)``, which is what the kernels of both tiers
    compute, after the TPU kernels. Texels outside the padded chart read
    as zero."""
    uvu = torch.clamp(uvu_raw, 0.0, 1.0)
    uvv = torch.clamp(uvv_raw, 0.0, 1.0)
    hf, wf = r[:, 26].detach(), r[:, 27].detach()
    # clamp with tensor bounds passes the gradient at either bound, as the
    # kernels' pass masks do (torch.minimum would halve it at a tie)
    zero = torch.zeros_like(hf)
    xg = torch.clamp(uvu * hf, zero, hf - 1.0)
    yg = torch.clamp(uvv * wf, zero, wf - 1.0)
    x0 = torch.floor(xg).detach()
    y0 = torch.floor(yg).detach()
    tex = 0.0
    tidx, texels = [], []
    for i in (-1.0, 0.0, 1.0):
        a = x0 + i
        wx = torch.clamp(1.0 - (xg - a).abs(), min=0.0)
        row = a.long()
        for j in (-1.0, 0.0, 1.0):
            b = y0 + j
            wy = torch.clamp(1.0 - (yg - b).abs(), min=0.0)
            col = b.long()
            ok = (row >= 0) & (row < ch) & (col >= 0) & (col < cw)
            idx = ((gid[:, None] * ch + row.clamp(0, ch - 1)) * cw
                   + col.clamp(0, cw - 1))
            texel = charts_flat[idx].requires_grad_(True)
            tex = tex + torch.where(ok, wx * wy, 0.0)[..., None] * texel
            tidx.append(idx)
            texels.append(texel)
    return tex, tidx, texels


def backward_walk(records, ids, counts, charts, cam_info, maps, ncontrib,
                  gmaps, grid: TileGrid, lean: bool = False,
                  v1: bool = False):
    """Gradients of the first 12 maps of ``forward_scan`` under the
    cotangents ``gmaps`` (12, H, W): ``(d_records (N, 32), d_charts (N, Ch,
    Cw, 3))``. One rank per step from each tile's ``min(count, max
    ncontrib + 1)`` down, over the tiles that still walk. ``lean`` leaves
    out the normal and reg terms, as the lean forward leaves out their
    maps; ``v1`` pulls back the v1 kernels' arithmetic."""
    dev = records.device
    n = records.shape[0]
    ch, cw = charts.shape[1], charts.shape[2]
    charts_flat = charts.detach().reshape(-1, 3)
    records = records.detach()
    gx, gy, dirs, inside = pixel_grid(grid, cam_info)
    g = tile_planes(gmaps, grid)                               # (12, T, P)
    fw = tile_planes(maps[[7, 12, 13]], grid)        # alpha, t_final, m1
    ncon = tile_planes(ncontrib[None].to(torch.float32), grid)[0]
    top = walk_starts(counts, ncontrib, grid, ids.shape[1])
    ids = ids.long()

    d_rec = torch.zeros((n, F_REC), dtype=torch.float32, device=dev)
    d_ch = torch.zeros((n * ch * cw, 3), dtype=torch.float32, device=dev)
    T = fw[1].clone()
    BS = torch.zeros_like(T)
    E = torch.zeros_like(T)
    D = torch.zeros_like(T)
    max_top = int(top.max()) if top.numel() > 0 else 0
    for k in range(max_top - 1, -1, -1):
        act = torch.nonzero(top > k).flatten()
        gid = ids[act, k]
        ga = g[:, act]
        # the splat's local quantities, on leaves autograd pulls back to
        r = records[gid].requires_grad_(True)                      # (A, F)
        with torch.enable_grad():
            rr = r[:, :, None]
            resp = response(rr, [d[act] for d in dirs], gx[act], gy[act],
                            v1=v1)
            tex, tidx, texels = _hat_fetch(charts_flat, gid, ch, cw, rr,
                                           resp["uvu_raw"], resp["uvv_raw"])
            n_eff = rr[:, 0:3] * resp["flip"][:, None]             # (A, 3, P)
        a = resp["alpha"].detach()
        t = resp["t"].detach()
        applied = inside[act] & (a > 0) & (k < ncon[act])
        inv_q = 1.0 / torch.where(applied, 1.0 - a, 1.0)
        t_k = T[act] * inv_q
        w = torch.where(applied, a * t_k, 0.0)
        BSa = BS[act]
        g_img = ga[0:3].permute(1, 0, 2)                           # (A, 3, P)
        g_tex = ga[3:6].permute(1, 2, 0)                           # (A, P, 3)
        s_k = ((rr[:, 21:24].detach() * g_img).sum(1)
               + (tex.detach() * g_tex).sum(-1) + t * ga[6] + ga[7])
        # local outputs and their cotangents
        outs = [tex, resp["t"]]
        cots = [w[..., None] * g_tex, w * ga[6]]
        if not lean:
            m = resp["m"].detach()
            Ea, Da = E[act], D[act]
            wm = w * m
            big_a = fw[0, act] - w - Ea
            big_c = fw[2, act] - wm - Da
            g_n = ga[8:11].permute(1, 0, 2)
            s_k = s_k + (n_eff.detach() * g_n).sum(1)
            s_k = s_k + 2.0 * ga[11] * ((m * big_a - big_c) + (Da - m * Ea))
            outs += [resp["m"], n_eff]
            cots += [2.0 * ga[11] * w * (big_a - Ea), w[:, None] * g_n]
            E[act] = Ea + w
            D[act] = Da + wm
        outs.append(resp["alpha"])
        cots.append(torch.where(applied, t_k * s_k - BSa * inv_q, 0.0))
        d_r, *d_texels = torch.autograd.grad(outs, [r, *texels], cots)
        # rgb enters the blend directly
        d_r[:, 21:24] += (w[:, None] * g_img).sum(-1)
        d_rec.index_add_(0, gid, d_r)
        for i, d_t in zip(tidx, d_texels):
            d_ch.index_add_(0, i.reshape(-1), d_t.reshape(-1, 3))
        BS[act] = BSa + s_k * w
        T[act] = t_k
    d_rec[:, NO_GRAD_FIELDS] = 0.0
    return d_rec, d_ch.reshape(charts.shape)


class _RasterCore(torch.autograd.Function):
    """(records, charts) -> (14, H, W) maps, ncontrib, by ``forward_scan``;
    the backward is ``backward_walk`` on the cotangents of the first 12
    maps (the counterpart of ``_raster_core``'s custom VJP)."""

    @staticmethod
    def forward(ctx, records, charts, ids, counts, info, grid):
        maps, ncon = forward_scan(records, ids, counts, charts, info, grid)
        ctx.save_for_backward(records, charts, ids, counts, info, maps, ncon)
        ctx.grid = grid
        ctx.mark_non_differentiable(ncon)
        return maps, ncon

    @staticmethod
    def backward(ctx, g_maps, g_ncon):
        records, charts, ids, counts, info, maps, ncon = ctx.saved_tensors
        d_rec, d_ch = backward_walk(records, ids, counts, charts, info, maps,
                                    ncon, g_maps[:NG].contiguous(), ctx.grid)
        return d_rec, d_ch, None, None, None, None


def named_maps(maps: torch.Tensor) -> dict:
    """The (H, W, ·) output maps of the first twelve planes."""
    return {
        "img": maps[0:3].permute(1, 2, 0),
        "texture_rgb": maps[3:6].permute(1, 2, 0),
        "depth": maps[6],
        "alpha": maps[7],
        "normal": maps[8:11].permute(1, 2, 0),
        "reg": maps[11],
    }


def rasterize(geom: SplatGeom, texture: torch.Tensor,
              texture_hw: torch.Tensor, bins: TileBins, cam: Camera,
              grid: TileGrid, extra_channels: bool = False,
              px_offset=None) -> dict:
    """Render all output maps as (H, W, ...) images: img, texture_rgb,
    depth, alpha, normal, reg.

    Differentiable in the geom fields and the texture. With
    ``extra_channels`` it adds the ``uv`` visualization map and runs the
    forward alone, under no custom backward.
    """
    records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
    info = cam_info(cam, px_offset)
    texture = texture.contiguous()
    if extra_channels:
        maps, _ = forward_scan(records, bins.ids, bins.counts, texture, info,
                               grid, extra=True)
        out = named_maps(maps)
        out["uv"] = maps[14:17].permute(1, 2, 0)
        return out
    maps, _ = _RasterCore.apply(records, texture, bins.ids, bins.counts,
                                info, grid)
    return named_maps(maps)
