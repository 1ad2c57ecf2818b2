"""Plain PyTorch reference of a GStex training step, written from the
method's equations and imported by nothing of the measured program.

A scene is textured 2D Gaussian surfels: each has a centre, two axes and
a normal (from a wxyz quaternion), two scales, an opacity, degree-3
spherical-harmonic colour (the constant term zeroed: the albedo lives in
the chart) and an RGB chart of spherical-harmonic constants, padded to
(Ch, Cw) with an active h x w region. One pixel's ray hits a surfel's
plane at depth t; the response is the larger of the surfel's Gaussian
(zero past 3 sigma) and a screen low-pass of variance 0.5 px^2 around the
projected centre; alpha = min(opacity * g, 0.999), dropped below 1/255
and behind the camera. Surfels blend front to back by the depth of their
centres (ties by index); a pixel stops at the first surfel whose blend
would take its transmittance to 1e-4 or below, and that surfel does not
blend. The pixel's colour is clip(sum w*(sh colour + bilinear chart
albedo) + (1 - sum w)*background, 0, 1). The loss is 0.8 L1 + 0.2
(1 - SSIM) with an 11x11 Gaussian window (sigma 1.5, VALID). Adam
(0.9, 0.999, eps 1e-15) updates each leaf at its group's rate, and every
100th step re-budgets the charts: a bisection for the texel scale that
meets the texel budget within 0.1 %, then a bilinear resample of every
chart to its new active size.

Rendering works tile by tile over lists this module builds itself from a
conservative screen bound, in chunks of tiles recomputed for the
backward (``torch.utils.checkpoint``), and ``torch.autograd`` takes every
gradient. Everything is float32, with TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_STOP = 1e-4
SUPPORT_SIGMA = 3.0
# the low-pass term 0.999 * exp(-r^2) falls under 1/255 past r = 2.36 px
LOWPASS_PX = 3.0
NEAR = 0.01
TILE = 16
# (tile, slot, pixel) elements a chunk evaluates at once
CHUNK_ELEMENTS = 1 << 25

LEAVES = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
          "features_rest", "texture")
GROUP_LR = {"log_scales": 5e-3, "quats": 1e-3, "opacity_logits": 0.05,
            "features_dc": 2.5e-3, "features_rest": 2.5e-3 / 20,
            "texture": 1e-3}
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class View:
    """A pinhole camera: intrinsics in pixels, ``c2w`` (3, 4) with +x
    right, +y up and the camera looking along -z."""

    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int
    c2w: torch.Tensor

    def scaled(self, factor: int) -> "View":
        """The same camera over an image ``factor`` times smaller."""
        return View(self.fx / factor, self.fy / factor, self.cx / factor,
                    self.cy / factor, self.height // factor,
                    self.width // factor, self.c2w)


@dataclass
class Settings:
    """What the reference takes from a configuration."""

    pixel_num: float
    xyz_lr: float          # spatial_scale * 1.6e-5 * xyz multiplier
    xyz_lr_final: float    # spatial_scale * 1.6e-6
    max_steps: int
    sh_degree: int = 3
    sh_interval: int = 1000
    sigma_factor: float = 3.0
    chart_every: int = 100
    # the per-pixel work's dtype (bfloat16 for the control of a tier the
    # port has no lower-precision path for)
    dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# per-surfel terms
# ---------------------------------------------------------------------------

def rotation(quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of wxyz quaternions, normalised first; column
    0 and 1 are the surfel's axes, column 2 its normal."""
    q = quats / quats.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def sh_colour(features_rest: torch.Tensor, dirs: torch.Tensor,
              degree: int) -> torch.Tensor:
    """Degree-``degree`` real SH (3DGS signs) at unit ``dirs`` with the
    constant term zeroed: (N, 3)."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    basis = [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                  SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy),
                  SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    if degree < 1:
        return torch.zeros_like(dirs)
    b = torch.stack(basis, -1)                                # (N, K)
    return (b[..., None] * features_rest[:, :b.shape[-1]]).sum(1)


def camera_frame(view: View):
    """The camera centre and the world directions of the camera's x (right
    in the image), y (down) and z (forward) axes."""
    r = view.c2w[:, :3]
    return view.c2w[:, 3], r[:, 0], -r[:, 1], -r[:, 2]


def surfel_table(params: dict, buffers: dict, view: View, step: int,
                 st: Settings):
    """(N, 26) per-surfel coefficients of the per-pixel math (each dot
    product with a ray direction written as an affine function of the
    pixel's normalised coordinates) and the centres' view depths.
    Differentiable in the params."""
    campos, ex, ey, ez = camera_frame(view)
    rot = rotation(params["quats"])
    ax1, ax2, nrm = rot[..., 0], rot[..., 1], rot[..., 2]
    scale = torch.exp(params["log_scales"]).clamp(min=1e-9)
    opacity = torch.sigmoid(params["opacity_logits"].reshape(-1))
    means = params["means"]
    vd = means.detach() - campos
    vd = vd / (vd.norm(dim=-1, keepdim=True) + 1e-12)
    degree = min(step // st.sh_interval, st.sh_degree)
    rgb = sh_colour(params["features_rest"], vd, degree)
    om = campos - means
    rel = means - campos
    zc = rel @ ez
    xc, yc = rel @ ex, rel @ ey
    zs = torch.where(zc.abs() < 1e-8, torch.full_like(zc, 1e-8), zc)
    px = view.fx * xc / zs + view.cx - 0.5
    py = view.fy * yc / zs + view.cy - 0.5

    def affine(v):
        return [v @ ex, v @ ey, v @ ez]

    a1d, a2d = ax1.detach(), ax2.detach()
    hw = buffers["texture_hw"].to(torch.float32)
    cols = (affine(nrm) + affine(ax1) + affine(ax2)
            + [-(om * nrm).sum(-1), (om * ax1).sum(-1), (om * ax2).sum(-1),
               (om * a1d).sum(-1), (om * a2d).sum(-1),
               1.0 / scale[:, 0], 1.0 / scale[:, 1], px, py, opacity,
               rgb[:, 0], rgb[:, 1], rgb[:, 2],
               buffers["mappings"][:, 0], buffers["mappings"][:, 1],
               hw[:, 0], hw[:, 1]])
    return torch.stack(cols, -1), zc.detach()


# ---------------------------------------------------------------------------
# tile lists
# ---------------------------------------------------------------------------

def screen_bounds(params: dict, view: View):
    """Each surfel's pixel bound (x0, x1, y0, y1), holding its 3-sigma
    parallelogram and the low-pass disc around its centre, or the whole
    image where a corner lies behind the near plane; and whether it can
    blend at all (its centre in front of the camera)."""
    with torch.no_grad():
        campos, ex, ey, ez = camera_frame(view)
        rot = rotation(params["quats"])
        scale = torch.exp(params["log_scales"]).clamp(min=1e-9)
        m = params["means"]
        e1 = SUPPORT_SIGMA * scale[:, :1] * rot[..., 0]
        e2 = SUPPORT_SIGMA * scale[:, 1:] * rot[..., 1]
        corners = torch.stack([m + e1 + e2, m + e1 - e2, m - e1 + e2,
                               m - e1 - e2], 1) - campos
        z = corners @ ez
        zs = z.clamp(min=NEAR)
        x = view.fx * (corners @ ex) / zs + view.cx - 0.5
        y = view.fy * (corners @ ey) / zs + view.cy - 0.5
        rel = m - campos
        zc = rel @ ez
        zcs = zc.clamp(min=1e-8)
        px = view.fx * (rel @ ex) / zcs + view.cx - 0.5
        py = view.fy * (rel @ ey) / zcs + view.cy - 0.5
        x0 = torch.minimum(x.min(1).values, px - LOWPASS_PX) - 1.0
        x1 = torch.maximum(x.max(1).values, px + LOWPASS_PX) + 1.0
        y0 = torch.minimum(y.min(1).values, py - LOWPASS_PX) - 1.0
        y1 = torch.maximum(y.max(1).values, py + LOWPASS_PX) + 1.0
        whole = (z <= NEAR).any(1)
        big = float(max(view.width, view.height) + 1)
        x0 = torch.where(whole, torch.full_like(x0, -big), x0)
        y0 = torch.where(whole, torch.full_like(y0, -big), y0)
        x1 = torch.where(whole, torch.full_like(x1, 2 * big), x1)
        y1 = torch.where(whole, torch.full_like(y1, 2 * big), y1)
        return (x0, x1, y0, y1), zc > 1e-6


def tile_lists(params: dict, view: View, depth: torch.Tensor, tile: int):
    """Per tile, its candidate surfels front to back: ``(gids, starts,
    counts)`` over the ``ntx * nty`` tiles of ``tile`` px."""
    dev = depth.device
    ntx, nty = -(-view.width // tile), -(-view.height // tile)
    (x0, x1, y0, y1), front = screen_bounds(params, view)
    tx0 = torch.floor(x0 / tile).clamp(0, ntx).long()
    tx1 = (torch.floor(x1 / tile) + 1).clamp(0, ntx).long()
    ty0 = torch.floor(y0 / tile).clamp(0, nty).long()
    ty1 = (torch.floor(y1 / tile) + 1).clamp(0, nty).long()
    nx, ny = (tx1 - tx0).clamp(min=0), (ty1 - ty0).clamp(min=0)
    n = torch.where(front, nx * ny, 0)
    gid = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(gid.numel(), device=dev) - first[gid]
    tx = tx0[gid] + k % nx[gid]
    ty = ty0[gid] + k // nx[gid]
    tid = ty * ntx + tx
    order = torch.argsort(depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev)
    key = tid * depth.numel() + rank[gid]
    srt = torch.argsort(key)
    gids = gid[srt]
    counts = torch.bincount(tid, minlength=ntx * nty)
    starts = torch.cumsum(counts, 0) - counts
    return gids, starts, counts


# ---------------------------------------------------------------------------
# the blend
# ---------------------------------------------------------------------------

def _tile_pixels(tids: torch.Tensor, view: View, tile: int):
    ntx = -(-view.width // tile)
    p = torch.arange(tile * tile, device=tids.device)
    ix = (tids % ntx)[:, None] * tile + p % tile
    iy = (tids // ntx)[:, None] * tile + p // tile
    inside = (ix < view.width) & (iy < view.height)
    return ix.to(torch.float32), iy.to(torch.float32), inside


def _blend(table, albedo, tids, slots, nslot, view: View, tile: int,
           chart_pad, counts: bool = False):
    """One chunk of tiles: (Tc, P, 7) of blended sh colour, chart albedo
    and weight; with ``counts`` instead the applied mask and the texel
    indices it reads, and each tile's walk (one past its last blend)."""
    ch, cw = chart_pad
    dt = table.dtype
    ix, iy, inside = _tile_pixels(tids, view, tile)
    dx = ((ix + 0.5 - view.cx) / view.fx)[:, None, :].to(dt)
    dy = ((iy + 0.5 - view.cy) / view.fy)[:, None, :].to(dt)
    ix, iy = ix.to(dt), iy.to(dt)
    live = torch.arange(slots.shape[1], device=slots.device)[None, :] \
        < nslot[:, None]
    gid = torch.where(live, slots, 0)
    rec = table[gid]                                        # (Tc, S, 26)
    c = lambda i: rec[..., i:i + 1]

    dn = c(0) * dx + c(1) * dy + c(2)
    tiny = torch.where(dn < 0, -1e-9, 1e-9).to(dt)
    dn = torch.where(dn.abs() < 1e-9, tiny, dn)
    t = c(9) / dn
    b1 = c(3) * dx + c(4) * dy + c(5)
    b2 = c(6) * dx + c(7) * dy + c(8)
    u = (c(10) + t * b1) * c(14)
    v = (c(11) + t * b2) * c(15)
    r2 = u * u + v * v
    g_surf = torch.where(r2 <= SUPPORT_SIGMA ** 2, torch.exp(-0.5 * r2), 0.0)
    ex = ix[:, None, :] - c(16)
    ey = iy[:, None, :] - c(17)
    g_low = torch.exp(-(ex * ex + ey * ey))
    alpha = torch.clamp(c(18) * torch.maximum(g_surf, g_low), max=ALPHA_MAX)
    keep = ((alpha >= ALPHA_MIN) & (t > 1e-6) & live[..., None]
            & inside[:, None, :])
    alpha = torch.where(keep, alpha, 0.0)

    uu = torch.clamp(0.5 + c(22) * (c(12) + t * b1.detach()), 0.0, 1.0)
    vv = torch.clamp(0.5 + c(23) * (c(13) + t * b2.detach()), 0.0, 1.0)
    h, w = c(24).detach(), c(25).detach()
    xs = torch.minimum(torch.clamp(uu * h, min=0.0), h - 1.0)
    ys = torch.minimum(torch.clamp(vv * w, min=0.0), w - 1.0)
    x0, y0 = torch.floor(xs).detach(), torch.floor(ys).detach()
    fx, fy = xs - x0, ys - y0
    x1, y1 = torch.minimum(x0 + 1, h - 1), torch.minimum(y0 + 1, w - 1)
    base = (gid * (ch * cw))[..., None]

    def at(xi, yi):
        return base + xi.long() * cw + yi.long()

    q = 1.0 - alpha
    t_incl = torch.cumprod(q, 1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    stop = (alpha > 0) & (t_incl <= T_STOP)
    si = stop.to(torch.int32)
    stopped = (torch.cumsum(si, 1) - si) > 0
    applied = (alpha > 0) & ~stop & ~stopped
    if counts:
        corners = torch.stack([at(x0, y0), at(x0, y1), at(x1, y0),
                               at(x1, y1)], -1)
        rank = torch.arange(1, slots.shape[1] + 1, device=slots.device)
        walk = (applied * rank[None, :, None]).amax((1, 2))
        return applied, gid, corners, walk
    wgt = torch.where(applied, alpha * t_excl, 0.0)
    idx = torch.stack([at(x0, y0), at(x0, y1), at(x1, y0), at(x1, y1)], 0)
    texel = albedo.index_select(0, idx.reshape(-1)).reshape(*idx.shape, 3)
    fx, fy = fx[..., None], fy[..., None]
    tex = ((1 - fx) * ((1 - fy) * texel[0] + fy * texel[1])
           + fx * ((1 - fy) * texel[2] + fy * texel[3]))
    w3 = wgt[..., None]
    sh = (w3 * rec[..., None, 19:22]).sum(1)
    return torch.cat([sh, (w3 * tex).sum(1), wgt.sum(1)[..., None]], -1)


def _chunks(lengths: torch.Tensor, tile: int, budget: int):
    """Tiles in order of decreasing walk, cut into chunks of at most
    ``budget`` (tile, slot, pixel) elements: lists of tile ids."""
    order = torch.argsort(lengths, descending=True)
    lens = lengths[order].tolist()
    out, start, i = [], 0, 0
    px = tile * tile
    while i < len(lens):
        if lens[i] == 0:
            break
        top = lens[start]
        if (i - start + 1) * top * px > budget and i > start:
            out.append(order[start:i])
            start = i
            continue
        i += 1
    if start < i:
        out.append(order[start:i])
    return out


def _slots(gids, starts, tids, length):
    s = int(length.max())
    rank = torch.arange(s, device=gids.device)
    pos = (starts[tids][:, None] + rank[None, :]).clamp(max=gids.numel() - 1)
    return gids[pos]


def walks(params, view, table, depth, tile=TILE):
    """The tile lists and each tile's walk: how many of its candidates
    the blend needs (one past the last that any pixel blends)."""
    with torch.no_grad():
        gids, starts, counts = tile_lists(params, view, depth, tile)
        walk = torch.zeros_like(counts)
        pad = tuple(params["texture"].shape[1:3])
        for tids in _chunks(counts, tile, CHUNK_ELEMENTS):
            slots = _slots(gids, starts, tids, counts[tids])
            _, _, _, w = _blend(table, None, tids, slots, counts[tids], view,
                                tile, pad, counts=True)
            walk[tids] = w
    return gids, starts, walk


def render(params: dict, buffers: dict, view: View, step: int, st: Settings,
           background: torch.Tensor, tile: int = TILE):
    """(H, W, 3) colour and (H, W) weight of a view, differentiable in the
    params where grad is enabled."""
    table, depth = surfel_table(params, buffers, view, step, st)
    gids, starts, walk = walks(params, view, table.detach(), depth, tile)
    albedo = (SH_C0 * params["texture"] + 0.5).reshape(-1, 3).to(st.dtype)
    table = table.to(st.dtype)
    ntiles = walk.numel()
    out = torch.zeros((ntiles, tile * tile, 7), device=depth.device)
    pad = tuple(params["texture"].shape[1:3])
    grad = torch.is_grad_enabled()
    for tids in _chunks(walk, tile, CHUNK_ELEMENTS):
        slots = _slots(gids, starts, tids, walk[tids])
        args = (table, albedo, tids, slots, walk[tids], view, tile, pad)
        part = (checkpoint(_blend, *args, use_reentrant=False) if grad
                else _blend(*args))
        out = out.index_copy(0, tids, part.float())
    ntx, nty = -(-view.width // tile), -(-view.height // tile)
    img = out.reshape(nty, ntx, tile, tile, 7).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * tile, ntx * tile, 7)[:view.height, :view.width]
    alpha = img[..., 6]
    rgb = img[..., 0:3] + img[..., 3:6] + (1.0 - alpha[..., None]) * \
        background
    return torch.clamp(rgb, 0.0, 1.0), alpha


def view_counts(params, buffers, view, step, st, tile=TILE) -> dict:
    """The work a view needs: blends (pixel-surfel pairs of alpha >= 1/255
    in front of the pixel's stop), the surfels with a blend, and the
    distinct chart texels those blends read (four a bilinear fetch)."""
    with torch.no_grad():
        table, depth = surfel_table(params, buffers, view, step, st)
        gids, starts, walk = walks(params, view, table, depth, tile)
        pad = tuple(params["texture"].shape[1:3])
        blends, surfels, texels = 0, [], []
        for tids in _chunks(walk, tile, CHUNK_ELEMENTS):
            slots = _slots(gids, starts, tids, walk[tids])
            applied, gid, corners, _ = _blend(table, None, tids, slots,
                                              walk[tids], view, tile, pad,
                                              counts=True)
            blends += int(applied.sum())
            surfels.append(torch.unique(
                gid[:, :, None].expand_as(applied)[applied]))
            texels.append(torch.unique(corners[applied]))
        surfels = torch.unique(torch.cat(surfels)) if surfels else []
        texels = torch.unique(torch.cat(texels)) if texels else []
        return {"blends": blends, "surfels": int(len(surfels)),
                "texels": int(len(texels))}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _window(device) -> torch.Tensor:
    x = np.arange(11, dtype=np.float64) - 5.0
    g = np.exp(-x * x / (2 * 1.5 ** 2))
    return torch.tensor(g / g.sum(), dtype=torch.float32, device=device)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1]: 11x11 Gaussian window
    of sigma 1.5 over VALID positions, K1 0.01, K2 0.03."""
    c = a.shape[-1]
    win = _window(a.device)

    def blur(x):
        y = x.permute(2, 0, 1)[None]
        y = F.conv2d(y, win.view(1, 1, 11, 1).repeat(c, 1, 1, 1), groups=c)
        return F.conv2d(y, win.view(1, 1, 1, 11).repeat(c, 1, 1, 1),
                        groups=c)

    ma, mb = blur(a), blur(b)
    saa = blur(a * a) - ma * ma
    sbb = blur(b * b) - mb * mb
    sab = blur(a * b) - ma * mb
    k1, k2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ma * mb + k1) * (2 * sab + k2)
         / ((ma * ma + mb * mb + k1) * (saa + sbb + k2)))
    return s.mean()


def composite(gt_rgba: torch.Tensor, background: torch.Tensor):
    a = gt_rgba[..., 3:4]
    return a * gt_rgba[..., :3] + (1 - a) * background


def loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return 0.8 * (pred - gt).abs().mean() + 0.2 * (1.0 - ssim(pred, gt))


# ---------------------------------------------------------------------------
# optimiser and charts
# ---------------------------------------------------------------------------

def learning_rate(leaf: str, count: int, st: Settings) -> float:
    if leaf == "means":
        f = min(max(count / st.max_steps, 0.0), 1.0)
        return math.exp(math.log(st.xyz_lr) * (1 - f)
                        + math.log(st.xyz_lr_final) * f)
    return GROUP_LR[leaf]


def adam(params: dict, grads: dict, moments: dict, count: int,
         st: Settings) -> None:
    """One update of every leaf that has a gradient; ``count`` updates
    were made before it."""
    c = count + 1
    bc1 = 1.0 - BETA1 ** c
    bc2 = 1.0 - BETA2 ** c
    with torch.no_grad():
        for k, g in grads.items():
            if g is None:
                continue
            m, v = moments[k]
            m.mul_(BETA1).add_(g, alpha=1 - BETA1)
            v.mul_(BETA2).add_(g * g, alpha=1 - BETA2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            params[k].sub_(learning_rate(k, count, st) * upd)


def chart_dims(log_scales: torch.Tensor, st: Settings, pad):
    """The texel scale whose charts sum(ceil(sf*l0/s) * ceil(sf*l1/s)),
    each clamped to ``pad``, meet ``pixel_num`` within 0.1 % (bisected
    from the bracket [10, sqrt(sum sf^2 l0 l1 / budget)], halving the
    upper end until it holds enough), the charts' dims and uv mappings."""
    sf = st.sigma_factor
    scale = torch.exp(log_scales.detach()).clamp(min=1e-9)
    l0, l1 = scale[:, 0], scale[:, 1]
    dev = log_scales.device
    target = float(st.pixel_num)

    def dims(s):
        return (torch.clamp(torch.ceil(sf * l0 / s), 1, pad[0]),
                torch.clamp(torch.ceil(sf * l1 / s), 1, pad[1]))

    def texels(s):
        h, w = dims(s)
        return float((h * w).sum())

    lo = torch.tensor(10.0, device=dev)
    hi = torch.sqrt((sf * sf * l0 * l1).sum() / target)
    while texels(hi) < target and float(hi) > 1e-8:
        hi = hi * 0.5
    mid = 0.5 * (lo + hi)
    for _ in range(31):
        n = texels(mid)
        if (1 - 1e-3) * target <= n <= (1 + 1e-3) * target:
            break
        if n < (1 - 1e-3) * target:
            lo = mid
        else:
            hi = mid
        mid = 0.5 * (lo + hi)
    h, w = dims(mid)
    mappings = torch.stack([1 / (2 * sf * l0), 1 / (2 * sf * l1)], -1)
    return torch.stack([h, w], -1).to(torch.int32), mappings, mid


def resample(texture: torch.Tensor, old_hw, new_hw) -> torch.Tensor:
    """Every chart resampled bilinearly from its old active size to its new
    one (texel (a, b) of the new chart at uv (a/h', b/w')); zero outside
    the new active region."""
    n, ch, cw, _ = texture.shape
    dev = texture.device
    a = torch.arange(ch, device=dev, dtype=torch.float32)[None, :, None]
    b = torch.arange(cw, device=dev, dtype=torch.float32)[None, None, :]
    nh, nw = (new_hw[:, i, None, None].to(torch.float32) for i in (0, 1))
    oh, ow = (old_hw[:, i, None, None].to(torch.float32) for i in (0, 1))
    x = torch.minimum(torch.clamp(a / nh * oh, min=0.0), oh - 1)
    y = torch.minimum(torch.clamp(b / nw * ow, min=0.0), ow - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x1, y1 = torch.minimum(x0 + 1, oh - 1), torch.minimum(y0 + 1, ow - 1)
    flat = texture.reshape(-1, 3)
    row = torch.arange(n, device=dev)[:, None, None] * ch

    def at(xi, yi):
        return flat[(row + xi.long()) * cw + yi.long()]

    out = ((1 - fx) * ((1 - fy) * at(x0, y0) + fy * at(x0, y1))
           + fx * ((1 - fy) * at(x1, y0) + fy * at(x1, y1)))
    active = (a < nh) & (b < nw)
    return torch.where(active[..., None], out, 0.0)


def rechart(params: dict, buffers: dict, moments: dict, st: Settings):
    """New chart dims, mappings and texel scale from the current scales;
    the texture resampled to them and its Adam moments zeroed."""
    pad = tuple(params["texture"].shape[1:3])
    hw, mappings, scale = chart_dims(params["log_scales"], st, pad)
    with torch.no_grad():
        params["texture"].copy_(resample(params["texture"],
                                         buffers["texture_hw"], hw))
        for m in moments["texture"]:
            m.zero_()
    buffers.update(texture_hw=hw, mappings=mappings, pixel_scale=scale)


def initial_buffers(params: dict, st: Settings) -> dict:
    pad = tuple(params["texture"].shape[1:3])
    hw, mappings, scale = chart_dims(params["log_scales"], st, pad)
    return {"texture_hw": hw, "mappings": mappings, "pixel_scale": scale}


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@dataclass
class StepRecord:
    loss: float
    grads: dict


def train_step(params: dict, buffers: dict, moments: dict, count: int,
               step: int, view: View, gt_rgba: torch.Tensor,
               background: torch.Tensor, st: Settings) -> StepRecord:
    """One step: render, loss, gradients, Adam. Returns the loss and the
    gradients the update used."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    gt = composite(gt_rgba, background)
    pred, _ = render(leaves, buffers, view, step, st, background)
    value = loss(pred, gt)
    grads = torch.autograd.grad(value, [leaves[k] for k in LEAVES],
                                allow_unused=True)
    grads = dict(zip(LEAVES, grads))
    adam(params, grads, moments, count, st)
    return StepRecord(float(value.detach()), grads)


def follow(params0: dict, views, gts, step0: int, background, st: Settings,
           chunks):
    """The training steps from ``params0`` (copied) at step ``step0``,
    with zero Adam moments and ``step0`` updates counted: ``chunks`` gives
    the steps between the trainer's cadence points; after a chunk whose
    last step is a multiple of ``chart_every`` the charts are rebuilt.
    Returns the per-step records and the final params."""
    params = {k: v.clone() for k, v in params0.items()}
    buffers = initial_buffers(params, st)
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in params.items()}
    records, step, i = [], step0, 0
    for n in chunks:
        for _ in range(n):
            records.append(train_step(params, buffers, moments, step, step,
                                      views[i], gts[i], background, st))
            step += 1
            i += 1
        last = step - 1
        if last > 0 and last % st.chart_every == 0:
            rechart(params, buffers, moments, st)
    return records, params
