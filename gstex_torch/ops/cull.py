"""Conservative per-(gaussian, tile) alpha cull (counterpart of
``gstex_tpu/ops/cull.py``).

A pair is dropped only when it provably contributes weight exactly 0 to
every pixel of the tile: the hit coordinates u, v and depth t are
linear-fractional in the continuous pixel coordinates, so on a tile whose
corners share the sign of the denominator their extrema sit at the four
corners, and the screen-space AA term is bounded by the point-to-rect
distance. When the denominator changes sign across the tile the pair is
kept. The rendered output is the same with and without the cull.
"""

from __future__ import annotations

import torch

from .binning import TileGrid
from .camera import Camera, camera_origin, camera_rotation_gsplat
from .surfel import AA_SIGMA2, ALPHA_CUTOFF, EXTENT_SIGMA, SplatGeom

# safety margin on squared-radius comparisons: the corner math here and
# the kernel's per-pixel math may round differently; cull only when the
# bound clears the threshold by this much
_R2_MARGIN = 1e-3


class PairCull:
    """``keep = cull(gid, tx, ty)`` for ``build_tile_bins_flat``.

    ``table`` holds the per-gaussian coefficients (N, 18);
    ``eval_rows_t(rowT, tx, ty)`` evaluates the cull on gathered,
    transposed rows (18, P) and tile coords (P,) — the fused form the
    JAX binning stage gathers once per pair.
    """

    def __init__(self, geom: SplatGeom, cam: Camera, grid: TileGrid,
                 px_offset=(0.0, 0.0)):
        self.cam = cam
        self.grid = grid
        self.off_x, self.off_y = (float(v) for v in px_offset)
        origin = camera_origin(cam.c2w)
        rot = camera_rotation_gsplat(cam.c2w)         # (3,3) cam->world
        # corner ray dirs are d = dxc*rot[:,0] + dyc*rot[:,1] + rot[:,2],
        # so every dot with a gaussian vector is affine in (dxc, dyc)
        om = origin - geom.mean
        nd_coef = geom.normal @ rot
        b1_coef = geom.ax1 @ rot
        b2_coef = geom.ax2 @ rot
        numer = -(om * geom.normal).sum(-1)
        a1 = (om * geom.ax1).sum(-1)
        a2 = (om * geom.ax2).sum(-1)
        # alpha cutoff radii (sigma^2 units): op*exp(-r2/2) < 1/255
        # <=> r2 > 2*ln(op*255); g_surf is also zero past the ellipse
        log_term = 2.0 * torch.log(
            torch.clamp(geom.opacity, min=1e-12) / ALPHA_CUTOFF)
        surf_th = torch.clamp(log_term, max=EXTENT_SIGMA * EXTENT_SIGMA)
        screen_th = AA_SIGMA2 * log_term
        self.table = torch.stack([
            nd_coef[:, 0], nd_coef[:, 1], nd_coef[:, 2],
            b1_coef[:, 0], b1_coef[:, 1], b1_coef[:, 2],
            b2_coef[:, 0], b2_coef[:, 1], b2_coef[:, 2],
            numer, a1, a2,
            1.0 / geom.l0, 1.0 / geom.l1,
            surf_th, screen_th,
            geom.xy[:, 0], geom.xy[:, 1],
        ], dim=1)                                     # (N, 18)

    def eval_rows_t(self, rowT: torch.Tensor, tx: torch.Tensor,
                    ty: torch.Tensor) -> torch.Tensor:
        """Keep mask (P,) for pre-gathered rows (18, P) and tile coords."""
        cam, grid = self.cam, self.grid
        coef = lambda c: rowT[c]                      # (P,)
        # pixel-center rect covered by the tile, in continuous px coords
        x0 = tx.to(torch.float32) * grid.tile_w - 0.5 + self.off_x
        x1 = x0 + grid.tile_w
        y0 = ty.to(torch.float32) * grid.tile_h - 0.5 + self.off_y
        y1 = y0 + grid.tile_h

        cxs = torch.stack([x0, x1, x0, x1])           # (4, P)
        cys = torch.stack([y0, y0, y1, y1])
        dxc = (cxs + 0.5 - cam.cx) / cam.fx
        dyc = (cys + 0.5 - cam.cy) / cam.fy

        def affine(c0, c1, c2):
            return coef(c0) * dxc + coef(c1) * dyc + coef(c2)

        denom = affine(0, 1, 2)                       # (4, P) n.d
        same_sign = ((denom > 1e-9).all(0) | (denom < -1e-9).all(0))
        safe_denom = torch.where(denom.abs() < 1e-9,
                                 torch.full_like(denom, 1e-9), denom)
        t = coef(9) / safe_denom
        u = (coef(10) + t * affine(3, 4, 5)) * coef(12)
        v = (coef(11) + t * affine(6, 7, 8)) * coef(13)

        def interval_dist0(c):
            lo = c.min(0).values
            hi = c.max(0).values
            return torch.clamp(torch.maximum(lo, -hi), min=0.0)

        r2_min = interval_dist0(u) ** 2 + interval_dist0(v) ** 2
        surf_dead = r2_min > coef(14) + _R2_MARGIN

        xyx, xyy = coef(16), coef(17)
        ddx = torch.clamp(torch.maximum(x0 - xyx, xyx - x1), min=0.0)
        ddy = torch.clamp(torch.maximum(y0 - xyy, xyy - y1), min=0.0)
        screen_dead = ddx * ddx + ddy * ddy > coef(15) + _R2_MARGIN

        # t <= 1e-6 zeroes both terms; t extrema are at the corners under
        # the same-sign guarantee
        t_dead = t.max(0).values <= 1e-6
        dead = t_dead | (surf_dead & screen_dead)
        return ~(same_sign & dead)

    def __call__(self, gid: torch.Tensor, tx: torch.Tensor,
                 ty: torch.Tensor) -> torch.Tensor:
        return self.eval_rows_t(self.table[gid].T, tx, ty)


def make_pair_cull(geom: SplatGeom, cam: Camera, grid: TileGrid,
                   px_offset=(0.0, 0.0)) -> PairCull:
    """The conservative pair cull for one camera and tile grid;
    ``px_offset`` is the global pixel offset of the grid's origin."""
    return PairCull(geom, cam, grid, px_offset)
