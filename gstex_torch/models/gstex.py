"""GStex model: parameters, chart budgeting and the eval render
(counterpart of ``gstex_tpu/models/gstex.py``).

Parameters are NamedTuples of tensors with the JAX package's field names
and layouts, so one scene feeds both packages. ``render`` supports the
forward-only flat path that serves trained scenes; the training forward,
the dense tile lists, the uv channels, the bf16 texel stream and the
per-pixel oracle arrive with later slices of the port and raise
``NotImplementedError`` here, naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import sh as sh_ops
from ..ops.binning import TileGrid, build_tile_bins_flat
from ..ops.camera import Camera
from ..ops.cull import make_pair_cull
from ..ops.prepare import activate_scales, prepare_splats
from ..ops.rasterize_api import rasterize_pl5_eval


class GStexParams(NamedTuple):
    """Trainable leaves."""

    means: torch.Tensor           # (N,3)
    log_scales: torch.Tensor      # (N,2)
    quats: torch.Tensor           # (N,4) wxyz
    opacity_logits: torch.Tensor  # (N,1)
    features_dc: torch.Tensor     # (N,3)
    features_rest: torch.Tensor   # (N,K-1,3)
    texture: torch.Tensor         # (N,Ch,Cw,3) dense padded charts


class GStexBuffers(NamedTuple):
    """Non-trainable state."""

    texture_hw: torch.Tensor   # (N,2) int32 active chart dims
    mappings: torch.Tensor     # (N,2) chart uv scales
    pixel_scale: torch.Tensor  # () float32
    test_colors: torch.Tensor  # (N,3) eval visualization colors


@dataclasses.dataclass(frozen=True)
class GStexConfig:
    """The JAX package's ``GStexConfig``, field for field, so its
    ``config.json`` model block loads here unchanged."""

    sh_degree: int = 3
    sh_degree_interval: int = 1000
    ssim_lambda: float = 0.2
    pixel_num: float = 1e6
    sigma_factor: float = 3.0
    build_chart_every: int = 100
    background_color: str = "random"   # random | black | white
    lambda_normal: Union[float, Sequence[float]] = 0.0
    lambda_reg: Union[float, Sequence[float]] = 0.0
    use_normal_loss: bool = False
    fix_init: bool = False
    num_downscales: int = 0
    resolution_schedule: int = 250
    chart_pad: Optional[tuple[int, int]] = (8, 8)
    chart_pad_max: tuple[int, int] = (128, 128)
    chart_pad_headroom: float = 1.25
    chart_mem_budget: float = 2e9
    tile_h: int = 32
    tile_w: int = 32
    pair_cap: int = 1 << 20
    s_max: int = 512
    renderer: str = "xla"
    pair_cull: bool = True
    texel_dtype: str = "f32"              # f32 | bf16
    fused_ssim: bool = True

    def grid(self, height: int, width: int) -> TileGrid:
        return TileGrid(height=height, width=width, tile_h=self.tile_h,
                        tile_w=self.tile_w)


# renderers that name the flat pair-list kernel path; "_interpret" is the
# JAX package's CPU mode of the same path, which here is the plain version
# any CPU tensor takes
FLAT_RENDERERS = ("pallas", "pallas5", "pallas_interpret",
                  "pallas5_interpret")


def active_sh_degree(cfg: GStexConfig, step: int) -> int:
    """SH degree schedule: min(step // sh_degree_interval, sh_degree)."""
    return min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)


# ---------------------------------------------------------------------------
# chart budgeting
# ---------------------------------------------------------------------------

def resolve_chart_pad(cfg: GStexConfig,
                      log_scales: torch.Tensor) -> tuple[int, int]:
    """Scene-adaptive dense chart pad: the unclamped texel-budget search's
    max (h, w) with headroom, rounded up to a multiple of 8, shrunk to the
    storage budget and capped at ``chart_pad_max``."""
    hw, _, _ = build_charts(cfg, log_scales, pad=(100000, 100000))
    h = float(hw[:, 0].max()) * cfg.chart_pad_headroom
    w = float(hw[:, 1].max()) * cfg.chart_pad_headroom
    area_cap = cfg.chart_mem_budget / (log_scales.shape[0] * 12.0)
    if h * w > area_cap:
        sc = float(np.sqrt(area_cap / (h * w)))
        h, w = max(h * sc, 1.0), max(w * sc, 1.0)
    rnd = lambda v: max(8, -(-int(np.ceil(v)) // 8) * 8)
    return (min(rnd(h), cfg.chart_pad_max[0]),
            min(rnd(w), cfg.chart_pad_max[1]))


def build_charts(cfg: GStexConfig, log_scales: torch.Tensor,
                 update_pixel_scale: bool = True,
                 pixel_scale: Optional[torch.Tensor] = None,
                 pad: Optional[tuple[int, int]] = None):
    """Binary-search the global texel scale so Σ ceil(σf·l0/s)·ceil(σf·l1/s)
    meets the ``pixel_num`` budget within 0.1%, then derive per-gaussian
    chart dims (clamped to ``pad``) and uv mappings.

    Returns (texture_hw (N,2) int32, mappings (N,2), pixel_scale ()).
    """
    sf = cfg.sigma_factor
    if pad is None:
        pad = cfg.chart_pad
        if pad is None:
            raise ValueError("build_charts needs an explicit pad when "
                             "cfg.chart_pad is auto (None)")
    ch, cw = pad
    l0, l1 = activate_scales(log_scales.detach())
    dev = log_scales.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    target = float(cfg.pixel_num)
    mappings = torch.stack([1.0 / (2.0 * sf * l0), 1.0 / (2.0 * sf * l1)],
                           dim=-1)

    def dims_at(scale):
        h = torch.clamp(torch.ceil(sf * l0 / scale), 1, ch)
        w = torch.clamp(torch.ceil(sf * l1 / scale), 1, cw)
        return h, w

    def score(scale):
        h, w = dims_at(scale)
        return float((h * w).sum())

    if target <= 0:
        # one texel per gaussian
        hw = torch.ones((l0.shape[0], 2), dtype=torch.int32, device=dev)
        ps = pixel_scale if pixel_scale is not None else f32(10.0)
        return hw, mappings, ps

    if update_pixel_scale or pixel_scale is None:
        lo = f32(10.0)
        hi = torch.sqrt((sf * sf * l0 * l1).sum() / target)
        # the closed-form hi ignores ceil() and the pad clamp: widen the
        # bracket until hi yields enough texels
        while score(hi) < target and float(hi) > 1e-8:
            hi = hi * 0.5
        tol = 1e-3
        mid = 0.5 * (lo + hi)
        for _ in range(31):
            s = score(mid)
            too_few = s < (1 - tol) * target
            if not too_few and s <= (1 + tol) * target:
                break
            if too_few:
                lo = mid
            else:
                hi = mid
            mid = 0.5 * (lo + hi)
        scale = mid
    else:
        scale = pixel_scale

    h, w = dims_at(scale)
    hw = torch.stack([h, w], dim=-1).to(torch.int32)
    return hw, mappings, scale


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: GStexConfig, means, log_scales2, quats, opacity_logits,
                features_dc, features_rest,
                generator: Optional[torch.Generator] = None):
    """Params and buffers from raw (pre-activation) fields, all tensors on
    one device. The texture dc is features_dc replicated over each active
    chart; ``generator`` draws the test colors (seed 0 when omitted)."""
    dev = means.device
    n = means.shape[0]
    f32 = lambda x: x.to(device=dev, dtype=torch.float32)
    log_scales2 = f32(log_scales2)
    pad = cfg.chart_pad
    if pad is None:
        pad = resolve_chart_pad(cfg, log_scales2)
    ch, cw = pad
    hw, mappings, scale = build_charts(cfg, log_scales2, pad=pad)
    aa = torch.arange(ch, device=dev)[None, :, None]
    bb = torch.arange(cw, device=dev)[None, None, :]
    active = (aa < hw[:, 0, None, None]) & (bb < hw[:, 1, None, None])
    texture = torch.where(active[..., None], f32(features_dc)[:, None, None],
                          0.0)
    params = GStexParams(
        means=f32(means),
        log_scales=log_scales2,
        quats=f32(quats),
        opacity_logits=f32(opacity_logits).reshape(n, 1),
        features_dc=f32(features_dc),
        features_rest=f32(features_rest),
        texture=texture,
    )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    buffers = GStexBuffers(
        texture_hw=hw,
        mappings=mappings,
        pixel_scale=torch.as_tensor(scale, dtype=torch.float32, device=dev),
        test_colors=torch.rand((n, 3), generator=generator, device=dev),
    )
    return params, buffers


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render(cfg: GStexConfig, params: GStexParams, buffers: GStexBuffers,
           cam: Camera, step: int, background: torch.Tensor,
           extra: bool = False, eval_only: bool = False) -> dict:
    """Forward-only render of one view on the flat pair-list path.

    Returns ``rgb`` (composited over ``background`` (3,)), the raw maps,
    and the binning's ``overflow``, ``total_pairs`` and
    ``max_tile_count``.
    """
    if extra:
        raise NotImplementedError(
            "extra=True (uv channels) renders through the pure-torch tier: "
            "ROADMAP Queue 1 item 13")
    if cfg.renderer == "oracle":
        raise NotImplementedError(
            "renderer='oracle' (per-pixel fp32 oracle): ROADMAP Queue 1 "
            "item 3")
    if cfg.renderer not in FLAT_RENDERERS:
        raise NotImplementedError(
            f"renderer={cfg.renderer!r} uses the dense build_tile_bins "
            f"lists or the XLA tier: ROADMAP Queue 1 items 4-5 and Queue 2 "
            f"items 4-12")
    if cfg.texel_dtype == "bf16":
        raise NotImplementedError(
            "texel_dtype='bf16' (bf16 chart stream): ROADMAP Queue 1 item 6")
    if not eval_only:
        raise NotImplementedError(
            "the training forward (eval_only=False) comes with slice 2: "
            "ROADMAP Queue 2 item 1")
    prep = prepare_splats(
        params.means, params.log_scales, params.quats, params.opacity_logits,
        params.features_dc, params.features_rest, buffers.mappings, cam,
        active_sh_degree=active_sh_degree(cfg, step),
        sh_degree=cfg.sh_degree, fix_init=cfg.fix_init,
        extent_sigma=cfg.sigma_factor)
    grid = cfg.grid(cam.height, cam.width)
    cull_fn = (make_pair_cull(prep.geom, cam, grid) if cfg.pair_cull
               else None)
    bins = build_tile_bins_flat(prep.centers, prep.extents, prep.depths,
                                prep.valid, grid, pair_cap=cfg.pair_cap,
                                s_cap=cfg.s_max, cull_fn=cull_fn)
    # texture albedo: SH2RGB(texture_dc) when sh_degree > 0, else sigmoid
    if cfg.sh_degree > 0:
        texture = sh_ops.sh_to_rgb(params.texture)
    else:
        texture = torch.sigmoid(params.texture)
    out = rasterize_pl5_eval(prep.geom, texture, buffers.texture_hw, bins,
                             cam, grid, s_cap=cfg.s_max,
                             background=background)
    out["background"] = background
    out["overflow"] = bins.overflow
    out["total_pairs"] = bins.total_pairs
    out["max_tile_count"] = int(bins.counts.max())
    return out


def sample_background(cfg: GStexConfig,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Per-step training background (3,)."""
    if cfg.background_color == "random":
        return torch.rand(3, generator=generator, device=device)
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    return torch.zeros(3, device=device)
