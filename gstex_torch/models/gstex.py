"""GStex model: parameters, chart budgeting, rendering and losses
(counterpart of ``gstex_tpu/models/gstex.py``).

Parameters are NamedTuples of tensors with the JAX package's field names
and layouts, so one scene feeds both packages. ``render`` chooses among
the flat pair-list kernels, the dense-list kernels (large chart pads,
``renderer="pallas4"``), the pair-space v3, v2 and v1 kernels
(``"pallas3"``, ``"pallas2"``, ``"pallas1"``), the pure-torch tier
(``renderer="xla"``, the uv channels) and the per-pixel oracle,
forward-only for serving (``eval_only=True``) and differentiable for
training. With ``use_normal_loss`` the normal loss holds the rendered
normals against normals estimated from the rendered depth
(``ops/normals.py``). The bf16 texel stream arrives with a later slice of
the port and raises ``NotImplementedError`` here, naming its ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import sh as sh_ops
from ..ops import ssim as ssim_ops
from ..ops import ssim_fused
from ..ops.binning import TileGrid, build_tile_bins, build_tile_bins_flat
from ..ops.camera import Camera
from ..ops.cull import make_pair_cull
from ..ops.normals import depth_to_normal
from ..ops.prepare import activate_scales, prepare_splats
from ..ops.rasterize import rasterize
from ..ops.rasterize_api import (dense_pallas_fits, rasterize_pl,
                                 rasterize_pl5, rasterize_pl5_eval,
                                 rasterize_pl_eval, use_flat_path)
from ..ops.rasterize_ref import render_oracle
from ..ops.surfel import SplatGeom
from ..utils.device import resolve_device


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


# renderers whose training render takes the pair-space kernels, by version
PAIR_TIERS = {"pallas3": 3, "pallas2": 2, "pallas1": 1}


def kernel_version(renderer: str) -> int:
    """The dense-list training kernels a renderer names: 3, 2 and 1 for
    the pair-space tiers (and their ``_interpret`` forms), else 4."""
    for prefix, version in PAIR_TIERS.items():
        if renderer.startswith(prefix):
            return version
    return 4


def lean_losses(cfg: GStexConfig) -> bool:
    """True when the reg and normal loss terms are statically zero (plain
    0 lambdas, no schedules, no normal loss): the kernels then skip the
    distortion and normal chains."""
    def _zero(v):
        return isinstance(v, (int, float)) and float(v) == 0.0

    return (_zero(cfg.lambda_reg) and _zero(cfg.lambda_normal)
            and not cfg.use_normal_loss)


def schedule_value(v, step):
    """lambda_normal / lambda_reg: a float or [v0, v1, switch_step].
    ``step`` is an int, or a 0-d device tensor (a CUDA graph's per-step
    value, ``train/step.py:make_train_scan``), which gives a 0-d float32
    tensor of the same value."""
    if isinstance(v, (int, float)):
        return float(v)
    v0, v1, sw = v
    if isinstance(step, torch.Tensor):
        return torch.where(step >= sw, float(v1), float(v0)).to(
            torch.float32)
    return float(v1) if int(step) >= sw else float(v0)


def active_sh_degree(cfg: GStexConfig, step):
    """SH degree schedule: min(step // sh_degree_interval, sh_degree); a
    0-d tensor for a tensor ``step``, as ``schedule_value``."""
    if isinstance(step, torch.Tensor):
        return torch.clamp(step // cfg.sh_degree_interval,
                           max=cfg.sh_degree)
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


def resample_charts(texture: torch.Tensor, old_hw: torch.Tensor,
                    new_hw: torch.Tensor) -> torch.Tensor:
    """Bilinear-resample every chart from its old active dims to its new
    ones: new texel (a, b) sits at uv = (a/h', b/w') and samples the old
    chart (``surfel.chart_sample_bilinear``, batched over gaussians).
    Texels outside the new active region are zero."""
    n, ch, cw, _ = texture.shape
    dev = texture.device
    aa = torch.arange(ch, device=dev)[None, :, None]
    bb = torch.arange(cw, device=dev)[None, None, :]
    nh = new_hw[:, 0, None, None]
    nw = new_hw[:, 1, None, None]
    oh = old_hw[:, 0, None, None].long()
    ow = old_hw[:, 1, None, None].long()
    hf, wf = oh.to(torch.float32), ow.to(torch.float32)
    x = torch.minimum(torch.clamp(aa / nh.to(torch.float32) * hf, min=0.0),
                      hf - 1.0)
    y = torch.minimum(torch.clamp(bb / nw.to(torch.float32) * wf, min=0.0),
                      wf - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.minimum(x0i + 1, oh - 1)
    y1i = torch.minimum(y0i + 1, ow - 1)
    flat = texture.reshape(-1, 3)
    row = torch.arange(n, device=dev)[:, None, None] * ch

    def at(xi, yi):
        return flat[(row + xi) * cw + yi]

    vals = ((1 - fx) * ((1 - fy) * at(x0i, y0i) + fy * at(x0i, y1i))
            + fx * ((1 - fy) * at(x1i, y0i) + fy * at(x1i, y1i)))
    active = (aa < nh) & (bb < nw)
    return torch.where(active[..., None], vals, 0.0)


def rechart(cfg: GStexConfig, params: GStexParams, buffers: GStexBuffers):
    """The every-``build_chart_every``-steps re-chart: re-budget the
    charts, resample the texture, refresh the mappings. Shapes stay: dims
    clamp to the texture's storage pad."""
    new_hw, mappings, scale = build_charts(
        cfg, params.log_scales, pad=tuple(params.texture.shape[1:3]))
    new_texture = resample_charts(params.texture.detach(),
                                  buffers.texture_hw, new_hw)
    params = params._replace(texture=new_texture)
    buffers = buffers._replace(texture_hw=new_hw, mappings=mappings,
                               pixel_scale=torch.as_tensor(
                                   scale, dtype=torch.float32,
                                   device=new_hw.device))
    return params, buffers


def texel_count(buffers: GStexBuffers) -> int:
    """Σ h·w over the active charts."""
    hw = buffers.texture_hw.long()
    return int((hw[:, 0] * hw[:, 1]).sum())


def downscale_factor(cfg: GStexConfig, step: int) -> int:
    """Training-resolution schedule: 2^max(num_downscales − step //
    resolution_schedule, 0)."""
    return 2 ** max(cfg.num_downscales - step // cfg.resolution_schedule, 0)


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
           extra: bool = False, eval_only: bool = False,
           albedo: Optional[torch.Tensor] = None,
           grid: Optional[TileGrid] = None, px_offset=(0.0, 0.0)) -> dict:
    """Render one view, differentiable in the params unless the caller
    holds ``torch.no_grad``. ``albedo`` (N, Ch, Cw, 3), given, takes the
    place of the texture's albedo (the edited charts of texture painting).
    ``grid`` and ``px_offset``, given, render one band of the view: the
    grid's rows and columns of pixels from ``px_offset`` (x, y) on, as a
    device of the tile-row mesh does (``parallel/shard.py``); the tier is
    chosen as for the whole view, since the rule keys on tile pixels.
    ``cfg.renderer`` names the tier:

    - ``"pallas"`` / ``"pallas5"``: the flat pair-list kernels where they
      take the chart pad (``use_flat_path``), else the dense-list kernels;
    - ``"pallas4"``: the dense-list kernels;
    - ``"pallas3"`` / ``"pallas2"`` / ``"pallas1"``: the dense lists,
      trained through the pair-space v3 (chunk-scan), v2 or v1 (serial)
      kernels; their ``eval_only`` renders take the dense-list eval
      kernel, as the JAX package's take its v4 eval kernel;
    - ``"xla"``: the pure-torch tile renderer, which also serves
      ``extra=True`` (the uv channels) for every kernel renderer;
    - ``"oracle"``: the per-pixel referee, with no binning.

    An ``_interpret`` suffix is the JAX package's CPU mode of a kernel
    tier; here any CPU tensor takes a kernel's plain version. With
    ``eval_only=True`` the kernel tiers run their forward-only kernel.

    Returns ``rgb`` (composited over ``background`` (3,)), the raw maps
    (plus ``normal`` and ``reg`` unless a kernel tier renders
    ``eval_only``), and the binning's ``overflow``, ``total_pairs`` and
    ``max_tile_count``; with ``cfg.use_normal_loss`` also
    ``estimated_normals`` (H, W, 3), from the detached depth map.
    """
    renderer = cfg.renderer
    if not (renderer in ("oracle", "xla") or renderer.startswith("pallas")):
        raise ValueError(f"unknown renderer {renderer!r}")
    if cfg.texel_dtype == "bf16":
        raise NotImplementedError(
            "texel_dtype='bf16' (bf16 chart stream): ROADMAP Queue 1 item 6")
    # the "gstex.*" ranges name the stages in a torch.profiler trace
    with record_function("gstex.prepare"):
        prep = prepare_splats(
            params.means, params.log_scales, params.quats,
            params.opacity_logits, params.features_dc, params.features_rest,
            buffers.mappings, cam,
            active_sh_degree=active_sh_degree(cfg, step),
            sh_degree=cfg.sh_degree, fix_init=cfg.fix_init,
            extent_sigma=cfg.sigma_factor)

    def texture_albedo():
        # texture albedo: SH2RGB(texture_dc) when sh_degree > 0, else
        # sigmoid
        if albedo is not None:
            return albedo
        with record_function("gstex.records"):
            if cfg.sh_degree > 0:
                return sh_ops.sh_to_rgb(params.texture)
            return torch.sigmoid(params.texture)

    banded = grid is not None
    if banded and (renderer == "oracle" or cfg.use_normal_loss):
        raise ValueError("a band is rendered through tiles (the oracle has "
                         "none), and without the whole frame's depth that "
                         "use_normal_loss's estimated normals need")
    if renderer == "oracle":
        # no binning, no capacities: it cannot overflow
        out = render_oracle(prep.geom, texture_albedo(), buffers.texture_hw,
                            cam, extra_channels=extra)
        stats = dict(overflow=0, total_pairs=0, max_tile_count=0)
    else:
        if not banded:
            grid = cfg.grid(cam.height, cam.width)
        pad = tuple(params.texture.shape[1:3])
        # flat or dense is one decision per (renderer, pad, tile size), the
        # same for training and eval. Where neither kernel tier takes the
        # shapes, the pure-torch tier does.
        use_flat = not extra and use_flat_path(renderer, pad,
                                               grid.tile_h * grid.tile_w)
        kernels = renderer.startswith("pallas") and not extra
        if (kernels and not use_flat
                and not dense_pallas_fits(pad, cfg.s_max)):
            kernels = False
        with record_function("gstex.cull_binning"):
            # binning and the cull see detached geometry: no gradient flows
            # through the pair lists
            geom_d = SplatGeom(*(x.detach() for x in prep.geom))
            cull_fn = (make_pair_cull(geom_d, cam, grid, px_offset)
                       if cfg.pair_cull else None)
            binning = build_tile_bins_flat if use_flat else build_tile_bins
            bins = binning(prep.centers.detach(), prep.extents.detach(),
                           prep.depths.detach(), prep.valid, grid,
                           cfg.pair_cap, cfg.s_max, cull_fn=cull_fn,
                           origin=_tile_origin(px_offset, grid))
        texture = texture_albedo()
        hw = buffers.texture_hw
        if use_flat and eval_only:
            out = rasterize_pl5_eval(prep.geom, texture, hw, bins, cam, grid,
                                     s_cap=cfg.s_max, px_offset=px_offset,
                                     background=background)
        elif use_flat:
            out = rasterize_pl5(prep.geom, texture, hw, bins, cam, grid,
                                s_cap=cfg.s_max, px_offset=px_offset,
                                lean=lean_losses(cfg), background=background)
        elif kernels and eval_only:
            out = rasterize_pl_eval(prep.geom, texture, hw, bins, cam, grid,
                                    px_offset=px_offset,
                                    background=background)
        elif kernels:
            out = rasterize_pl(prep.geom, texture, hw, bins, cam, grid,
                               px_offset=px_offset,
                               version=kernel_version(renderer),
                               lean=lean_losses(cfg), background=background,
                               pair_cap=cfg.pair_cap)
        else:
            with record_function("gstex.torch_tier"):
                out = rasterize(prep.geom, texture, hw, bins, cam, grid,
                                extra_channels=extra, px_offset=px_offset)
        stats = dict(overflow=bins.overflow, total_pairs=bins.total_pairs,
                     max_tile_count=bins.counts.max())
    if "rgb" not in out:
        rgb = out["img"] + out["texture_rgb"] + (
            1.0 - out["alpha"][..., None]) * background[None, None, :]
        out["rgb"] = torch.clamp(rgb, 0.0, 1.0)
    out["background"] = background
    out.update(stats)
    if cfg.use_normal_loss:
        with record_function("gstex.normals"):
            out["estimated_normals"] = depth_to_normal(
                out["depth"].detach(), cam)
    return out


def _tile_origin(px_offset, grid: TileGrid) -> tuple[int, int]:
    """A band's pixel offset in whole tiles of ``grid``: its tile ranges
    are the frame's less this origin (``binning.tile_ranges``)."""
    ox, oy = (float(v) for v in px_offset)
    if ox % grid.tile_w or oy % grid.tile_h:
        raise ValueError(f"a band's pixel offset {px_offset} must be whole "
                         f"tiles of {grid.tile_w}x{grid.tile_h}")
    return int(ox) // grid.tile_w, int(oy) // grid.tile_h


@torch.no_grad()
def render_eval_images(cfg: GStexConfig, params: GStexParams,
                       buffers: GStexBuffers, cam: Camera, step: int,
                       background: torch.Tensor,
                       edit_texture: Optional[torch.Tensor] = None) -> dict:
    """The full eval image set: ``rgb``, ``depth`` and ``accumulation``
    (H, W, 1), ``test`` (the random test colours at opacities thresholded
    at 0.5), ``uv``, ``only_rgb``, ``only_texture``, ``clean_normal_img``,
    ``normal_im``, ``reg`` (H, W, 1), ``background`` and ``edit``, as the
    JAX package's ``render_eval_images``. The maps come from the
    ``extra=True`` render (the pure-torch tier, which has the uv
    channels). ``edit`` is the view with the edited RGB charts
    ``edit_texture`` (else ``rgb``): clip(img + tex(edited) + (1 − α)·bg),
    which is the ``rgb`` the tier's eval render composes with that albedo,
    so on the kernel tiers it comes from the eval kernel."""
    outputs = render(cfg, params, buffers, cam, step, background,
                     extra=True)
    bg = background[None, None, :]
    alpha1 = outputs["alpha"][..., None]
    # the test render: random per-gaussian colours, opacities 1 above 0.5
    # and 0 below (the reference zeroes <= 0.5, then promotes > 0.2 of
    # what is left)
    test_logits = torch.where(torch.sigmoid(params.opacity_logits) > 0.5,
                              40.0, -40.0)
    tmaps = _test_color_img(cfg, params._replace(opacity_logits=test_logits),
                            buffers, cam)
    images = {
        "rgb": outputs["rgb"],
        "depth": outputs["depth"][..., None],
        "accumulation": alpha1,
        "test": torch.clamp(tmaps["img"] + (1.0 - tmaps["alpha"][..., None])
                            * bg, 0.0, 1.0),
        "uv": torch.clamp(outputs["uv"] + (1.0 - alpha1) * bg, 0.0, 1.0),
        "only_rgb": torch.clamp(outputs["img"] + 0.5, 0.0, 1.0),
        "only_texture": torch.clamp(outputs["texture_rgb"], 0.0, 1.0),
        "clean_normal_img": torch.clamp(
            0.5 * (outputs["normal"] + 1.0) + (1.0 - alpha1) * bg, 0.0, 1.0),
        "normal_im": outputs["normal"],
        "reg": outputs["reg"][..., None],
        "background": background,
    }
    if edit_texture is not None:
        images["edit"] = render(cfg, params, buffers, cam, step, background,
                                eval_only=True, albedo=edit_texture)["rgb"]
    else:
        images["edit"] = outputs["rgb"]
    return images


def _test_color_img(cfg: GStexConfig, test_params: GStexParams,
                    buffers: GStexBuffers, cam: Camera) -> dict:
    """Σ w·test_colour over the charts-free blend, at the given (test)
    opacities: the pure-torch tier's maps."""
    prep = prepare_splats(
        test_params.means, test_params.log_scales, test_params.quats,
        test_params.opacity_logits, test_params.features_dc,
        test_params.features_rest, buffers.mappings, cam,
        active_sh_degree=0, sh_degree=0, fix_init=cfg.fix_init,
        extent_sigma=cfg.sigma_factor)
    geom = prep.geom._replace(rgb=buffers.test_colors)
    grid = cfg.grid(cam.height, cam.width)
    bins = build_tile_bins(prep.centers, prep.extents, prep.depths,
                           prep.valid, grid, cfg.pair_cap, cfg.s_max)
    return rasterize(geom, torch.zeros_like(test_params.texture),
                     buffers.texture_hw, bins, cam, grid)


def composite_gt(image: torch.Tensor,
                 background: torch.Tensor) -> torch.Tensor:
    """Alpha-composite RGBA ground truth over the background."""
    if image.shape[-1] == 4:
        a = image[..., 3:4]
        return a * image[..., :3] + (1 - a) * background[None, None, :]
    return image


def loss_fn(cfg: GStexConfig, outputs: dict, gt_rgb: torch.Tensor,
            step: int, mask: Optional[torch.Tensor] = None):
    """0.8·L1 + 0.2·(1−SSIM) + normal + reg; returns (total, parts)."""
    pred = outputs["rgb"]
    gt = gt_rgb
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    l1 = (gt - pred).abs().mean()
    if cfg.fused_ssim and ssim_fused.fused_ssim_supported(tuple(pred.shape)):
        # gradient with respect to the render only
        simloss = 1.0 - ssim_fused.fused_ssim(pred, gt, 1.0)
    else:
        simloss = 1.0 - ssim_ops.ssim(gt, pred)
    zero = torch.zeros((), device=pred.device)
    if lean_losses(cfg):
        normal_loss = reg_loss = zero
    else:
        lam_n = schedule_value(cfg.lambda_normal, step)
        lam_r = schedule_value(cfg.lambda_reg, step)
        # normal loss: mean(α − n·n̂); with use_normal_loss n̂ is
        # estimated from the (detached) depth map, else n̂ = n
        estimated = outputs.get("estimated_normals", outputs["normal"])
        normal_loss = lam_n * (outputs["alpha"] - (
            outputs["normal"] * estimated).sum(-1)).mean()
        reg_loss = lam_r * outputs["reg"].mean()
    main = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * simloss
    total = main + normal_loss + reg_loss
    return total, {"main_loss": main, "l1": l1, "ssim_loss": simloss,
                   "normal_loss": normal_loss, "reg_loss": reg_loss}


def sample_background(cfg: GStexConfig,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Per-step training background (3,), on the card unless ``device``
    says otherwise (a ``generator`` must live on that device)."""
    device = resolve_device(device)
    if cfg.background_color == "random":
        return torch.rand(3, generator=generator, device=device)
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    return torch.zeros(3, device=device)
