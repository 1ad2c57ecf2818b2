"""Scene sources for the port (counterpart of
``gstex_tpu/models/init_io.py``): the init paths of
``GStexModel.populate_modules`` (reference ``nerfstudio/models/gstex.py:
241-377``) as raw (pre-activation) parameter dicts for
``models.gstex.init_params``: a pre-trained 2DGS ply
(``raw_from_gaussian_ply``), a point npz (``raw_from_npz``), seed points
from a dataset, a LOD ply or a point cloud (``raw_from_points``), random
points (``raw_random``); whole scenes with their charts from the
port's own dumps (``params_from_export_npz``, ``params_from_scene_stats``,
``load_scene_npz``); and the exports of a trained scene (the reference's
``exporter.py``): a gstex-npz dump (``export_npz``), an average-colour
point ply (``export_ply``), a 2DGS gaussian ply (``export_gaussian_ply``)
and a trained-scene-statistics file (``export_scene_stats``), each in the
JAX package's layout, so either package reads the other's.

Random draws use an explicit ``torch.Generator`` where the JAX package
takes a key: the values differ from ``jax.random``'s. Seed-point init
draws only the rotations, which a caller may pass in instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quat import fix_init_points, fix_init_rotation, random_quats
from ..ops.sh import num_sh_bases, rgb_to_sh, sh_to_rgb
from ..utils import ply as ply_io
from ..utils.device import resolve_device
from . import gstex as model


def knn_mean_dist(points: torch.Tensor, k: int = 3,
                  chunk: int = 2048) -> torch.Tensor:
    """Mean distance of each point to its k nearest neighbours (itself
    left out): the scale init of ``k_nearest_sklearn`` (reference
    ``gstex.py:285-288,775-793``), by brute force in chunks of queries
    with ``torch.topk``, on the points' device."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    k_eff = min(k, max(n - 1, 1))
    out = []
    for i in range(0, n, chunk):
        q = pts[i:i + chunk]
        d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        # the k+1 smallest (the zero self-distance among them), self dropped
        near, _ = torch.topk(d2, k_eff + 1, dim=1, largest=False)
        out.append(torch.sqrt(torch.clamp(near[:, 1:], min=0.0)).mean(-1))
    return torch.cat(out) if out else pts.new_zeros((0,))


def _f32(a, dev) -> torch.Tensor:
    """An array or tensor as float32 on ``dev``."""
    if torch.is_tensor(a):
        return a.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def raw_from_points(points, colors_255, sh_degree: int = 3,
                    generator: torch.Generator | None = None, opacity=None,
                    scales=None, quats=None, fix_init_pts: bool = False,
                    device=None) -> dict:
    """Seed-point init (reference ``gstex.py:278-331``): log-scales from
    the 3-NN mean distance, opacity logit(0.1), uniform random rotations
    drawn with ``generator`` (or ``quats`` as given), dc = RGB2SH(colour /
    255), the rest of the SH zero. ``fix_init_pts`` maps COLMAP axes to
    the model's (``fix_init_points``). A dict of tensors on ``device``."""
    dev = resolve_device(device)
    pts = _f32(points, dev)
    if fix_init_pts:
        pts = fix_init_points(pts)
    n = pts.shape[0]
    if scales is None:
        avg = knn_mean_dist(pts)
        scales = torch.log(torch.clamp(avg, min=1e-7))[:, None].repeat(1, 2)
    if quats is None:
        quats = random_quats(n, generator, device=dev)
    if opacity is None:
        opacity = np.full((n, 1), np.log(0.1 / 0.9), np.float32)
    return {
        "means": pts,
        "log_scales": _f32(scales, dev),
        "quats": _f32(quats, dev),
        "opacity_logits": _f32(opacity, dev).reshape(n, 1),
        "features_dc": rgb_to_sh(_f32(colors_255, dev) / 255.0),
        "features_rest": torch.zeros((n, num_sh_bases(sh_degree) - 1, 3),
                                     device=dev),
    }


def raw_from_gaussian_ply(path, sh_degree: int = 3, fix_init: bool = False,
                          device=None) -> dict:
    """A 2DGS gaussian ply as a raw parameter dict (``load_ply``, reference
    ``gstex.py:608-665``); ``fix_init`` maps COLMAP axes to the model's,
    means and rotations."""
    dev = resolve_device(device)
    g = {k: _f32(v, dev) for k, v in
         ply_io.read_gaussian_ply(path, sh_degree).items()}
    means, quats = g["means"], g["quats"]
    if fix_init:
        means = fix_init_points(means)
        quats = fix_init_rotation(quats)
    return {
        "means": means,
        "log_scales": g["scales"][:, :2],
        "quats": quats,
        "opacity_logits": g["opacity"],
        "features_dc": g["features_dc"],
        "features_rest": g["features_rest"],
    }


def raw_from_npz(path, sh_degree: int = 3, device=None) -> dict:
    """A point npz with ``xyz``, ``colors`` (0-1), ``opacity``, ``scaling``
    and ``rotation`` (reference ``gstex.py:261-270``): every field given,
    nothing drawn."""
    with np.load(path, allow_pickle=True) as d:
        d = dict(d)
    colors = np.clip(255.0 * d["colors"], 1.0, 254.0)
    return raw_from_points(d["xyz"], colors, sh_degree=sh_degree,
                           opacity=d["opacity"], scales=d["scaling"][:, :2],
                           quats=d["rotation"], device=device)


def raw_random(num: int, scale: float = 2.0, sh_degree: int = 3,
               generator: torch.Generator | None = None,
               device=None) -> dict:
    """Random init (reference ``gstex.py:281,299-301,330``): ``num`` points
    uniform in a cube of side ``scale`` with uniform colours and random
    rotations, all drawn with ``generator``."""
    dev = resolve_device(device)
    points = (torch.rand((num, 3), generator=generator, device=dev)
              - 0.5) * scale
    colors = 255.0 * torch.rand((num, 3), generator=generator, device=dev)
    return raw_from_points(points, colors, sh_degree=sh_degree,
                           generator=generator, device=dev)


def _chart_pad(cfg, hw, log_scales):
    """The dense pad: ``cfg.chart_pad``, which must cover the dump's chart
    dims, or with ``chart_pad=None`` the scene's ``resolve_chart_pad``
    grown to cover them."""
    if cfg.chart_pad is None:
        auto = model.resolve_chart_pad(
            cfg, torch.as_tensor(np.asarray(log_scales, np.float32)))
        up8 = lambda v: -(-int(v) // 8) * 8
        return (max(auto[0], up8(hw[:, 0].max())),
                max(auto[1], up8(hw[:, 1].max())))
    ch, cw = cfg.chart_pad
    if hw[:, 0].max() > ch or hw[:, 1].max() > cw:
        raise ValueError(f"chart_pad {cfg.chart_pad} < dump chart dims "
                         f"({hw[:, 0].max()}, {hw[:, 1].max()})")
    return cfg.chart_pad


def params_from_export_npz(cfg: model.GStexConfig, path, seed: int = 0,
                           device=None):
    """(params, buffers) from a ``gstex-export gstex-npz`` dump: raw
    params, the flat jagged texture and its (h, w, offset) dims."""
    dev = resolve_device(device)
    with np.load(path) as d:
        d = dict(d)
    n = d["xyz"].shape[0]
    hw = d["texture_dims"][:, :2].astype(np.int32)
    offsets = d["texture_dims"][:, 2].astype(np.int64)
    ch, cw = _chart_pad(cfg, hw, d["scaling"])
    # scatter the flat jagged texels into the dense (N, Ch, Cw, 3) layout
    sizes = (hw[:, 0] * hw[:, 1]).astype(np.int64)
    owner = np.repeat(np.arange(n), sizes)
    local = np.arange(int(sizes.sum())) - np.repeat(offsets, sizes)
    widths = np.repeat(hw[:, 1], sizes)
    tex = np.zeros((n, ch, cw, 3), np.float32)
    tex[owner, local // widths, local % widths] = d["texture_dc"][
        np.repeat(offsets, sizes) + local]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    params = model.GStexParams(
        means=t(d["xyz"]),
        log_scales=t(d["scaling"]),
        quats=t(d["rotation"]),
        opacity_logits=t(d["opacity"]).reshape(n, 1),
        features_dc=t(d["features_dc"]),
        features_rest=t(d["features_rest"]),
        texture=t(tex),
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    buffers = model.GStexBuffers(
        texture_hw=torch.as_tensor(hw, device=dev),
        mappings=t(d["mappings"]),
        pixel_scale=t(d["pixel_scale"]),
        test_colors=torch.rand((n, 3), generator=gen, device=dev),
    )
    return params, buffers


def params_from_scene_stats(cfg: model.GStexConfig, path, seed: int = 0,
                            device=None):
    """(params, buffers) from a compact trained-scene-statistics dump
    (geometry, opacities, chart dims). Texels and SH are random fills:
    the geometry is the trained scene's, the colors are not."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as d:
        d = dict(d)
    n = d["xyz"].shape[0]
    hw = d["texture_hw"].astype(np.int32)
    ch, cw = _chart_pad(cfg, hw, d["scaling"])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    params = model.GStexParams(
        means=t(d["xyz"]),
        log_scales=t(d["scaling"]),
        quats=t(d["rotation"]),
        opacity_logits=t(d["opacity"]).reshape(n, 1),
        features_dc=0.1 * randn(n, 3),
        features_rest=torch.zeros((n, 15, 3), device=dev),
        texture=0.1 * randn(n, ch, cw, 3),
    )
    buffers = model.GStexBuffers(
        texture_hw=torch.as_tensor(hw, device=dev),
        mappings=t(d["mappings"]),
        pixel_scale=t(d["pixel_scale"]),
        test_colors=torch.rand((n, 3), generator=gen, device=dev),
    )
    return params, buffers


def dump_chart_pad(path) -> tuple[int, int]:
    """The least chart pad, in multiples of 8 and at least (8, 8), that
    holds every chart of a dump of either format."""
    with np.load(path, allow_pickle=False) as d:
        hw = (d["texture_hw"] if "texture_hw" in d.files
              else d["texture_dims"][:, :2])
        top = hw.max(0) if len(hw) else (0, 0)
    return tuple(max(8, -(-int(v) // 8) * 8) for v in top)


def load_scene_npz(cfg: model.GStexConfig, path, seed: int = 0, device=None):
    """Either dump format: a scene-statistics file (it has a ``kind``
    entry) or a full gstex-npz export."""
    with np.load(path, allow_pickle=False) as probe:
        is_stats = "kind" in probe.files
    loader = params_from_scene_stats if is_stats else params_from_export_npz
    return loader(cfg, path, seed=seed, device=device)


def average_chart_colors(texture: torch.Tensor, texture_hw: torch.Tensor,
                         sh_degree: int = 3) -> torch.Tensor:
    """(N, 3) mean albedo of each gaussian over its active chart texels
    (``get_average_colors``, reference ``gstex.py:714-726``)."""
    _, ch, cw, _ = texture.shape
    dev = texture.device
    hw = texture_hw.to(dev)
    active = ((torch.arange(ch, device=dev)[None, :, None] < hw[:, 0, None,
                                                                None])
              & (torch.arange(cw, device=dev)[None, None, :] < hw[:, 1, None,
                                                                  None]))
    vals = sh_to_rgb(texture) if sh_degree > 0 else torch.sigmoid(texture)
    s = torch.sum(vals * active[..., None], dim=(1, 2))
    cnt = torch.sum(active, dim=(1, 2))[:, None]
    return s / torch.clamp(cnt, min=1)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def export_npz(path, params: model.GStexParams, buffers: model.GStexBuffers,
               sh_degree: int = 3) -> None:
    """The gstex-npz dump (reference ``exporter.py``): raw params, the
    active texels as a flat jagged ``texture_dc`` (gaussian after
    gaussian, row-major over each chart's h x w) and ``texture_dims``
    (h, w, offset), the mappings and the pixel scale."""
    hw = _np(buffers.texture_hw).astype(np.int64)
    sizes = hw[:, 0] * hw[:, 1]
    offsets = np.cumsum(sizes) - sizes
    tex = _np(params.texture)
    owner = np.repeat(np.arange(hw.shape[0]), sizes)
    local = np.arange(int(sizes.sum())) - np.repeat(offsets, sizes)
    widths = np.repeat(hw[:, 1], sizes)
    flat = tex[owner, local // np.maximum(widths, 1),
               local % np.maximum(widths, 1)].astype(np.float32)
    np.savez(
        path,
        xyz=_np(params.means),
        scaling=_np(params.log_scales),
        rotation=_np(params.quats),
        opacity=_np(params.opacity_logits),
        features_dc=_np(params.features_dc),
        features_rest=_np(params.features_rest),
        texture_dc=flat.reshape(-1, 3),
        texture_dims=np.concatenate([hw, offsets[:, None]], 1).astype(
            np.int32),
        mappings=_np(buffers.mappings),
        pixel_scale=_np(buffers.pixel_scale),
    )


def export_ply(path, params: model.GStexParams, buffers: model.GStexBuffers,
               sh_degree: int = 3) -> None:
    """The gstex-ply: one point a gaussian at its mean, coloured by its
    chart's average albedo (reference ``exporter.py:42-108``)."""
    avg = _np(average_chart_colors(params.texture, buffers.texture_hw,
                                   sh_degree))
    cols = np.clip(avg * 255.0, 0, 255)
    means = _np(params.means)
    ply_io.write_ply(path, {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2],
    })


def export_gaussian_ply(path, params: model.GStexParams,
                        buffers: model.GStexBuffers,
                        sh_degree: int = 3) -> None:
    """A 2DGS gaussian ply that ``raw_from_gaussian_ply`` reads back:
    position, zero normals, ``f_dc_*``, ``f_rest_*`` channel-major (all of
    one channel's coefficients, then the next's), opacity logit, two log
    scales and the wxyz quaternion."""
    means = _np(params.means)
    n = means.shape[0]
    fields = {"x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
              "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    dc = _np(params.features_dc)
    for i in range(3):
        fields[f"f_dc_{i}"] = dc[:, i]
    rest = _np(params.features_rest)
    rest_cm = rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest_cm.shape[1]):
        fields[f"f_rest_{i}"] = rest_cm[:, i]
    fields["opacity"] = _np(params.opacity_logits)[:, 0]
    scales = _np(params.log_scales)
    for i in range(2):
        fields[f"scale_{i}"] = scales[:, i]
    quats = _np(params.quats)
    for i in range(4):
        fields[f"rot_{i}"] = quats[:, i]
    ply_io.write_ply(path, fields)


def export_scene_stats(path, params: model.GStexParams,
                       buffers: model.GStexBuffers) -> None:
    """A compact trained-scene-statistics file (``params_from_scene_stats``
    reads it): what sets the rasterizer's cost, the geometry, opacities,
    mappings in float16 and the chart dims, and not the texels or SH
    coefficients, which the loader fills at random."""
    np.savez_compressed(
        path,
        kind=np.asarray("scene_stats"),
        xyz=_np(params.means).astype(np.float16),
        scaling=_np(params.log_scales).astype(np.float16),
        rotation=_np(params.quats).astype(np.float16),
        opacity=_np(params.opacity_logits).astype(np.float16),
        texture_hw=_np(buffers.texture_hw).astype(np.uint16),
        mappings=_np(buffers.mappings).astype(np.float16),
        pixel_scale=_np(buffers.pixel_scale).astype(np.float32),
    )
