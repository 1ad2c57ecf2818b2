"""Scene sources for the port (counterpart of
``gstex_tpu/models/init_io.py`` ``params_from_export_npz`` and
``params_from_scene_stats``).

Random fills use a ``torch.Generator`` seeded from ``seed``: the values
differ from the JAX package's ``jax.random`` fills, which are
timing-neutral placeholders there too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import gstex as model


def _check_pad(cfg, hw):
    ch, cw = cfg.chart_pad
    if hw[:, 0].max() > ch or hw[:, 1].max() > cw:
        raise ValueError(f"chart_pad {cfg.chart_pad} < dump chart dims "
                         f"({hw[:, 0].max()}, {hw[:, 1].max()})")


def params_from_export_npz(cfg: model.GStexConfig, path, seed: int = 0,
                           device=None):
    """(params, buffers) from a ``gstex-export gstex-npz`` dump: raw
    params, the flat jagged texture and its (h, w, offset) dims.
    ``cfg.chart_pad`` must cover the dump's chart dims."""
    dev = resolve_device(device)
    with np.load(path) as d:
        d = dict(d)
    n = d["xyz"].shape[0]
    hw = d["texture_dims"][:, :2].astype(np.int32)
    offsets = d["texture_dims"][:, 2].astype(np.int64)
    _check_pad(cfg, hw)
    ch, cw = cfg.chart_pad
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
    _check_pad(cfg, hw)
    ch, cw = cfg.chart_pad
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


def load_scene_npz(cfg: model.GStexConfig, path, seed: int = 0, device=None):
    """Either dump format: a scene-statistics file (it has a ``kind``
    entry) or a full gstex-npz export."""
    with np.load(path, allow_pickle=False) as probe:
        is_stats = "kind" in probe.files
    loader = params_from_scene_stats if is_stats else params_from_export_npz
    return loader(cfg, path, seed=seed, device=device)
