"""Procedural scenes and cameras (counterpart of
``gstex_tpu/data/synthetic.py``).

Scenes are drawn with a numpy ``default_rng(seed)``, so the same seed
gives the same arrays on every device; the numbers differ from the JAX
package's ``jax.random`` draws. Each scene is a dict of raw
(pre-activation) parameters plus dense charts and their active dims.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Camera, make_camera
from ..utils.device import resolve_device


def _to_torch(scene: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}


def _random_quats(rng: np.random.Generator, n: int) -> np.ndarray:
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def random_scene(n: int, chart_pad: tuple[int, int] = (8, 8),
                 spread: float = 1.0, scale_lo: float = -3.5,
                 scale_hi: float = -2.0, sh_degree: int = 3, seed: int = 0,
                 device=None) -> dict:
    """A transparent volumetric cloud shaped like a small trained scene:
    every pair contributes (the no-early-exit case)."""
    rng = np.random.default_rng(seed)
    ch, cw = chart_pad
    dim_sh = (sh_degree + 1) ** 2
    f32 = lambda a: np.asarray(a, np.float32)
    log_scales = f32(rng.uniform(scale_lo, scale_hi, (n, 2)))
    l = np.exp(log_scales)
    scene = {
        "means": f32(spread * rng.standard_normal((n, 3))),
        "log_scales": log_scales,
        "quats": _random_quats(rng, n),
        "opacity_logits": f32(rng.uniform(-1.0, 3.0, (n, 1))),
        "features_dc": f32(0.5 * rng.standard_normal((n, 3))),
        "features_rest": f32(0.05 * rng.standard_normal((n, dim_sh - 1, 3))),
        "texture": f32(0.3 * rng.standard_normal((n, ch, cw, 3))),
        "texture_hw": rng.integers(1, min(ch, cw) + 1, (n, 2),
                                   dtype=np.int32),
        "mappings": f32(np.stack([1.0 / (6.0 * l[:, 0]),
                                  1.0 / (6.0 * l[:, 1])], -1)),
    }
    return _to_torch(scene, device)


def surface_scene(n: int, chart_pad: tuple[int, int] = (8, 8),
                  radius: float = 1.2, opacity_mu: float = 4.0,
                  sh_degree: int = 3, seed: int = 0, device=None) -> dict:
    """Surfels with trained-scene statistics: a fibonacci sphere with
    radial normals, scales matched to the point spacing and saturating
    opacities, so rays stop at the first layer and the early exit and the
    pair cull bite."""
    rng = np.random.default_rng(seed)
    ch, cw = chart_pad
    dim_sh = (sh_degree + 1) ** 2
    f32 = lambda a: np.asarray(a, np.float32)
    i = np.arange(n, dtype=np.float64)
    ga = np.pi * (3.0 - np.sqrt(5.0))          # golden angle
    z = 1.0 - 2.0 * (i + 0.5) / n
    r_xy = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    normals = f32(np.stack([r_xy * np.cos(ga * i), r_xy * np.sin(ga * i), z],
                           -1))
    # quat rotating +z to the normal: R columns (ax1, ax2, normal)
    w = 1.0 + normals[:, 2]
    quats = np.stack([w, -normals[:, 1], normals[:, 0],
                      np.zeros(n, np.float32)], -1)
    quats[w < 1e-6] = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    spacing = radius * np.sqrt(4.0 * np.pi / n)
    log_scales = f32(np.log(spacing * rng.uniform(0.8, 1.8, (n, 2))))
    l = np.exp(log_scales)
    scene = {
        "means": f32(radius * normals),
        "log_scales": log_scales,
        "quats": f32(quats),
        "opacity_logits": f32(opacity_mu + 0.5 * rng.standard_normal((n, 1))),
        "features_dc": f32(0.5 * rng.standard_normal((n, 3))),
        "features_rest": f32(0.05 * rng.standard_normal((n, dim_sh - 1, 3))),
        "texture": f32(0.3 * rng.standard_normal((n, ch, cw, 3))),
        "texture_hw": rng.integers(1, min(ch, cw) + 1, (n, 2),
                                   dtype=np.int32),
        "mappings": f32(np.stack([1.0 / (6.0 * l[:, 0]),
                                  1.0 / (6.0 * l[:, 1])], -1)),
    }
    return _to_torch(scene, device)


def orbit_c2w(dist: float = 4.0, azimuth: float = 0.0,
              elevation: float = 0.3) -> np.ndarray:
    """(3,4) nerfstudio c2w on an orbit, looking at the origin."""
    eye = dist * np.array([
        np.cos(elevation) * np.sin(azimuth),
        np.sin(elevation),
        np.cos(elevation) * np.cos(azimuth),
    ])
    forward = -eye / np.linalg.norm(eye)          # camera looks along -z
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.stack([right, true_up, -forward], axis=-1)
    return np.concatenate([c2w, eye[:, None]], axis=-1)


def orbit_camera(height: int, width: int, dist: float = 4.0,
                 azimuth: float = 0.0, elevation: float = 0.3,
                 focal: float | None = None, device=None) -> Camera:
    """Camera on an orbit looking at the origin (nerfstudio convention)."""
    if focal is None:
        focal = 1.2 * max(height, width)
    return make_camera(focal, focal, width / 2, height / 2, height, width,
                       orbit_c2w(dist, azimuth, elevation), device=device)
