"""The benchmark's inputs, made on the device from a configuration and a
seed: the surfels, the training cameras and the ground-truth images.

The geometry and opacities are a trained scene's (``assets/``); the
spherical-harmonic colour and the charts are drawn from the seed, and the
ground truth is this benchmark's own reference render of the same surfels
under a second draw of colours and charts, so that training starts near a
fit, as a scene at step 3000 is. The cameras depend on the configuration
alone: every seed trains on the same views, in another order.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .reference import gstex_ref as ref

HERE = Path(__file__).resolve().parent


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one named stream of a run's draws."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (1 << 63))


def surfels(cfg: dict, device) -> dict:
    """The configuration's surfels: means, log scales, quaternions and
    opacity logits (float32), a fixed subsample of the asset where the
    configuration asks for fewer, scales grown by ``scale_multiplier``."""
    with np.load(HERE / cfg["surfels_from"], allow_pickle=False) as d:
        geo = {k: np.asarray(d[k], np.float32)
               for k in ("xyz", "scaling", "rotation", "opacity")}
    n = geo["xyz"].shape[0]
    keep = np.arange(n)
    if cfg["surfels"] < n:
        rng = np.random.default_rng(cfg["subsample_seed"])
        keep = np.sort(rng.choice(n, cfg["surfels"], replace=False))
    t = lambda a: torch.as_tensor(a[keep], device=device)
    return {"means": t(geo["xyz"]),
            "log_scales": t(geo["scaling"])
            + math.log(cfg.get("scale_multiplier", 1.0)),
            "quats": t(geo["rotation"]),
            "opacity_logits": t(geo["opacity"]).reshape(-1, 1)}


def colours(cfg: dict, n: int, pad, seed: int, stream: int,
            device) -> dict:
    """SH coefficients and charts drawn from the seed in three calls."""
    g = generator(seed, stream, device)
    k = (cfg["sh_degree"] + 1) ** 2 - 1
    return {
        "features_dc": cfg["features_dc_std"] * torch.randn(
            (n, 3), generator=g, device=device),
        "features_rest": cfg["features_rest_std"] * torch.randn(
            (n, k, 3), generator=g, device=device),
        "texture": cfg["texture_std"] * torch.randn(
            (n, pad[0], pad[1], 3), generator=g, device=device),
    }


def views(cfg: dict, device) -> list:
    """``train_views`` cameras on the upper hemisphere (z up) at
    ``camera_radius``, spread by a Fibonacci lattice, looking at the
    origin, with ``camera_angle_x``'s focal length."""
    h, w = cfg["image_height"], cfg["image_width"]
    f = 0.5 * w / math.tan(0.5 * cfg["camera_angle_x"])
    out = []
    golden = math.pi * (3.0 - math.sqrt(5.0))
    nv = cfg["train_views"]
    for i in range(nv):
        z = (i + 0.5) / nv
        r = math.sqrt(1.0 - z * z)
        eye = cfg["camera_radius"] * np.array(
            [r * math.cos(golden * i), r * math.sin(golden * i), z])
        back = eye / np.linalg.norm(eye)
        right = np.cross([0.0, 0.0, 1.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, eye], -1)
        out.append(ref.View(f, f, w / 2.0, h / 2.0, h, w,
                            torch.tensor(c2w, dtype=torch.float32,
                                         device=device)))
    return out


def settings(cfg: dict) -> ref.Settings:
    s = cfg["spatial_scale"]
    return ref.Settings(pixel_num=cfg["pixel_num"],
                        xyz_lr=s * 1.6e-5 * cfg["xyz_lr_mult"],
                        xyz_lr_final=s * 1.6e-6,
                        max_steps=cfg["max_num_iterations"],
                        sh_degree=cfg["sh_degree"],
                        sh_interval=cfg["sh_degree_interval"],
                        sigma_factor=cfg["sigma_factor"],
                        chart_every=cfg["build_chart_every"])


def background(cfg: dict, device) -> torch.Tensor:
    value = {"white": 1.0, "black": 0.0}[cfg["background_color"]]
    return torch.full((3,), value, device=device)


def ground_truth(cfg: dict, geo: dict, pad, cams, seed: int, step: int,
                 device) -> list:
    """(H, W, 4) straight-colour RGBA images: the reference's render of
    the surfels under the seed's second draw of colours, at
    1/``gt_downscale`` of the size and scaled up bilinearly; alpha is the
    render's weight."""
    st = settings(cfg)
    target = dict(geo, **colours(cfg, geo["means"].shape[0], pad, seed, 2,
                                 device))
    buffers = ref.initial_buffers(target, st)
    d = cfg["gt_downscale"]
    bg = torch.zeros(3, device=device)
    out = []
    with torch.no_grad():
        for cam in cams:
            rgb, alpha = ref.render(target, buffers, cam.scaled(d), step, st,
                                    bg)
            rgba = torch.cat([rgb, alpha[..., None]], -1).permute(2, 0, 1)
            big = F.interpolate(rgba[None], size=(cam.height, cam.width),
                                mode="bilinear", align_corners=False)[0]
            big = big.permute(1, 2, 0).clamp(0.0, 1.0)
            a = big[..., 3:4]
            straight = torch.where(a > 1e-6, big[..., :3] / a.clamp(min=1e-6),
                                   0.0).clamp(0.0, 1.0)
            out.append(torch.cat([straight, a], -1).contiguous())
    return out
