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


def write_blender_dataset(out_dir, cfg, params, buffers, views: int,
                          height: int, width: int, split: str = "train",
                          dist: float = 4.0, step: int = 3000,
                          azimuth0: float = 0.0) -> None:
    """Render ``views`` orbit views of a scene (evenly spaced from
    ``azimuth0``) with the eval path and write them as a Blender-format
    split: ``transforms_<split>.json`` and RGBA PNGs (straight colour,
    alpha = the render's alpha)."""
    import json
    from pathlib import Path

    from ..models import gstex as model
    from .png import write_png

    out_dir = Path(out_dir)
    (out_dir / split).mkdir(parents=True, exist_ok=True)
    dev = params.means.device
    focal = 1.2 * max(height, width)
    frames = []
    with torch.no_grad():
        for i, az in enumerate(azimuth0 + np.linspace(0, 2 * np.pi, views,
                                                      endpoint=False)):
            c2w = orbit_c2w(dist, float(az))
            cam = make_camera(focal, focal, width / 2, height / 2, height,
                              width, c2w, device=dev)
            out = model.render(cfg, params, buffers, cam, step,
                               torch.zeros(3, device=dev), eval_only=True)
            a = out["alpha"][..., None]
            rgb = torch.clamp(out["rgb"] / torch.clamp(a, min=1e-6), 0, 1)
            rgba = torch.cat([rgb, torch.clamp(a, 0, 1)], -1)
            write_png(out_dir / split / f"r_{i}.png",
                      (rgba * 255 + 0.5).to(torch.uint8).cpu().numpy())
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": np.concatenate(
                               [c2w, [[0, 0, 0, 1]]]).tolist()})
    meta = {"camera_angle_x": 2 * float(np.arctan(0.5 * width / focal)),
            "frames": frames}
    (out_dir / f"transforms_{split}.json").write_text(json.dumps(meta))


def colmap_axes(xyz: np.ndarray) -> np.ndarray:
    """Points in COLMAP axes: the inverse of ``ops.quat.fix_init_points``,
    (x, y, z) -> (x, −z, y)."""
    return np.stack([xyz[..., 0], -xyz[..., 2], xyz[..., 1]], -1)


def colmap_rotation(quats: torch.Tensor) -> torch.Tensor:
    """Rotations in COLMAP axes: the inverse of
    ``ops.quat.fix_init_rotation``, rows (r0, r1, r2) -> (r0, −r2, r1)."""
    from ..ops.quat import quat_to_rotmat, rotmat_to_quat

    rm = quat_to_rotmat(quats)
    return rotmat_to_quat(torch.stack([rm[..., 0, :], -rm[..., 2, :],
                                       rm[..., 1, :]], dim=-2))


def distortion_maps(K: np.ndarray, d, height: int, width: int):
    """The maps of what a lens with OPENCV distortion ``d`` (k1 k2 p1 p2
    [k3]) and camera ``K`` records of a scene whose ideal pinhole image
    under ``K`` is given: each distorted pixel reads the ideal image where
    its undistorted ray lands (``undistort_points``, 20 steps). Float32
    (height, width) maps for ``remap_linear``."""
    from .undistort import undistort_points

    ys, xs = np.mgrid[:height, :width].astype(np.float64)
    xy = undistort_points(np.stack([xs.ravel(), ys.ravel()], -1), K, d,
                          iters=20)
    mx = (K[0, 0] * xy[:, 0] + K[0, 2]).reshape(height, width)
    my = (K[1, 1] * xy[:, 1] + K[1, 2]).reshape(height, width)
    return mx.astype(np.float32), my.astype(np.float32)


def write_nerfstudio_dataset(out_dir, cfg, params, buffers, views: int,
                             height: int, width: int, downscale: int = 2,
                             dist: float = 4.0, step: int = 3000,
                             masks: bool = True, image_format: str = "png",
                             distortion: dict | None = None) -> dict:
    """Render ``views`` orbit views of a scene with the eval path over a
    black background and write them as a nerfstudio dataset, as COLMAP
    processing leaves a DTU scan: ``transforms.json`` (OPENCV, the
    intrinsics of a capture ``downscale`` times the rendered size), the
    renders as RGB PNGs (or, with ``image_format="jpeg"``, JPEGs at
    quality 95 from ``data/jpeg.py``) in ``images_<downscale>/``, with
    ``masks`` the object masks (alpha > 0.5) as grey PNGs named by each
    frame's ``mask_path``, and the scene's surfels in COLMAP axes:
    ``points3D.ply`` (xyz and colour, the dataset's ``ply_file_path``) and
    ``init.ply`` (a 2DGS gaussian ply for ``--init-ply``). ``distortion``
    (``{"k1", "k2", "p1", "p2"}``, zero where absent) warps each frame and
    mask into that lens (``distortion_maps``) and writes the coefficients.
    The nerfstudio methods' ``fix_init`` maps both back onto the scene.
    Returns the paths written."""
    import json
    from pathlib import Path

    from ..models import gstex as model
    from ..ops.sh import sh_to_rgb
    from ..utils.ply import write_ply
    from .jpeg import write_jpeg
    from .png import write_png
    from .undistort import remap_linear

    coeffs = {k: 0.0 for k in ("k1", "k2", "k3", "k4", "p1", "p2")}
    coeffs.update(distortion or {})
    K = np.array([[1.2 * max(height, width), 0, width / 2],
                  [0, 1.2 * max(height, width), height / 2], [0, 0, 1.0]])
    d = [coeffs["k1"], coeffs["k2"], coeffs["p1"], coeffs["p2"],
         coeffs["k3"]]

    maps = (distortion_maps(K, d, height, width) if distortion else None)

    def lens(img):
        return img if maps is None else remap_linear(img, *maps)

    out_dir = Path(out_dir)
    img_dir = out_dir / f"images_{downscale}"
    img_dir.mkdir(parents=True, exist_ok=True)
    if masks:
        (out_dir / "masks").mkdir(exist_ok=True)
    dev = params.means.device
    focal = 1.2 * max(height, width)
    black = torch.zeros(3, device=dev)
    frames = []
    with torch.no_grad():
        for i, az in enumerate(np.linspace(0, 2 * np.pi, views,
                                           endpoint=False)):
            c2w = orbit_c2w(dist, float(az))
            cam = make_camera(focal, focal, width / 2, height / 2, height,
                              width, c2w, device=dev)
            out = model.render(cfg, params, buffers, cam, step, black,
                               eval_only=True)
            rgb = lens((out["rgb"] * 255 + 0.5).to(torch.uint8).cpu().numpy())
            if image_format == "jpeg":
                name = f"frame_{i:05d}.jpg"
                write_jpeg(img_dir / name, rgb, 95)
            else:
                name = f"frame_{i:05d}.png"
                write_png(img_dir / name, rgb)
            frame = {"file_path": f"images/{name}",
                     "transform_matrix": np.concatenate(
                         [c2w, [[0, 0, 0, 1]]]).tolist()}
            if masks:
                mask_name = f"frame_{i:05d}.png"
                write_png(out_dir / "masks" / mask_name, lens((
                    (out["alpha"] > 0.5).to(torch.uint8) * 255).cpu().numpy()))
                frame["mask_path"] = f"masks/{mask_name}"
            frames.append(frame)
    s = downscale
    meta = {"camera_model": "OPENCV", "fl_x": s * focal, "fl_y": s * focal,
            "cx": s * width / 2, "cy": s * height / 2, "w": s * width,
            "h": s * height, **coeffs, "ply_file_path": "points3D.ply",
            "frames": frames}
    (out_dir / "transforms.json").write_text(json.dumps(meta))

    np_ = lambda x: x.detach().cpu().numpy()
    xyz = colmap_axes(np_(params.means))
    rgb = np.clip(np_(sh_to_rgb(params.features_dc)), 0, 1) * 255
    write_ply(out_dir / "points3D.ply", {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
    n = xyz.shape[0]
    rest = np_(params.features_rest).transpose(0, 2, 1).reshape(n, -1)
    quats = np_(colmap_rotation(params.quats))
    fields = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    fields.update({f"f_dc_{c}": np_(params.features_dc)[:, c]
                   for c in range(3)})
    fields.update({f"f_rest_{j}": rest[:, j] for j in range(rest.shape[1])})
    fields["opacity"] = np_(params.opacity_logits)[:, 0]
    fields.update({f"scale_{j}": np_(params.log_scales)[:, j]
                   for j in range(2)})
    fields.update({f"rot_{j}": quats[:, j] for j in range(4)})
    write_ply(out_dir / "init.ply", fields)
    return {"transforms": out_dir / "transforms.json",
            "points": out_dir / "points3D.ply",
            "init_ply": out_dir / "init.ply"}
