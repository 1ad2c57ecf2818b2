"""Equirectangular and omni-directional stereo (ODS) panoramas from six
cube faces (counterpart of ``gstex_tpu/ops/pano.py``).

The tile rasterizer needs rays affine in pixel coordinates (one pinhole
frustum a tile), so a panorama is six 90-degree pinhole faces rendered by
the production eval path (``render_one``: every face goes through the
tier's eval kernel), resampled into the lat-long grid: each panorama
pixel's ray is read bilinearly from the face its direction is most
aligned with. The resample is plain torch on the faces' device, as the
JAX package's is plain ``jnp``.

ODS is approximated per face, as in the JAX package: each face's eye sits
at ±ipd/2 along the face's tangential baseline (the cross of its view
direction and the world's up), a viewpoint constant over each 90-degree
sector instead of the reference's per-ray circle offset.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import make_camera

# face rotations in the OpenCV-style camera frame (+z forward, +y down,
# +x right): columns map face-local axes into the base camera frame; the
# face's forward is M[:, 2]
_FACES = np.array([
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],      # front  (+z)
    [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],     # right  (+x)
    [[0, 0, -1], [0, 1, 0], [1, 0, 0]],     # left   (-x)
    [[1, 0, 0], [0, 0, -1], [0, 1, 0]],     # up     (-y is up in OpenCV)
    [[1, 0, 0], [0, 0, 1], [0, -1, 0]],     # down   (+y)
    [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],    # back   (-z)
], np.float32)

_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


def _as_numpy(c2w) -> np.ndarray:
    if isinstance(c2w, torch.Tensor):
        c2w = c2w.detach().cpu().numpy()
    return np.asarray(c2w, np.float32)


def face_cameras(c2w, face_res: int, ipd: float = 0.0, device=None) -> list:
    """Six 90-degree pinhole cameras of ``face_res``² around ``c2w``'s
    origin. ``ipd`` != 0 offsets each face's centre by ipd/2 along its
    tangential baseline (the ODS approximation; the sign picks the eye)."""
    c2w = _as_numpy(c2w)
    r_cv = c2w[:3, :3] @ _FLIP        # world <- cam (OpenCV)
    origin = c2w[:3, 3]
    f = face_res / 2.0
    cams = []
    for m in _FACES:
        r_face = r_cv @ m
        fwd_w = r_face[:, 2]
        # tangential baseline: view x world up (at the poles, the face's
        # own x axis)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        base = np.cross(fwd_w, up)
        nrm = np.linalg.norm(base)
        baseline = base / nrm if nrm > 1e-6 else r_face[:, 0]
        o = origin + 0.5 * ipd * baseline
        c2w_face = np.concatenate([r_face @ _FLIP, o[:, None]], axis=1)
        cams.append(make_camera(f, f, face_res / 2, face_res / 2, face_res,
                                face_res, c2w_face, device=device))
    return cams


def equirect_dirs_cam(height: int, width: int, device=None) -> torch.Tensor:
    """(height, width, 3) camera-frame (OpenCV) unit directions of the
    lat-long grid: the reference's spherical parameterization with
    fx = fy = height = width / 2."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    f = width / 2.0
    x = (xs + 0.5 - width / 2.0) / f
    y = (ys + 0.5 - height / 2.0) / f
    theta = -torch.pi * x
    phi = torch.pi * (0.5 + y)
    return torch.stack([-torch.sin(theta) * torch.sin(phi),
                        -torch.cos(phi),
                        torch.cos(theta) * torch.sin(phi)], dim=-1)


def compose_equirect(face_imgs, height: int, width: int) -> torch.Tensor:
    """Six (F, F, C) face images -> the (height, width, C) lat-long
    panorama: each pixel read bilinearly (edges clamped) from the face of
    its direction's largest forward component."""
    img = torch.stack([f.to(torch.float32) for f in face_imgs], dim=0)
    device = img.device
    d = equirect_dirs_cam(height, width, device)      # (H, W, 3)
    faces = torch.as_tensor(_FACES, device=device)    # (6, 3, 3)
    # face-local coordinates p[f] = d @ M[f]; M's entries are 0 and ±1,
    # so each is an exact signed component of d
    p = (d[None, :, :, :, None] * faces[:, None, None]).sum(dim=3)
    pz = p[..., 2]
    sel = torch.argmax(pz, dim=0)                     # (H, W)
    fres = img.shape[1]
    f_half = fres / 2.0

    def sample(fi):
        z = torch.clamp(pz[fi], min=1e-9)
        u = p[fi, ..., 0] / z
        v = p[fi, ..., 1] / z
        px = torch.clamp(u * f_half + f_half - 0.5, 0.0, fres - 1.0)
        py = torch.clamp(v * f_half + f_half - 0.5, 0.0, fres - 1.0)
        x0 = torch.floor(px).to(torch.long)
        y0 = torch.floor(py).to(torch.long)
        x1 = torch.clamp(x0 + 1, max=fres - 1)
        y1 = torch.clamp(y0 + 1, max=fres - 1)
        wx = (px - x0)[..., None]
        wy = (py - y0)[..., None]
        f = img[fi]
        return ((1 - wy) * ((1 - wx) * f[y0, x0] + wx * f[y0, x1])
                + wy * ((1 - wx) * f[y1, x0] + wx * f[y1, x1]))

    out = sample(0)
    for fi in range(1, 6):
        out = torch.where((sel == fi)[..., None], sample(fi), out)
    return out


def default_face_res(width: int) -> int:
    """Faces a little over a quarter of the panorama's width, a multiple
    of 8: the equator spans four faces, so the resample never minifies."""
    return -(-width // 4 // 8) * 8


def render_equirect(render_one, c2w, height: int, width: int,
                    face_res: int | None = None, ipd: float = 0.0,
                    device=None) -> torch.Tensor:
    """The (height, width, C) panorama at ``c2w``: ``render_one(cam) ->
    (F, F, C)`` renders the six faces (the production pinhole path).
    ``ipd`` != 0 renders one ODS eye (its sign picks the eye)."""
    if face_res is None:
        face_res = default_face_res(width)
    cams = face_cameras(c2w, face_res, ipd=ipd, device=device)
    return compose_equirect([render_one(c) for c in cams], height, width)


def render_ods(render_one, c2w, height: int, width: int, ipd: float = 0.064,
               face_res: int | None = None, device=None) -> torch.Tensor:
    """Omni-directional stereo, (2 * height, width, C): the left eye's
    panorama above the right eye's, by the per-face viewpoint
    approximation of the module docstring."""
    left = render_equirect(render_one, c2w, height, width, face_res,
                           ipd=-ipd, device=device)
    right = render_equirect(render_one, c2w, height, width, face_res,
                            ipd=+ipd, device=device)
    return torch.cat([left, right], dim=0)
