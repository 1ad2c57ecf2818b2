"""Texture painting: polyline canvases, texel writes, the edit stack
(counterpart of ``gstex_tpu/models/editing.py``).

An edit is a camera and an RGBA canvas seen from it. ``draw_from_view``
renders that view's depth from the dense lists, opens a ±``DEPTH_WINDOW``
window around it, splats the canvas into the charts of the surfels inside
the window (``ops/texture_edit.py``, a CUDA kernel on the card) and lerps
it into the working RGB charts. ``EditSession`` keeps the stack, replays
it onto the texture's albedo, and saves it as ``<ts>/info.json`` with one
PNG a canvas, in the JAX package's layout, so that edits saved by either
package load in the other. Canvases are drawn and written in numpy: the
machine that runs the port has neither cv2 nor PIL.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..data.png import read_png, write_png
from ..ops import sh as sh_ops
from ..ops.binning import build_tile_bins
from ..ops.camera import Camera, make_camera
from ..ops.prepare import prepare_splats
from ..ops.rasterize_api import rasterize_pl_eval
from ..ops.texture_edit import apply_edit, texture_edit
from ..utils.draw import polyline
from . import gstex as model

DEPTH_WINDOW = 1e-2


def camera_to_json(cam: Camera) -> dict:
    """The camera as the JAX package stores it in an edit record."""
    return {
        "fx": float(cam.fx), "fy": float(cam.fy),
        "cx": float(cam.cx), "cy": float(cam.cy),
        "height": int(cam.height), "width": int(cam.width),
        "c2w": cam.c2w.detach().cpu().numpy().tolist(),
    }


def camera_from_json(d: dict, device=None) -> Camera:
    return make_camera(d["fx"], d["fy"], d["cx"], d["cy"], d["height"],
                       d["width"], np.array(d["c2w"], np.float32),
                       device=device)


@torch.no_grad()
def edit_view(cfg: model.GStexConfig, params: model.GStexParams,
              buffers: model.GStexBuffers, cam: Camera,
              cur_texture_rgb: torch.Tensor):
    """The view an edit is splatted from: ``(prepared splats, dense
    bins, tile grid, depth (H, W))``.

    The view is prepared at the full SH degree and binned into dense lists
    without the pair cull, as in the JAX package; its depth and alpha come
    from the dense eval render of those lists (the dense eval kernel on
    the card). The depth is α-normalised: the accumulated Σ w·t
    under-estimates the surface depth where α < 1, which would put every
    splat of a semi-transparent pixel outside the window."""
    prep = prepare_splats(
        params.means, params.log_scales, params.quats, params.opacity_logits,
        params.features_dc, params.features_rest, buffers.mappings, cam,
        active_sh_degree=cfg.sh_degree, sh_degree=cfg.sh_degree,
        fix_init=cfg.fix_init, extent_sigma=cfg.sigma_factor)
    grid = cfg.grid(cam.height, cam.width)
    bins = build_tile_bins(prep.centers, prep.extents, prep.depths,
                           prep.valid, grid, cfg.pair_cap, cfg.s_max)
    maps = rasterize_pl_eval(prep.geom, cur_texture_rgb.contiguous(),
                             buffers.texture_hw, bins, cam, grid)
    depth = maps["depth"] / torch.clamp(maps["alpha"], min=1e-6)
    return prep, bins, grid, depth


@torch.no_grad()
def draw_from_view(cfg: model.GStexConfig, params: model.GStexParams,
                   buffers: model.GStexBuffers, cam: Camera,
                   cur_texture_rgb: torch.Tensor,
                   change_img: torch.Tensor) -> torch.Tensor:
    """One edit: ``change_img`` (H, W, 4), an RGBA canvas in [0, 1], into
    the ``(N, Ch, Cw, 3)`` RGB charts ``cur_texture_rgb``, for the surfels
    of ``edit_view`` within ``DEPTH_WINDOW`` of the view's depth; returns
    the updated charts."""
    prep, bins, grid, depth = edit_view(cfg, params, buffers, cam,
                                        cur_texture_rgb)
    accum = texture_edit(
        prep.geom, params.texture.shape, buffers.texture_hw, bins, cam, grid,
        change_img[..., :3], change_img[..., 3:],
        depth - DEPTH_WINDOW, depth + DEPTH_WINDOW)
    return apply_edit(cur_texture_rgb, accum)


@dataclass
class EditSession:
    """The edit stack: each record a camera (``camera_to_json``) and its
    (H, W, 4) uint8 canvas."""

    cfg: model.GStexConfig
    edits: list = field(default_factory=list)

    def add_canvas(self, cam: Camera, canvas: np.ndarray) -> None:
        if canvas.shape[-1] != 4:
            raise ValueError(f"a canvas is (H, W, 4) RGBA, got "
                             f"{canvas.shape}")
        self.edits.append({"camera": camera_to_json(cam),
                           "canvas": np.asarray(canvas, np.uint8)})

    def add_polyline(self, cam: Camera, points_px, rgb=(255, 0, 0),
                     width: int = 5) -> None:
        """A new canvas with the open polyline through ``points_px``
        ((x, y) pixels) in ``rgb`` at full alpha, ``width`` pixels thick,
        drawn as ``cv2.polylines`` draws it (``utils/draw.py``)."""
        canvas = np.zeros((cam.height, cam.width, 4), np.uint8)
        polyline(canvas, points_px, tuple(rgb) + (255,), width)
        self.add_canvas(cam, canvas)

    def undo(self) -> None:
        if self.edits:
            self.edits.pop()

    def edit_texture(self, params: model.GStexParams,
                     buffers: model.GStexBuffers) -> torch.Tensor:
        """Every edit replayed, in order, onto SH2RGB(texture)."""
        dev = params.texture.device
        tex = sh_ops.sh_to_rgb(params.texture.detach())
        for e in self.edits:
            cam = camera_from_json(e["camera"], device=dev)
            change = torch.as_tensor(e["canvas"], dtype=torch.float32,
                                     device=dev) / 255.0
            tex = draw_from_view(self.cfg, params, buffers, cam, tex, change)
        return tex

    def save(self, out_dir) -> Path:
        """Write ``<out_dir>/<timestamp>/info.json`` and
        ``images/edit_NNNN.png``; returns the timestamped directory."""
        root = Path(out_dir) / time.strftime("%Y-%m-%d_%H%M%S")
        (root / "images").mkdir(parents=True, exist_ok=True)
        info = []
        for i, e in enumerate(self.edits):
            fname = root / "images" / f"edit_{i:04d}.png"
            write_png(fname, e["canvas"])
            info.append({"camera": e["camera"], "file": str(fname)})
        (root / "info.json").write_text(json.dumps(info))
        return root

    @classmethod
    def load(cls, cfg: model.GStexConfig, info_json_path) -> "EditSession":
        """The edits of an ``info.json`` that ``save`` wrote, in this
        package or the JAX package."""
        sess = cls(cfg)
        for e in json.loads(Path(info_json_path).read_text()):
            sess.edits.append({"camera": e["camera"],
                               "canvas": read_png(e["file"])})
        return sess
