"""``resize_area``: ``cv2.resize(img, (w // d, h // d),
interpolation=cv2.INTER_AREA)`` on uint8 images, in torch on the image's
own device (counterpart of ``gstex_tpu/train/trainer.py:_downscale``'s
resize, which the progressive-resolution schedule applies to each
training frame).

OpenCV takes two paths, and both are reproduced:

- when the scale divides the size exactly both ways (``is_area_fast``),
  each output pixel is the mean of its d x d block: for d = 2 rounded half
  up, ``(sum + 2) >> 2`` (its SIMD path); for larger d ``sum · (1/d²)`` in
  float32 rounded to nearest, ties to even;
- otherwise the general fractional-area path (``resizeArea_`` over
  ``computeResizeAreaTab``): each source column and row contributes with
  its float32 overlap weight, accumulated in float32 in OpenCV's order,
  rounded to nearest, ties to even.
"""

from __future__ import annotations

import math

import torch


def _area_tab(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab``: (dst index, src index, float32 weight) of
    each overlap, in OpenCV's order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, (sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    return tab


def _ranked(tab):
    """The entries of ``tab`` grouped by their rank among their dst
    index's entries: [(dst indices, src indices, weights)] per rank, so
    adding rank by rank keeps OpenCV's order of float additions."""
    ranks: list[list] = []
    seen: dict[int, int] = {}
    for d, s, a in tab:
        r = seen.get(d, 0)
        seen[d] = r + 1
        if r == len(ranks):
            ranks.append([])
        ranks[r].append((d, s, a))
    return ranks


def _accumulate(x: torch.Tensor, tab, dsize: int, dim: int) -> torch.Tensor:
    """Σ over ``tab``'s entries of x[src]·weight into ``dsize`` outputs
    along ``dim``, in float32, rank by rank."""
    shape = list(x.shape)
    shape[dim] = dsize
    out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for entries in _ranked(tab):
        d = torch.tensor([e[0] for e in entries], device=x.device)
        s = torch.tensor([e[1] for e in entries], device=x.device)
        a = torch.tensor([e[2] for e in entries], dtype=torch.float32,
                         device=x.device)
        a = a.view([-1] + [1] * (x.dim() - dim - 1))
        cur = out.index_select(dim, d)
        out.index_copy_(dim, d, cur + x.index_select(dim, s) * a)
    return out


def resize_area(img: torch.Tensor, d: int) -> torch.Tensor:
    """An (H, W[, C]) uint8 tensor resized to (H // d, W // d) as
    ``cv2.resize(..., interpolation=cv2.INTER_AREA)`` resizes it."""
    if img.dtype != torch.uint8:
        raise ValueError("resize_area takes uint8 images")
    h, w = img.shape[:2]
    dh, dw = h // d, w // d
    if dh == 0 or dw == 0:
        raise ValueError(f"cannot downscale a {h}x{w} image by {d}")
    if h == dh * d and w == dw * d:
        blocks = img[:dh * d, :dw * d].to(torch.int32)
        blocks = blocks.reshape(dh, d, dw, d, *img.shape[2:])
        s = blocks.sum(dim=(1, 3))
        if d == 2:
            return ((s + 2) >> 2).to(torch.uint8)
        out = s.to(torch.float32) * torch.tensor(1.0 / (d * d),
                                                 dtype=torch.float32)
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    x = img.to(torch.float32)
    rows = _accumulate(x, _area_tab(w, dw, w / dw), dw, 1)
    out = _accumulate(rows, _area_tab(h, dh, h / dh), dh, 0)
    return torch.round(out).clamp(0, 255).to(torch.uint8)
