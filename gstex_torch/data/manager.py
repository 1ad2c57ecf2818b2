"""Full-image data manager (counterpart of ``gstex_tpu/data/manager.py``):
every image of a split, and its mask where the dataset has one, loaded up
front onto the device, and cameras drawn at random without replacement
per epoch, from a numpy generator seeded as the JAX package seeds it (so
both draw the same views).

Frames are PNG or JPEG (``data/png.py:read_image``), decoded
and undistorted in a thread pool (the C++ JPEG decoder releases the GIL)
as the JAX package's ``load()`` does: a fisheye624 frame is rectified by
``data/fisheye624.py`` and its valid-circle mask joins the dataset's
masks; a frame with non-zero distortion coefficients is undistorted by
``data/undistort.py`` (the equidistant fisheye model for ``fisheye``
cameras, OPENCV ``k1 k2 p1 p2 k3`` otherwise); each camera takes the new
intrinsics and the undistorted image's own size. Equirectangular frames
load as pinholes with their parsed intrinsics, as in the JAX package.
The cache keeps the float32 images (k / 255) on the device.
"""

from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.camera import make_camera
from . import undistort
from .blender import ParsedDataset, load_image_u8
from .fisheye624 import undistort_fisheye624
from .png import read_mask


def load_frame(parsed: ParsedDataset, i: int):
    """Frame ``i`` as the JAX package's ``load(i)`` makes it: (uint8 image,
    (fx, fy, cx, cy), fisheye624 mask or None)."""
    img = load_image_u8(parsed.image_filenames[i])
    fx, fy = float(parsed.fx[i]), float(parsed.fy[i])
    cx, cy = float(parsed.cx[i]), float(parsed.cy[i])
    h, w = img.shape[:2]
    dist = parsed.distortion
    if parsed.camera_type == "fisheye624":
        params = np.concatenate(
            [[fx, fy, cx, cy], np.asarray(dist[i], np.float64)])
        crop = float(parsed.fisheye_crop_radius or min(h, w) / 2.0)
        img, mask, fx, fy, cx, cy = undistort_fisheye624(img, params, crop)
        return np.ascontiguousarray(img), (fx, fy, cx, cy), mask
    if dist is not None and np.abs(dist[i]).sum() > 0:
        k1, k2, k3, k4, p1, p2 = [float(v) for v in dist[i]]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        if parsed.camera_type == "fisheye":
            d = np.array([k1, k2, k3, k4])
            new_k = undistort.fisheye_new_camera_matrix(K, d, (w, h))
            mx, my = undistort.fisheye_undistort_map(K, d, new_k, (w, h))
            img = undistort.remap_linear(img, mx, my)
        else:
            d = np.array([k1, k2, p1, p2, k3])
            new_k = undistort.optimal_new_camera_matrix(K, d, (w, h))
            img = undistort.undistort(img, K, d, new_k)
        fx, fy = float(new_k[0, 0]), float(new_k[1, 1])
        cx, cy = float(new_k[0, 2]), float(new_k[1, 2])
    return np.ascontiguousarray(img), (fx, fy, cx, cy), None


@dataclass
class FullImageCache:
    cameras: list
    images: list          # float32 (H, W, 3|4) tensors in [0, 1]
    masks: list | None = None   # float32 (H, W, 1) 0/1 tensors, or None
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    _unseen: list = field(default_factory=list)

    @classmethod
    def build(cls, parsed: ParsedDataset, seed: int = 0, device=None,
              max_workers: int = 8) -> "FullImageCache":
        n = len(parsed.image_filenames)
        with concurrent.futures.ThreadPoolExecutor(max_workers) as ex:
            frames = list(ex.map(lambda i: load_frame(parsed, i), range(n)))
        cams, imgs = [], []
        for i, (img, (fx, fy, cx, cy), _) in enumerate(frames):
            cams.append(make_camera(fx, fy, cx, cy, img.shape[0],
                                    img.shape[1], parsed.c2ws[i],
                                    device=device))
            imgs.append(torch.as_tensor(img.astype(np.float32) / 255.0,
                                        device=device))

        def mask_tensor(m):
            return None if m is None else torch.as_tensor(
                m[..., None], dtype=torch.float32, device=device)

        masks = None
        if any(f[2] is not None for f in frames):
            masks = [mask_tensor(f[2]) for f in frames]
        if parsed.mask_filenames is not None:
            masks = [None if mf is None else mask_tensor(read_mask(mf))
                     for mf in parsed.mask_filenames]
        return cls(cameras=cams, images=imgs, masks=masks,
                   rng=np.random.default_rng(seed))

    def __len__(self):
        return len(self.cameras)

    def _mask(self, i: int):
        return self.masks[i] if self.masks is not None else None

    def next_train_idx(self):
        """(index, (camera, image, mask or None)): the next view of the
        epoch's random order."""
        if not self._unseen:
            self._unseen = list(self.rng.permutation(len(self.cameras)))
        i = int(self._unseen.pop())
        return i, (self.cameras[i], self.images[i], self._mask(i))

    def get(self, i: int):
        return self.cameras[i], self.images[i], self._mask(i)
