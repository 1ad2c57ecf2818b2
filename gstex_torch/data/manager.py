"""Full-image data manager (counterpart of ``gstex_tpu/data/manager.py``):
every image of a split loaded up front onto the device, and cameras
drawn at random without replacement per epoch, from a numpy generator
seeded as the JAX package seeds it (so both draw the same views)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.camera import make_camera
from .blender import ParsedDataset, load_image


@dataclass
class FullImageCache:
    cameras: list
    images: list          # float32 (H, W, 3|4) tensors in [0, 1]
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    _unseen: list = field(default_factory=list)

    @classmethod
    def build(cls, parsed: ParsedDataset, seed: int = 0,
              device=None) -> "FullImageCache":
        cams, imgs = [], []
        for i, path in enumerate(parsed.image_filenames):
            img = load_image(path)
            cams.append(make_camera(parsed.fx[i], parsed.fy[i], parsed.cx[i],
                                    parsed.cy[i], img.shape[0], img.shape[1],
                                    parsed.c2ws[i], device=device))
            imgs.append(torch.as_tensor(img, device=device))
        return cls(cameras=cams, images=imgs, rng=np.random.default_rng(seed))

    def __len__(self):
        return len(self.cameras)

    def next_train_idx(self):
        """(index, (camera, image, None)): the next view of the epoch's
        random order (the None is the JAX manager's mask slot)."""
        if not self._unseen:
            self._unseen = list(self.rng.permutation(len(self.cameras)))
        i = int(self._unseen.pop())
        return i, (self.cameras[i], self.images[i], None)

    def get(self, i: int):
        return self.cameras[i], self.images[i], None
