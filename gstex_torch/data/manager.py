"""Full-image data manager (counterpart of ``gstex_tpu/data/manager.py``):
every image of a split, and its mask where the dataset has one, loaded up
front onto the device, and cameras drawn at random without replacement
per epoch, from a numpy generator seeded as the JAX package seeds it (so
both draw the same views).

Lens distortion is not undone here yet: a frame with non-zero distortion
coefficients, and the fisheye, fisheye624 and equirectangular camera
types, raise ``NotImplementedError`` (ROADMAP Queue 1 item 10). Loading
such a frame as a pinhole image would train on a wrong result.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.camera import make_camera
from .blender import ParsedDataset, load_image
from .png import read_mask

# camera types whose undistortion or projection is still to be ported
_UNPORTED_CAMERAS = {
    "fisheye": "cv2-free fisheye undistortion",
    "fisheye624": "fisheye624 rectification (data/fisheye624.py)",
    "equirectangular": "equirectangular cameras",
}


def check_loadable(parsed: ParsedDataset) -> None:
    """Raise ``NotImplementedError`` for frames the port cannot load as
    the JAX package does: lens distortion to undo, or a camera that is not
    a pinhole."""
    what = _UNPORTED_CAMERAS.get(parsed.camera_type)
    if what is not None:
        raise NotImplementedError(
            f"camera_type {parsed.camera_type!r} needs {what}: ROADMAP "
            f"Queue 1 item 10")
    dist = parsed.distortion
    if dist is not None and np.abs(dist).sum() > 0:
        bad = [str(parsed.image_filenames[i]) for i in
               np.flatnonzero(np.abs(dist).sum(-1) > 0)[:3]]
        raise NotImplementedError(
            f"frames with non-zero distortion coefficients (e.g. {bad}) "
            f"need cv2-free undistortion: ROADMAP Queue 1 item 10")


@dataclass
class FullImageCache:
    cameras: list
    images: list          # float32 (H, W, 3|4) tensors in [0, 1]
    masks: list | None = None   # float32 (H, W, 1) 0/1 tensors, or None
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    _unseen: list = field(default_factory=list)

    @classmethod
    def build(cls, parsed: ParsedDataset, seed: int = 0,
              device=None) -> "FullImageCache":
        check_loadable(parsed)
        cams, imgs = [], []
        for i, path in enumerate(parsed.image_filenames):
            img = load_image(path)
            cams.append(make_camera(parsed.fx[i], parsed.fy[i], parsed.cx[i],
                                    parsed.cy[i], img.shape[0], img.shape[1],
                                    parsed.c2ws[i], device=device))
            imgs.append(torch.as_tensor(img, device=device))
        masks = None
        if parsed.mask_filenames is not None:
            masks = [None if mf is None else torch.as_tensor(
                read_mask(mf)[..., None], dtype=torch.float32, device=device)
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
