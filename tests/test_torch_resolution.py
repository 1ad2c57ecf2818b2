"""The progressive-resolution schedule: ``data/resize.py:resize_area``
bit-equal to ``cv2.resize(INTER_AREA)`` (the integer-block paths for
d = 2 and larger d, and the general fractional-area path where d does
not divide the size), the trainer's ``downscale`` of a cached frame, and
the port's trainer against the JAX trainer for 8 steps under
``num_downscales=1, resolution_schedule=2`` (two steps at half size,
then full size), at ``test_torch_resume.py``'s size and tolerance: each
step's loss to 1e-5 relative, the final params as
``assert_params_agree`` holds them; and a masked capture whose size d
does not divide, whose strided mask is cropped to the floored frame."""

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.manager import FullImageCache as TCache
from gstex_torch.data.resize import resize_area
from gstex_torch.data.synthetic import orbit_camera as torbit
from gstex_torch.models import gstex as tmodel
from gstex_torch.ops.camera import make_camera
from gstex_torch.train import optim as toptim
from gstex_torch.train.trainer import Trainer as TTrainer
from gstex_torch.train.trainer import TrainerConfig as TTrainerConfig
from gstex_torch.train.trainer import downscale
from gstex_tpu.data.manager import FullImageCache as JCache
from gstex_tpu.data.synthetic import orbit_camera as jorbit
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.train import optim as joptim
from gstex_tpu.train.trainer import Trainer as JTrainer
from gstex_tpu.train.trainer import TrainerConfig as JTrainerConfig
from test_torch_resume import (CFG, STEPS, VIEWS, H, W, assert_params_agree,
                               one_thread, port_trainer, scene)

__all__ = ["one_thread", "scene"]   # the fixtures this module reuses

SCHEDULE = dict(num_downscales=1, resolution_schedule=2)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("size", [(800, 800), (600, 800), (801, 533),
                                  (37, 53), (99, 301)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_area_matches_cv2(size, d):
    rng = np.random.default_rng(d)
    for channels in (1, 3, 4):
        img = rng.integers(0, 256, size + (channels,), dtype=np.uint8)
        want = cv2.resize(img, (size[1] // d, size[0] // d),
                          interpolation=cv2.INTER_AREA)
        got = resize_area(torch.from_numpy(img), d).numpy()
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_downscale_recovers_the_uint8_frame_and_rescales_the_camera():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    img = torch.as_tensor(u8.astype(np.float32) / 255.0)
    mask = torch.as_tensor(rng.integers(0, 2, (50, 70, 1)),
                           dtype=torch.float32)
    cam = make_camera(60.0, 61.0, 35.2, 24.9, 50, 70, np.eye(4)[:3],
                      device="cpu")
    cam2, small, m2 = downscale(cam, img, mask, 2)
    want = cv2.resize(u8, (35, 25), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(small.numpy(),
                                  want.astype(np.float32) / 255.0)
    assert (cam2.height, cam2.width) == (25, 35)
    assert [float(v) for v in cam2.intrins] == [
        float(np.float32(v) / 2) for v in (60.0, 61.0, 35.2, 24.9)]
    torch.testing.assert_close(m2, mask[::2, ::2], rtol=0, atol=0)


def test_schedule_matches_jax_trainer(scene, tmp_path):
    views, p0, b = scene
    out = tmp_path / "jax"
    cache = JCache(cameras=[jorbit(H, W, azimuth=2 * np.pi * i / VIEWS)
                            for i in range(VIEWS)], images=list(views))
    jtr = JTrainer(
        JTrainerConfig(max_num_iterations=STEPS, steps_per_save=0,
                       steps_per_eval_image=0, log_every=1,
                       steps_per_sync=1, output_dir=str(out)),
        jmodel.GStexConfig(**CFG, **SCHEDULE),
        joptim.OptimConfig(max_steps=STEPS),
        jmodel.GStexParams(*(jnp.asarray(x) for x in p0)),
        jmodel.GStexBuffers(*(jnp.asarray(x) for x in b)), cache)
    jtr.train()
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    jlosses = {r["step"]: r["loss"] for r in rows if "loss" in r}

    tr = port_trainer(scene, tmp_path / "port", steps_per_save=0)
    tr.mcfg = tmodel.GStexConfig(**CFG, **SCHEDULE)
    hist = tr.train()
    assert [tmodel.downscale_factor(tr.mcfg, s) for s in range(STEPS)] \
        == [2, 2] + [1] * (STEPS - 2)
    for i, h in enumerate(hist):
        assert h["loss"] == pytest.approx(jlosses[i], rel=1e-5), i
    assert_params_agree(tr.state, jtr.state.params, STEPS)


def test_masked_capture_at_a_size_d_does_not_divide(scene, tmp_path):
    """A masked capture under ``num_downscales=1`` at sizes 2 does not
    divide: at 13x17 the half-size frame is 6x8 (the size floored) and its
    strided mask is cropped to it (strided alone it is 7x9, which the
    masked loss cannot take); a 25x35 capture (12x17 at half size, as
    many rows as SSIM's 11-pixel window needs) trains through its
    half-size steps into full size."""
    _, p0, b = scene
    rng = np.random.default_rng(4)

    def capture(h, w):
        cams = [torbit(h, w, azimuth=np.pi * i, device="cpu")
                for i in range(2)]
        imgs = [torch.as_tensor(rng.integers(0, 256, (h, w, 3)).astype(
            np.float32) / np.float32(255.0)) for _ in cams]
        masks = [torch.as_tensor(rng.integers(0, 2, (h, w, 1)),
                                 dtype=torch.float32) for _ in cams]
        return cams, imgs, masks

    cams, imgs, masks = capture(13, 17)
    _, small, m2 = downscale(cams[0], imgs[0], masks[0], 2)
    assert tuple(small.shape) == (6, 8, 3) and tuple(m2.shape) == (6, 8, 1)
    torch.testing.assert_close(m2, masks[0][:12:2, :16:2], rtol=0, atol=0)
    cams, imgs, masks = capture(25, 35)
    tr = TTrainer(
        TTrainerConfig(max_num_iterations=4, steps_per_save=0,
                       steps_per_eval_image=0, log_every=1,
                       output_dir=str(tmp_path)),
        tmodel.GStexConfig(**CFG, **SCHEDULE), toptim.OptimConfig(max_steps=4),
        tmodel.GStexParams(*(torch.as_tensor(x) for x in p0)),
        tmodel.GStexBuffers(*(torch.as_tensor(x) for x in b)),
        TCache(cameras=cams, images=imgs, masks=masks))
    hist = tr.train()
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
