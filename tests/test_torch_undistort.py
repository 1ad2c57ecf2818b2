"""The port's cv2-free undistortion (``gstex_torch/data/undistort.py``,
``data/fisheye624.py``) against cv2 and the JAX package on seeded numpy
inputs, and captured datasets of JPEG frames loaded by both packages'
``FullImageCache.build``.

Tolerances: new intrinsics within 1e-6 relative of cv2's (they agree to
the last bit here); images bit-equal to cv2's (``cv2.undistort``,
``cv2.remap`` with float and fixed-point maps, the fisheye maps);
fisheye624 projections within 1e-12 of the JAX package's numpy, its
rectified image and mask bit-equal; each dataset's frames bit-equal and
intrinsics within 1e-6 relative.
"""

import json

import cv2
import numpy as np
import pytest
from PIL import Image

from gstex_torch.data import fisheye624 as tfe
from gstex_torch.data import undistort as U
from gstex_torch.data.manager import FullImageCache
from gstex_torch.data.nerfstudio_parser import parse_nerfstudio
from gstex_tpu.data import fisheye624 as jfe
from gstex_tpu.data.manager import FullImageCache as JCache
from gstex_tpu.data.nerfstudio_parser import \
    parse_nerfstudio as jparse_nerfstudio

SIZES = [(64, 96), (533, 801)]
PERSPECTIVE = [np.array([-0.05, 0.01, 1e-3, -1e-3, 0.0]),
               np.array([0.08, -0.02, -2e-3, 1e-3, 0.005])]
FISHEYE = np.array([0.05, -0.01, 0.002, -0.001])


def camera(h, w):
    return np.array([[0.9 * w, 0, w / 2 + 3.3], [0, 0.92 * w, h / 2 - 2.1],
                     [0, 0, 1.0]])


def smooth_image(h, w, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 2)


def rel(a, b):
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("coeffs", [0, 1])
def test_perspective_matches_cv2(size, coeffs):
    h, w = size
    K, d = camera(h, w), PERSPECTIVE[coeffs]
    new_k, _ = cv2.getOptimalNewCameraMatrix(K, d, (w, h), 0)
    assert rel(U.optimal_new_camera_matrix(K, d, (w, h)), new_k) < 1e-6
    img = smooth_image(h, w, coeffs)
    np.testing.assert_array_equal(U.undistort(img, K, d, new_k),
                                  cv2.undistort(img, K, d,
                                                newCameraMatrix=new_k))
    # the fixed-point map itself, against cv2's CV_16SC2 one
    m1, m2 = cv2.initUndistortRectifyMap(K, d, np.eye(3), new_k, (w, h),
                                         cv2.CV_16SC2)
    ix, iy = U.undistort_map_fixed(K, d, new_k, (w, h))
    np.testing.assert_array_equal(ix, m1[..., 0] * 32 + (m2 & 31))
    np.testing.assert_array_equal(iy, m1[..., 1] * 32 + (m2 >> 5))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fisheye_matches_cv2(size):
    h, w = size
    K = camera(h, w)
    new_k = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        K, FISHEYE, (w, h), np.eye(3), balance=0.0)
    assert rel(U.fisheye_new_camera_matrix(K, FISHEYE, (w, h)), new_k) < 1e-6
    m1, m2 = cv2.fisheye.initUndistortRectifyMap(K, FISHEYE, np.eye(3),
                                                 new_k, (w, h), cv2.CV_32FC1)
    mx, my = U.fisheye_undistort_map(K, FISHEYE, new_k, (w, h))
    np.testing.assert_array_equal(mx, m1)
    np.testing.assert_array_equal(my, m2)
    img = smooth_image(h, w, 5)
    np.testing.assert_array_equal(U.remap_linear(img, mx, my),
                                  cv2.remap(img, m1, m2, cv2.INTER_LINEAR))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("step", [None, 64, 1024],
                         ids=["uniform", "64ths", "1024ths"])
def test_remap_linear_matches_cv2_on_random_maps(channels, step):
    """Positions across and past every border (taps outside read 0);
    positions on 1/64 and 1/1024 grids put many on rounding ties."""
    rng = np.random.default_rng(channels)
    h, w = 40, 50
    img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    shape = (60, 70)
    if step is None:
        mx = rng.uniform(-3, w + 2, shape).astype(np.float32)
        my = rng.uniform(-3, h + 2, shape).astype(np.float32)
    else:
        mx = (rng.integers(-3 * step, (w + 2) * step, shape)
              / step).astype(np.float32)
        my = (rng.integers(-3 * step, (h + 2) * step, shape)
              / step).astype(np.float32)
    np.testing.assert_array_equal(
        U.remap_linear(img, mx, my),
        cv2.remap(img, mx, my, cv2.INTER_LINEAR))
    # cv2's fixed-point path, from maps in 1/32 pixel
    m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    ix = m1[..., 0].astype(np.int64) * 32 + (m2 & 31)
    iy = m1[..., 1].astype(np.int64) * 32 + (m2 >> 5)
    np.testing.assert_array_equal(U.remap_fixed(img, ix, iy),
                                  cv2.remap(img, m1, m2, cv2.INTER_LINEAR))


def fisheye624_params(h, w):
    return np.array([0.45 * w, 0.46 * w, w / 2 + 1.5, h / 2 - 0.5,
                     0.02, -0.003, 4e-4, 0, 0, 0, 1e-4, -2e-4, 1e-4, 0,
                     -1e-4, 0])


def test_fisheye624_matches_jax():
    h, w = 60, 80
    params = fisheye624_params(h, w)
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(200, 3)) + np.array([0, 0, 2.0])
    np.testing.assert_allclose(tfe.fisheye624_project(xyz, params),
                               jfe.fisheye624_project(xyz, params),
                               rtol=0, atol=1e-12)
    uv = rng.uniform(0, [w, h], size=(200, 2))
    np.testing.assert_allclose(tfe.fisheye624_unproject(uv, params),
                               jfe.fisheye624_unproject(uv, params),
                               rtol=0, atol=1e-12)
    img = smooth_image(h, w, 2)
    got = tfe.undistort_fisheye624(img, params, 28.0)
    want = jfe.undistort_fisheye624(img, params, 28.0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    assert 0.5 < got[1].mean() < 1.0


CAMERA_MODELS = {
    "OPENCV": {"k1": -0.05, "k2": 0.01, "p1": 1e-3, "p2": -1e-3},
    "OPENCV_FISHEYE": {"k1": 0.05, "k2": -0.01, "k3": 0.002, "k4": -0.001},
    "FISHEYE624": {"k1": 0.02, "k2": -0.003, "p1": 1e-4, "s1": 1e-4,
                   "fisheye_crop_radius": 22.0},
    "EQUIRECTANGULAR": {},
}


def write_jpeg_dataset(root, model, h=48, w=64, n=3):
    """A nerfstudio capture of ``n`` JPEG frames (PIL, quality 95), as
    ``tests/test_fisheye.py`` builds its dataset."""
    (root / "images").mkdir(parents=True)
    frames = []
    for i in range(n):
        img = smooth_image(h, w, 10 + i)
        Image.fromarray(img).save(root / f"images/f{i}.jpg", quality=95)
        c2w = np.eye(4)
        c2w[2, 3] = 2.0 + i
        frames.append({"file_path": f"images/f{i}.jpg",
                       "transform_matrix": c2w.tolist()})
    meta = {"camera_model": model, "fl_x": 50.0, "fl_y": 52.0,
            "cx": w / 2 + 1.3, "cy": h / 2 - 0.7, "w": w, "h": h,
            "frames": frames, **CAMERA_MODELS[model]}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("model", list(CAMERA_MODELS))
def test_jpeg_dataset_loads_as_jax_loads_it(tmp_path, model):
    root = write_jpeg_dataset(tmp_path / model, model)
    parsed = parse_nerfstudio(root, eval_mode="all")
    jparsed = jparse_nerfstudio(root, eval_mode="all")
    assert parsed.camera_type == jparsed.camera_type
    cache = FullImageCache.build(parsed, device="cpu", max_workers=2)
    jcache = JCache.build(jparsed, max_workers=2)
    for i in range(len(jcache.images)):
        got = np.round(cache.images[i].numpy() * 255).astype(np.uint8)
        np.testing.assert_array_equal(got, jcache.images[i])
        cam, jcam = cache.cameras[i], jcache.cameras[i]
        assert (cam.height, cam.width) == (jcam.height, jcam.width)
        k = [float(getattr(cam, a)) for a in ("fx", "fy", "cx", "cy")]
        jk = [float(getattr(jcam, a)) for a in ("fx", "fy", "cx", "cy")]
        assert rel(k, np.array(jk)) < 1e-6
    if model == "FISHEYE624":
        assert cache.images[0].shape[:2] == (44, 44)
        for m, jm in zip(cache.masks, jcache.masks):
            np.testing.assert_array_equal(m[..., 0].numpy(), jm)
    else:
        assert cache.masks is None and jcache.masks is None


def test_save_dataparser_transform_matches_jax(tmp_path):
    root = write_jpeg_dataset(tmp_path / "d", "OPENCV")
    parse_nerfstudio(root, eval_mode="all").save_dataparser_transform(
        tmp_path / "port" / "dataparser_transforms.json")
    jparse_nerfstudio(root, eval_mode="all").save_dataparser_transform(
        tmp_path / "jax" / "dataparser_transforms.json")
    got = (tmp_path / "port" / "dataparser_transforms.json").read_text()
    assert got == (tmp_path / "jax" / "dataparser_transforms.json"
                   ).read_text()
    assert json.loads(got)["scale"] > 0
