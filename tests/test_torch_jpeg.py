"""The port's JPEG codec (``gstex_torch/data/jpeg.py`` and its C++
decoder ``csrc/jpeg_decode.cpp``) against PIL and cv2, which both use
libjpeg-turbo, on seeded numpy images.

Tolerance: none. The decoder returns PIL's ``convert("RGB")`` bytes (and
cv2's for restart-marker streams cv2 writes) at every quality, sampling
and size here; the encoder writes PIL's ``save(format="JPEG",
quality=q)`` bytes; the C++ decoder equals its plain Python version.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from gstex_torch.data import jpeg
from gstex_torch.data.png import read_image, read_mask, to_grey

# PIL's subsampling option: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0
SAMPLINGS = {"444": 0, "422": 1, "420": 2}


def photo(h, w, seed=0):
    """A smooth colour field with noise: structure at several scales."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(x / 7 + y / 11),
                  128 + 90 * np.cos(x / 5 - y / 9),
                  128 + 60 * np.sin((x + y) / 13)], -1)
    return np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("quality", [50, 75, 88, 95])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decoder_matches_pil(quality, sampling):
    for h, w in ((37, 53), (64, 96)):
        data = pil_jpeg(photo(h, w, quality), quality=quality,
                        subsampling=SAMPLINGS[sampling])
        got = jpeg.decode(data)
        np.testing.assert_array_equal(got, pil_rgb(data))
        np.testing.assert_array_equal(jpeg.decode_plain(data), got)


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decoder_matches_pil_at_a_large_odd_size(sampling):
    """801x533: neither side a multiple of the MCU."""
    data = pil_jpeg(photo(533, 801, 7), quality=90,
                    subsampling=SAMPLINGS[sampling])
    np.testing.assert_array_equal(jpeg.decode(data), pil_rgb(data))


def test_grey_decodes_to_its_samples_and_masks_threshold_them(tmp_path):
    img = photo(41, 29, 3)[..., 1]
    data = pil_jpeg(img, quality=88)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = jpeg.decode(data)
    assert got.shape == (41, 29, 1)
    np.testing.assert_array_equal(got[..., 0], want)
    np.testing.assert_array_equal(jpeg.decode_plain(data), got)
    path = tmp_path / "mask.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(
        read_mask(path),
        (np.asarray(Image.open(path).convert("L")) > 127).astype(np.uint8))


def test_colour_masks_go_through_pils_luma(tmp_path):
    """A colour JPEG mask is decoded to RGB, then to PIL's L (not the
    stream's Y), then thresholded at 127."""
    img = photo(30, 40, 4)
    path = tmp_path / "mask.jpg"
    path.write_bytes(pil_jpeg(img, quality=75))
    want = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(to_grey(read_image(path)), want)
    np.testing.assert_array_equal(read_mask(path),
                                  (want > 127).astype(np.uint8))


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_restart_markers(interval):
    """cv2 writes restart markers every ``interval`` MCUs."""
    img = photo(45, 70, interval)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    data = enc.tobytes()
    assert ok and b"\xff\xdd" in data
    want = pil_rgb(data)
    np.testing.assert_array_equal(want, cv2.imdecode(enc, 1)[..., ::-1])
    np.testing.assert_array_equal(jpeg.decode(data), want)
    np.testing.assert_array_equal(jpeg.decode_plain(data), want)


@pytest.mark.parametrize("quality", [75, 88, 95])
@pytest.mark.parametrize("size", [(37, 53), (64, 96), (17, 9)])
def test_encoder_writes_pils_bytes(quality, size):
    img = photo(*size, seed=quality)
    assert jpeg.encode(img, quality) == pil_jpeg(img, quality=quality)
    grey = img[..., 0]
    assert jpeg.encode(grey, quality) == pil_jpeg(grey, quality=quality)


def test_encoder_default_quality_and_app_segments_skipped():
    """PIL's default quality is libjpeg's 75; EXIF and COM segments
    before the frame are skipped by both decoders."""
    img = photo(24, 40, 9)
    assert jpeg.encode(img) == pil_jpeg(img)
    buf = io.BytesIO()
    exif = Image.Exif()
    exif[0x010E] = "a description"
    Image.fromarray(img).save(buf, format="JPEG", quality=80,
                              exif=exif.tobytes(), comment=b"note")
    data = buf.getvalue()
    assert b"Exif" in data and b"\xff\xfe" in data
    np.testing.assert_array_equal(jpeg.decode(data), pil_rgb(data))
    np.testing.assert_array_equal(jpeg.decode_plain(data), pil_rgb(data))


@pytest.mark.parametrize("decoder", ["cpp", "plain"])
def test_unsupported_streams_raise_naming_the_roadmap_item(decoder):
    """What still raises, and why: a 12-bit stream, which PIL cannot even
    identify (so the JAX package's loader refuses it too), and bytes that
    are not a JPEG. Progressive and CMYK streams decode now
    (``test_torch_jpeg_more.py``)."""
    from jpeg_streams import frame_only

    fn = jpeg.decode if decoder == "cpp" else jpeg.decode_plain
    twelve = frame_only(0xC1, precision=12)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(twelve))
    with pytest.raises(ValueError, match="12-bit JPEG streams are not "
                                         "decoded: PIL refuses them too, so "
                                         "the JAX package's loader does"):
        fn(twelve)
    with pytest.raises(ValueError, match="not a JPEG"):
        fn(b"\x89PNG\r\n\x1a\n")


def test_cpp_decoder_is_built_once_and_decodes_in_threads():
    """The host library is loaded once per process; decodes in a thread
    pool (ctypes releases the GIL) give the same bytes as one by one."""
    from concurrent.futures import ThreadPoolExecutor

    from gstex_torch.ops import _build

    assert jpeg._library() is _build.load_host("jpeg_decode")
    datas = [pil_jpeg(photo(50, 60, s), quality=85) for s in range(6)]
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(jpeg.decode, datas))
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(g, pil_rgb(d))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler, no decoder: the build raises and nothing falls back
    to the plain version."""
    from gstex_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="c\\+\\+"):
        jpeg.decode(pil_jpeg(photo(8, 8)))


def test_blender_frames_dispatch_on_signature(tmp_path):
    """A Blender split whose frames are JPEG bytes under the format's
    ``.png`` names loads in the port as PIL loads it in the JAX package:
    size from the JPEG header, samples PIL's."""
    import json

    from gstex_torch.data.blender import parse_blender
    from gstex_torch.data.manager import FullImageCache
    from gstex_tpu.data.blender import parse_blender as jparse_blender
    from gstex_tpu.data.manager import FullImageCache as JCache

    (tmp_path / "train").mkdir()
    frames = []
    for i in range(2):
        (tmp_path / "train" / f"r_{i}.png").write_bytes(
            pil_jpeg(photo(30, 44, i), quality=90))
        c2w = np.eye(4)
        c2w[2, 3] = 3.0 + i
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": frames}))
    parsed, jparsed = parse_blender(tmp_path), jparse_blender(tmp_path)
    assert (parsed.heights[0], parsed.widths[0]) == (30, 44)
    np.testing.assert_array_equal(parsed.fx, jparsed.fx)
    cache = FullImageCache.build(parsed, device="cpu", max_workers=2)
    jcache = JCache.build(jparsed, max_workers=2)
    for got, want in zip(cache.images, jcache.images):
        np.testing.assert_array_equal(
            np.round(got.numpy() * 255).astype(np.uint8), want)
