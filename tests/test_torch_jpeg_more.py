"""The port's JPEG decoder (``gstex_torch/data/jpeg.py`` and
``csrc/jpeg_decode.cpp``) on every kind of stream PIL decodes beyond the
baseline ones of ``test_torch_jpeg.py``: progressive and arithmetic-coded
(sequential and progressive, DAC conditioning, restart intervals),
CMYK and YCCK, 4:4:0 and 4:1:1 sampling, lossless, also with a
subsampled component; the streams PIL refuses; and every fixture cut
short (to half, to 90 % and to all but its EOI marker), which each
decoder refuses exactly where PIL does, else decoding to PIL's bytes,
and a capture with a cut frame, which fails to load naming it.

The fixtures in ``tests/fixtures/jpeg/`` were written by
``make_fixtures.py`` there (cv2, PIL and a libjpeg transcoder); their
manifest holds each file's sha256 and that of PIL's ``convert("RGB")``
bytes, which PIL is held to here at test time. Tolerance: none. The
plain decoder runs on the small fixtures only (arithmetic decoding in
Python is slow).
"""

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gstex_torch.data import jpeg
from gstex_torch.data.png import read_image, read_mask, to_grey
from jpeg_streams import JFIF, frame_only, lossless_jpeg, with_huffman_table

FIXTURES = Path(__file__).parent / "fixtures" / "jpeg"
MANIFEST = json.loads((FIXTURES / "MANIFEST.json").read_text())
SMALL = [n for n, m in MANIFEST.items() if m["shape"][0] * m["shape"][1]
         <= 64 * 64]


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def as_rgb(img: np.ndarray) -> np.ndarray:
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_pils_bytes(name):
    data = (FIXTURES / name).read_bytes()
    entry = MANIFEST[name]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    want = pil_rgb(data)
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["rgb_sha256"]
    got = jpeg.decode(data)
    np.testing.assert_array_equal(as_rgb(got), want)
    if name in SMALL:
        np.testing.assert_array_equal(jpeg.decode_plain(data), got)


@pytest.mark.parametrize("name", ["cmyk_pil.jpg", "ycck.jpg",
                                  "prog_grey_pil.jpg", "arith_prog.jpg",
                                  "s411_cv2.jpg", "lossless_rgb.jpg"])
def test_fixture_masks_are_pils_grey(name):
    """The mask path: ``to_grey`` of the decoded frame is PIL's
    ``convert("L")`` (for CMYK PIL goes through RGB too), and
    ``read_mask`` thresholds it at 127 as the JAX package does."""
    path = FIXTURES / name
    want = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(to_grey(read_image(path)), want)
    np.testing.assert_array_equal(read_mask(path),
                                  (want > 127).astype(np.uint8))


def scans(data: bytes, n: int) -> bytes:
    """The stream's headers and first ``n`` scans, then EOI."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[n]] + b"\xff\xd9" if n < len(sos) else data


def test_complete_progressive_stream_is_not_smoothed():
    """libjpeg smooths blocks only where the scans leave a low AC
    coefficient's bits incomplete (``jdcoefct.c:smoothing_ok``). PIL's
    progressive script sends those coefficients by successive
    approximation (first scans at Al 1 and 2, refinements down to 0); on
    the complete stream no smoothing runs and the decode is PIL's."""
    data = (FIXTURES / "prog_pil.jpg").read_bytes()
    scans = [data[i + 4:i + 4 + struct.unpack(">H", data[i + 2:i + 4])[0]]
             for i in range(len(data) - 4) if data[i:i + 2] == b"\xff\xda"]
    al = [s[-1] & 15 for s in scans]
    ah = [s[-1] >> 4 for s in scans]
    assert max(al) > 0 and max(ah) > 0 and al[-1] == 0
    np.testing.assert_array_equal(jpeg.decode(data), pil_rgb(data))


@pytest.mark.parametrize("decoder", ["cpp", "plain"])
def test_incomplete_progressive_streams_are_smoothed(decoder, monkeypatch):
    """Each of the progressive fixture's first nine scans, then EOI,
    leaves low AC coefficients without their last bits (after the first,
    without any AC data, so the DC is smoothed too): PIL decodes each
    with libjpeg's block smoothing (``jdcoefct.c:
    decompress_smooth_data``), and the port gives its bytes. Without the
    smoothing every one of them would differ."""
    fn = jpeg.decode if decoder == "cpp" else jpeg.decode_plain
    data = (FIXTURES / "prog_pil.jpg").read_bytes()
    for n in range(1, 10):
        want = pil_rgb(scans(data, n))
        np.testing.assert_array_equal(fn(scans(data, n)), want)
        if decoder == "plain":
            with monkeypatch.context() as m:
                m.setattr(jpeg, "_smoothing_ok", lambda *a: False)
                assert (jpeg.decode_plain(scans(data, n)) != want).any()


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:0", "4:1:1"])
def test_smoothing_at_the_edges_of_the_padded_grid(sampling):
    """Sizes whose block rows are no multiple of the sampling's, so the
    last iMCU row has fewer block rows and a padded dummy row stands in
    the 5x5 neighbourhood of the rows above: every prefix of the scans,
    both decoders, PIL's bytes."""
    import cv2

    factor = {"4:2:0": 0x221111, "4:4:0": 0x121111, "4:1:1": 0x411111}
    rng = np.random.default_rng(7)
    y, x = np.mgrid[:40, :33]
    img = np.clip(np.stack([128 + 90 * np.sin(x / 5 + y / 7),
                            128 + 80 * np.cos(y / 4), 60 + 4 * x], -1)
                  + rng.normal(0, 8, (40, 33, 3)), 0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor[sampling]])
    data = enc.tobytes()
    for n in range(1, data.count(b"\xff\xda") + 1):
        want = pil_rgb(scans(data, n))
        np.testing.assert_array_equal(jpeg.decode(scans(data, n)), want)
        np.testing.assert_array_equal(jpeg.decode_plain(scans(data, n)),
                                      want)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors(predictor):
    """ITU T.81 Annex H's seven predictors, with point transforms 0 and 2,
    on grey and 3-component (RGB) streams, against PIL."""
    rng = np.random.default_rng(predictor)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    for data in (lossless_jpeg(img, predictor, 0),
                 lossless_jpeg(img[..., 0], predictor, 2)):
        want = pil_rgb(data)
        got = jpeg.decode(data)
        np.testing.assert_array_equal(as_rgb(got), want)
        np.testing.assert_array_equal(jpeg.decode_plain(data), got)


REFUSED = {
    "12-bit": frame_only(0xC1, precision=12),
    "16-bit": frame_only(0xC3, precision=16),
    "2-component": frame_only(0xC0, nc=2),
    "differential sequential": frame_only(0xC5),
    "differential progressive": frame_only(0xC6),
    "differential lossless": frame_only(0xC7),
    "arithmetic-coded lossless": frame_only(0xCB),
    "arithmetic-coded differential sequential": frame_only(0xCD),
    "arithmetic-coded differential lossless": frame_only(0xCF),
    "lossless YCbCr": lossless_jpeg(np.zeros((4, 4, 3), np.uint8), 1, 0,
                                    JFIF),
}


def _baseline() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.full((16, 16, 3), 90, np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


# Huffman tables libjpeg refuses where a scan uses them (jdhuff.c's
# jpeg_make_d_derived_tbl): a DC symbol past 15 (16 lossless), a code of
# all ones
BAD_TABLES = {
    "DC symbol 16": with_huffman_table(_baseline(), 0,
                                       values=bytes(range(11)) + b"\x10"),
    "progressive DC symbol 200": with_huffman_table(
        (FIXTURES / "prog_cv2.jpg").read_bytes(), 0,
        values=[200, 6, 5, 3, 4]),
    "code of all ones": with_huffman_table(
        _baseline(), 0, counts=[2] + [0] * 14 + [10]),
    "lossless DC symbol 17": with_huffman_table(
        lossless_jpeg(np.zeros((4, 4), np.uint8), 1, 0), 0,
        values=bytes(range(16)) + b"\x11"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED) + sorted(BAD_TABLES))
def test_streams_pil_refuses_raise(kind):
    data = REFUSED[kind] if kind in REFUSED else BAD_TABLES[kind]
    match = ("JPEG Huffman table bad" if kind in BAD_TABLES else
             f"{kind} JPEG streams are not decoded: PIL refuses")
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    for fn in (jpeg.decode, jpeg.decode_plain):
        with pytest.raises(ValueError, match=match):
            fn(data)


@pytest.mark.parametrize("size", [(8, 1), (8, 3), (3, 4), (9, 2)])
def test_narrow_frames_box_upsample(size):
    """jdsample.c upsamples a component of 2 samples or fewer across by
    box replication, not the fancy triangle: 4:2:0 and 4:2:2 frames of 4
    pixels across or fewer, baseline and progressive."""
    rng = np.random.default_rng(size[0] * 10 + size[1])
    img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    for sub in (1, 2):
        for prog in (False, True):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                      subsampling=sub, progressive=prog)
            data = buf.getvalue()
            np.testing.assert_array_equal(jpeg.decode(data), pil_rgb(data))
            np.testing.assert_array_equal(jpeg.decode_plain(data),
                                          pil_rgb(data))


def test_captures_of_every_kind_load_like_the_jax_package(tmp_path):
    """A Blender split whose frames are the small fixtures (progressive,
    arithmetic, CMYK, YCCK, 4:4:0, 4:1:1, lossless) loads through
    ``FullImageCache`` in the port as PIL loads it in the JAX package."""
    from gstex_torch.data.blender import parse_blender
    from gstex_torch.data.manager import FullImageCache
    from gstex_tpu.data.blender import parse_blender as jparse_blender
    from gstex_tpu.data.manager import FullImageCache as JCache

    names = ["prog_cv2.jpg", "arith_prog_rst.jpg", "cmyk_pil.jpg",
             "ycck.jpg", "s440_cv2.jpg", "s411_prog_cv2.jpg",
             "lossless_rgb.jpg"]
    (tmp_path / "train").mkdir()
    frames = []
    for i, name in enumerate(names):
        (tmp_path / "train" / f"r_{i}.png").write_bytes(
            (FIXTURES / name).read_bytes())
        c2w = np.eye(4)
        c2w[2, 3] = 3.0 + i
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": frames}))
    parsed, jparsed = parse_blender(tmp_path), jparse_blender(tmp_path)
    np.testing.assert_array_equal(parsed.heights, jparsed.heights)
    np.testing.assert_array_equal(parsed.widths, jparsed.widths)
    cache = FullImageCache.build(parsed, device="cpu", max_workers=2)
    jcache = JCache.build(jparsed, max_workers=2)
    assert len(cache.images) == len(names)
    for got, want in zip(cache.images, jcache.images):
        np.testing.assert_array_equal(
            np.round(got.numpy() * 255).astype(np.uint8), want)


def pil_or_error(data: bytes):
    """PIL's ``convert("RGB")`` bytes of ``data``, or ``None`` where it
    raises."""
    try:
        return pil_rgb(data)
    except Exception:
        return None


def cuts(data: bytes) -> dict:
    return {"half": data[:len(data) // 2],
            "90%": data[:len(data) * 9 // 10],
            "no EOI": data[:-2]}


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_cut_fixtures_raise_where_pil_raises(name):
    """Both decoders raise ``ValueError`` on a cut stream exactly where
    PIL raises, read live; where PIL decodes one (a lossless stream
    without its EOI, whose last bit-buffer fill ends at the data's last
    byte), they give its bytes. The plain decoder takes the 800x800
    fixtures at their half only."""
    data = (FIXTURES / name).read_bytes()
    for cut, part in cuts(data).items():
        want = pil_or_error(part)
        fns = [jpeg.decode]
        if name in SMALL or cut == "half":
            fns.append(jpeg.decode_plain)
        for fn in fns:
            if want is None:
                with pytest.raises(ValueError, match="truncated"):
                    fn(part)
            else:
                np.testing.assert_array_equal(as_rgb(fn(part)), want)
    assert pil_or_error(cuts(data)["no EOI"]) is None or name.startswith(
        "lossless")


def test_cut_baseline_streams_at_every_length():
    """A baseline 4:2:0 stream (one scan, Huffman) and a 4:4:4 one with
    restart markers cut at each of their last 80 lengths, and two
    earlier: where libjpeg-turbo's bit buffer, filled 57 bits ahead,
    runs past the cut, PIL raises; where it does not, PIL decodes. Both
    decoders follow it at every length. The baseline stream is the first
    crop of a fixture's frame whose stream PIL decodes without its EOI
    (its last fill ends at the data's last byte; about one crop in 25)."""
    import cv2

    img = np.asarray(Image.open(FIXTURES / "prog_pil.jpg").convert("RGB"))

    def baseline(crop, quality):
        buf = io.BytesIO()
        Image.fromarray(crop).save(buf, format="JPEG", quality=quality)
        return buf.getvalue()

    data = next(d for d in (baseline(img[:h, :w], q)
                            for h in range(16, 46, 3)
                            for w in range(16, 62, 5) for q in (75, 85, 95))
                if pil_or_error(d[:-2]) is not None)
    ok, rst = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    decoded = 0
    for data in (data, rst.tobytes()):
        n = len(data)
        for length in list(range(n - 80, n + 1)) + [n // 3, n // 2]:
            want = pil_or_error(data[:length])
            decoded += want is not None
            for fn in (jpeg.decode, jpeg.decode_plain):
                if want is None:
                    with pytest.raises(ValueError, match="truncated"):
                        fn(data[:length])
                else:
                    np.testing.assert_array_equal(fn(data[:length]), want)
    # the whole streams, and one at least that lacks its EOI
    assert decoded > 2


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2)])
def test_lossless_subsampled_component(sampling):
    """Three-component lossless streams at 16x24, the first component
    sampled (h, v) and the others 1x1, predictors 1 and 5: RGB (no JFIF
    marker) decodes to PIL's bytes in both decoders; with a JFIF marker
    (YCbCr) PIL refuses them, and so do both decoders."""
    rng = np.random.default_rng(sampling[0] * 3 + sampling[1])
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    for predictor in (1, 5):
        data = lossless_jpeg(img, predictor, 0,
                             sampling=[sampling, (1, 1), (1, 1)])
        want = pil_rgb(data)
        np.testing.assert_array_equal(jpeg.decode(data), want)
        np.testing.assert_array_equal(jpeg.decode_plain(data), want)
        ycc = lossless_jpeg(img, predictor, 0, JFIF,
                            sampling=[sampling, (1, 1), (1, 1)])
        assert pil_or_error(ycc) is None
        for fn in (jpeg.decode, jpeg.decode_plain):
            with pytest.raises(ValueError, match="lossless YCbCr"):
                fn(ycc)


def test_capture_with_a_cut_frame_fails_naming_it(tmp_path):
    """A Blender split whose second frame is cut to 90 %: the port's
    ``FullImageCache`` raises ``ValueError`` naming that frame, where the
    JAX package's PIL loader raises too; with the frame whole both
    load."""
    from gstex_torch.data.blender import parse_blender
    from gstex_torch.data.manager import FullImageCache
    from gstex_tpu.data.blender import parse_blender as jparse_blender
    from gstex_tpu.data.manager import FullImageCache as JCache

    names = ["prog_cv2.jpg", "s411_cv2.jpg", "cmyk_pil.jpg"]
    (tmp_path / "train").mkdir()
    frames = []
    for i, name in enumerate(names):
        c2w = np.eye(4)
        c2w[2, 3] = 3.0 + i
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": frames}))
    for cut in (True, False):
        for i, name in enumerate(names):
            data = (FIXTURES / name).read_bytes()
            if cut and i == 1:
                data = data[:len(data) * 9 // 10]
            (tmp_path / "train" / f"r_{i}.png").write_bytes(data)
        if cut:
            with pytest.raises(ValueError, match=r"r_1\.png: JPEG stream "
                                                 r"truncated"):
                FullImageCache.build(parse_blender(tmp_path), device="cpu",
                                     max_workers=2)
            with pytest.raises(OSError):
                JCache.build(jparse_blender(tmp_path), max_workers=2)
        else:
            cache = FullImageCache.build(parse_blender(tmp_path),
                                         device="cpu", max_workers=2)
            assert len(cache.images) == len(names)


def comment(n: int) -> bytes:
    """A COM segment of n zero bytes."""
    return b"\xff\xfe" + struct.pack(">H", n + 2) + bytes(n)


def test_arithmetic_data_across_a_64_kib_read():
    """PIL feeds libjpeg 64 KiB at a time, and jdarith.c cannot suspend
    inside entropy-coded data: an arithmetic-coded stream whose data
    crosses a read raises there ("broken data stream"), where a Huffman
    one suspends and decodes. A COM segment after SOI moves the data
    across 64 KiB: the sequential 800x800 fixture decodes with 27000
    bytes of it and raises with 30000; the progressive one with restart
    markers, swept across the boundary, decodes where the crossing falls
    between its scans' reads and raises elsewhere. Both decoders follow
    PIL at each."""
    seq = (FIXTURES / "arith_800.jpg").read_bytes()
    prog = (FIXTURES / "arith_prog_rst.jpg").read_bytes()
    streams = [seq[:2] + comment(pad) + seq[2:] for pad in (27000, 30000)]
    streams += [prog[:2] + comment(pad) + prog[2:]
                for pad in range(63700, 65500, 11)]
    verdicts = []
    for i, data in enumerate(streams):
        want = pil_or_error(data)
        verdicts.append(want is not None)
        fns = [jpeg.decode] + ([jpeg.decode_plain] if i >= 2 else [])
        for fn in fns:
            if want is None:
                with pytest.raises(ValueError, match="64 KiB"):
                    fn(data)
            else:
                np.testing.assert_array_equal(as_rgb(fn(data)), want)
    assert verdicts[:2] == [True, False]
    assert 0 < sum(verdicts[2:]) < len(verdicts) - 2
    # a Huffman stream with the same padding decodes
    huff = (FIXTURES / "prog_800.jpg").read_bytes()
    padded = huff[:2] + comment(30000) + huff[2:]
    np.testing.assert_array_equal(jpeg.decode(padded), pil_rgb(padded))
