"""The port's mp4 writer (``gstex_torch/data/video.py`` and
``csrc/mpeg4_encode.cpp``) against what ``gstex-render --video`` writes:
``cv2.VideoWriter(path, fourcc("mp4v"), fps, (w, h))``, read back by
``cv2.VideoCapture`` (ffmpeg's decoder here).

On the same uint8 frames the two files have the same frame count, fps
and size; no frame of the port's file is lower in PSNR than cv2's; the
encoder's reconstructed luma is within 0.05 dB of ffmpeg's decoded luma
(the two inverse DCTs round apart on a few samples), so the bitstream is
read as written; the C++ encoder's bytes equal its numpy plain version's.
"""

import struct

import cv2
import numpy as np
import pytest

from gstex_torch.data import video

FPS = 24
RECON_TOL_DB = 0.05


def rendered_frames(h, w, n, seed=0):
    """Smooth rendered-like frames: coloured Gaussian blobs drifting over
    a dark background, a fine texture on them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    blobs = [(rng.uniform(0, h), rng.uniform(0, w), rng.uniform(6, 20),
              rng.uniform(40, 220, 3), rng.normal(0, 1, 2)) for _ in range(6)]
    out = []
    for t in range(n):
        img = np.full((h, w, 3), 20.0)
        for cy, cx, s, col, v in blobs:
            g = np.exp(-((y - cy - v[0] * t) ** 2 + (x - cx - v[1] * t) ** 2)
                       / (2 * s * s))
            img += g[..., None] * col * (0.9 + 0.1 * np.sin(x / 3 + y / 5))[
                ..., None]
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def write_cv2(path, frames, fps):
    """As gstex_tpu/scripts/render.py writes render.mp4."""
    writer = None
    for rgb in frames:
        if writer is None:
            writer = cv2.VideoWriter(
                str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                (rgb.shape[1], rgb.shape[0]))
        writer.write(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    writer.release()


def read(path, luma=False):
    """(fps, frame count, (width, height), frames): RGB, or with ``luma``
    the decoder's Y planes (cv2 hands yuv420p's first plane)."""
    cap = cv2.VideoCapture(str(path))
    if luma:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    meta = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f if luma else cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return meta, frames


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255 ** 2 / mse))


def luma(rgb):
    """The luma plane the encoder codes for an RGB frame of even sides."""
    return video.rgb_to_planes(rgb)[0][:rgb.shape[0], :rgb.shape[1]]


def own_psnr(rgb) -> float:
    """The PSNR of the encoder's reconstructed luma against the luma it
    codes."""
    return psnr(video.reconstruct(rgb)[0], luma(rgb))


def write_port(path, frames, fps):
    w = video.open(path, fps, (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        w.write(f)
    w.close()
    return w


@pytest.mark.parametrize("hw", [(96, 128), (37, 53)], ids=["96x128",
                                                          "37x53"])
def test_mp4_against_cv2s_mp4v_writer(tmp_path, hw):
    """37x53 is no multiple of 16 and odd both ways: both writers code
    36x52 (cv2 drops the last row and column, the port too)."""
    frames = rendered_frames(*hw, 10)
    write_cv2(tmp_path / "cv2.mp4", frames, FPS)
    write_port(tmp_path / "port.mp4", frames, FPS)
    (fps_c, n_c, size_c), got_c = read(tmp_path / "cv2.mp4")
    (fps_p, n_p, size_p), got_p = read(tmp_path / "port.mp4")
    assert (fps_p, n_p, size_p) == (fps_c, n_c, size_c) == (
        FPS, 10, (hw[1] & ~1, hw[0] & ~1))
    assert len(got_p) == len(got_c) == 10
    hh, ww = hw[0] & ~1, hw[1] & ~1
    for src, a, b in zip(frames, got_p, got_c):
        assert psnr(a, src[:hh, :ww]) >= psnr(b, src[:hh, :ww])
    _, lumas = read(tmp_path / "port.mp4", luma=True)
    for src, y in zip(frames, lumas):
        assert abs(psnr(y[:hh, :ww], luma(src[:hh, :ww]))
                   - own_psnr(src[:hh, :ww])) < RECON_TOL_DB


@pytest.mark.parametrize("hw,index,seed", [
    ((2, 2), 0, 1), ((18, 34), 25, 2), ((96, 128), 3, 8),
    ((48, 32), 48, 31)], ids=["2x2", "18x34", "96x128", "48x32"])
def test_cpp_vop_equals_plain(hw, index, seed):
    frame = rendered_frames(*hw, 1, seed=seed)[0]
    data, planes = video.encode_vop_plain(frame, index, FPS)
    assert video.encode_vop(frame, index, FPS) == data
    for a, b in zip(video.reconstruct(frame), planes):
        np.testing.assert_array_equal(a, b)


def test_escape_coded_levels_decode_as_written(tmp_path):
    """Noise sends most AC levels through escape mode 3 and long runs
    past the VLC table; ffmpeg's luma PSNR is the encoder's."""
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
              for _ in range(2)]
    write_port(tmp_path / "noise.mp4", frames, 12)
    (fps, n, size), lumas = read(tmp_path / "noise.mp4", luma=True)
    assert (fps, n, size) == (12, 2, (48, 32))
    for src, y in zip(frames, lumas):
        own = own_psnr(src)
        assert abs(psnr(y[:32, :48], luma(src)) - own) < RECON_TOL_DB
        assert own > 35


def cbp_frame() -> np.ndarray:
    """One macroblock row of 64 macroblocks, macroblock m coding its
    luminance blocks by the bits of m % 16 and its chrominance ones by
    those of m // 16 (Cb, Cr): every cbpy with every cbpc. A coded block
    carries a checker on a flat field (Cb and Cr alone where chrominance
    is coded); the rest is flat."""
    n = 64
    y = np.full((16, 16 * n), 120.0)
    cb = np.full((8, 8 * n), 128.0)
    cr = np.full((8, 8 * n), 128.0)
    check = np.where((np.arange(8)[:, None] + np.arange(8)) % 2, 30.0, -30.0)
    for m in range(n):
        for b in range(4):
            if (m % 16) >> (3 - b) & 1:
                r, c = 8 * (b // 2), 16 * m + 8 * (b % 2)
                y[r:r + 8, c:c + 8] += check
        if (m // 16) & 2:
            cb[:, 8 * m:8 * m + 8] += check
        if (m // 16) & 1:
            cr[:, 8 * m:8 * m + 8] += check
    u = np.repeat(np.repeat(cb - 128, 2, 0), 2, 1)
    v = np.repeat(np.repeat(cr - 128, 2, 0), 2, 1)
    yy = (y - 16) * 255 / 219
    s = 255 / 224
    rgb = np.stack([yy + 1.402 * s * v,
                    yy - s * (0.114 * 1.772 * u + 0.299 * 1.402 * v) / 0.587,
                    yy + 1.772 * s * u], -1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def test_every_coded_block_pattern_decodes_bit_for_bit(tmp_path):
    """Every mcbpc and cbpy code: ffmpeg's luma is the encoder's
    reconstruction sample for sample (both run ffmpeg's simple IDCT)."""
    frame = cbp_frame()
    y = video.reconstruct(frame)[0]
    write_port(tmp_path / "cbp.mp4", [frame], FPS)
    (_, n, size), lumas = read(tmp_path / "cbp.mp4", luma=True)
    assert (n, size) == (1, (frame.shape[1], frame.shape[0]))
    np.testing.assert_array_equal(lumas[0][:16, :frame.shape[1]], y)


def boxes(data, start=0, end=None):
    """{type: (offset of the body, body)} of the boxes in data[start:end],
    the containers opened (a path of types joined by '/')."""
    out, end = {}, len(data) if end is None else end

    def walk(pos, stop, prefix):
        while pos < stop:
            size, kind = struct.unpack(">I4s", data[pos:pos + 8])
            head = 8
            if size == 1:
                size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
                head = 16
            name = prefix + kind.decode()
            out[name] = (pos + head, data[pos + head:pos + size])
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl",
                        b"dinf"):
                walk(pos + head, pos + size, name + "/")
            pos += size

    walk(start, end, "")
    return out


def test_the_boxes_parse(tmp_path):
    frames = rendered_frames(32, 48, 5)
    w = write_port(tmp_path / "a.mp4", frames, 12)
    data = (tmp_path / "a.mp4").read_bytes()
    b = boxes(data)
    assert list(b)[:2] == ["ftyp", "mdat"] and b["ftyp"][1][:4] == b"isom"
    stbl = "moov/trak/mdia/minf/stbl/"
    mdhd = b["moov/trak/mdia/mdhd"][1]
    assert struct.unpack(">II", mdhd[12:20]) == (12, 5)   # timescale, n
    tkhd = b["moov/trak/tkhd"][1]
    assert struct.unpack(">II", tkhd[-8:]) == (48 << 16, 32 << 16)
    assert b["moov/trak/mdia/hdlr"][1][8:12] == b"vide"
    assert struct.unpack(">III", b[stbl + "stts"][1][4:16]) == (1, 5, 1)
    stsz = b[stbl + "stsz"][1]
    assert struct.unpack(">II", stsz[4:12]) == (0, 5)
    sizes = list(struct.unpack(">5I", stsz[12:]))
    assert sizes == w.sizes
    offset = struct.unpack(">I", b[stbl + "stco"][1][8:12])[0]
    assert offset == b["mdat"][0]
    mdat = b["mdat"][1]
    assert len(mdat) == sum(sizes)
    headers = video.stream_headers(48, 32, 12)
    assert mdat.startswith(headers + b"\x00\x00\x01\xb6")
    pos = sizes[0]
    for s in sizes[1:]:
        assert mdat[pos:pos + 4] == b"\x00\x00\x01\xb6"
        pos += s
    assert headers in b[stbl + "stsd"][1]
    assert "stss" not in [k.split("/")[-1] for k in b]   # all sync


def test_a_frame_of_another_size_raises(tmp_path):
    w = video.open(tmp_path / "a.mp4", FPS, (48, 32))
    with pytest.raises(ValueError, match="takes"):
        w.write(np.zeros((30, 40, 3), np.uint8))
    w.close()
    with pytest.raises(ValueError, match="2x2"):
        video.open(tmp_path / "b.mp4", FPS, (1, 32))
