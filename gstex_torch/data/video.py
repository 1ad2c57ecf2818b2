"""MPEG-4 Part 2 video in an .mp4 file, with no video library: the
counterpart of what ``cv2.VideoWriter(path, fourcc("mp4v"), fps, (w, h))``
gives ``gstex-render --video``.

The stream is ISO/IEC 14496-2 Simple Profile, intra only: every frame is
an I-VOP at the fixed quantiser ``QSCALE``, so there is no motion search
and no drift between this encoder's inverse DCT and a decoder's. A frame
goes RGB -> Y'CbCr 4:2:0 (BT.601, limited range, which ffmpeg's reader
converts back by default; each chroma sample the mean of its 2x2 pixels),
padded to whole 16x16 macroblocks by edge replication; each 8x8 block
through the integer forward DCT (``jfdctint.c``'s, as ``data/jpeg.py``),
the intra DC scaler and the mandatory intra DC prediction, the H.263
quantisation method for the AC coefficients (to the nearest
reconstruction level), ``ac_pred_flag`` 0, the zigzag scan, the intra
TCOEF VLC table (Table B-16) and escape mode 3 for the rest. Resync
markers are off; the VOL carries the true width and height.

The container is ISO BMFF: ``ftyp``, then ``mdat``, written as frames
arrive (no frame is kept in memory), then ``moov`` at ``close()``:
``mvhd``, ``tkhd``, ``mdhd`` with timescale ``fps`` and one tick a
sample, ``hdlr vide``, ``vmhd``, ``dref``, ``stsd/mp4v/esds`` (its
DecoderSpecificInfo holds the VOS, VO and VOL headers, which also
precede the first VOP), ``stts``, ``stsc``, ``stsz``, ``stco``. Every
sample is a sync sample.

Sizes as cv2's writer takes them: an odd width or height loses its last
column or row (cv2 truncates to even sizes for ffmpeg's 4:2:0); a frame
of another size than the writer's raises (cv2 drops it with a warning).
The writer takes RGB; cv2's takes BGR.

``encode_vop`` is the main path (host C++, ``csrc/mpeg4_encode.cpp``,
built at first use by ``ops/_build.py``); ``encode_vop_plain`` is its
plain version in numpy, for the tests; nothing falls back to it.
``reconstruct`` (the same C++) and ``encode_vop_plain`` also give the
encoder's own reconstruction, through the inverse DCT of ffmpeg's decoder
(``simple_idct``): the frame a decoder shows. The writer does not make
it.

    w = video.open("render.mp4", 24, (width, height))
    for rgb in frames:
        w.write(rgb)          # (height, width, 3) uint8
    w.close()
"""

from __future__ import annotations

import ctypes
import io
import struct
import time

import numpy as np

from .jpeg import ZIGZAG, _category, _fdct_1d

QSCALE = 2                      # vop_quant of every VOP
DC_SCALER = 8                   # Table 7-1's intra DC scaler at QSCALE

# BT.601 limited range in 16.16 fixed point: Y from R, G, B; Cb; Cr
_Y_RGB = (16829, 33039, 6416)
_CB_RGB = (-9714, -19070, 28784)
_CR_RGB = (28784, -24103, -4681)

# ISO/IEC 14496-2 Table B-16, intra TCOEF: (code, length) of each
# (last, run, level) in the order of _RUN / _LEVEL; the sign bit follows
_TCOEF = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6),
    (0x12, 6), (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9),
    (0x24, 9), (0x23, 9), (0x21, 9), (0x21, 10), (0x20, 10), (0xf, 10),
    (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11), (0x50, 12),
    (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8),
    (0x20, 9), (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12),
    (0xb, 5), (0x15, 7), (0x1e, 9), (0xc, 10), (0x56, 12), (0x11, 6),
    (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9), (0xa, 10),
    (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12),
    (0x14, 7), (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8),
    (0x23, 11), (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10), (0x58, 12),
    (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10), (0x5, 11),
    (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6),
    (0x4, 10), (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7),
    (0x5a, 12), (0x15, 8), (0x5b, 12), (0x14, 8), (0x13, 8), (0x1a, 8),
    (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x26, 11),
    (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12)]
_RUN = ([0] * 27 + [1] * 10 + [2] * 5 + [3] * 4 + [4] * 3 + [5] * 3
        + [6] * 3 + [7] * 3 + [8] * 2 + [9] * 2 + [10, 11, 12, 13, 14]
        + [0] * 8 + [1] * 3 + [2, 2, 3, 3, 4, 4, 5, 5, 6, 6] + list(
            range(7, 21)))
_LEVEL = (list(range(1, 28)) + list(range(1, 11)) + list(range(1, 6))
          + [1, 2, 3, 4] + [1, 2, 3] * 4 + [1, 2, 1, 2, 1, 1, 1, 1, 1]
          + list(range(1, 9)) + [1, 2, 3] + [1, 2] * 5 + [1] * 14)
_LAST0 = 67                     # entries from here code last = 1
ESCAPE = (0x3, 7)
MAX_LEVEL = 27
# dct_dc_size VLCs (Tables B-13, B-14): (code, length) by size 0..12
_DC_LUMA = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
            (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]
_DC_CHROMA = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
              (1, 7), (1, 8), (1, 9), (1, 10), (1, 11), (1, 12)]
# mcbpc of an I-VOP's intra macroblock (Table B-6) by cbpc, and cbpy
# (Table B-8) by the four luminance blocks' coded flags
_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3)]
_CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
         (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]


def _tcoef_table() -> tuple[np.ndarray, np.ndarray]:
    """(2, 64, MAX_LEVEL + 1) code and length of each (last, run, |level|)
    in the table; length 0 where escape mode 3 codes it."""
    code = np.zeros((2, 64, MAX_LEVEL + 1), np.int64)
    length = np.zeros_like(code)
    for i, ((c, n), r, lv) in enumerate(zip(_TCOEF, _RUN, _LEVEL)):
        code[int(i >= _LAST0), r, lv], length[int(i >= _LAST0), r, lv] = c, n
    return code, length


_TC_CODE, _TC_LEN = _tcoef_table()


def time_bits(fps: int) -> int:
    """Bits of vop_time_increment at resolution ``fps``."""
    return max(1, (fps - 1).bit_length())


def even_size(width: int, height: int) -> tuple[int, int]:
    """The coded size of a (width, height) frame: each side cut to even,
    as cv2's writer cuts it."""
    if width < 2 or height < 2:
        raise ValueError(f"a video frame needs 2x2 pixels, not "
                         f"{width}x{height}")
    return width & ~1, height & ~1


# ---------------------------------------------------------------------------
# headers (bit strings) and the plain VOP encoder (numpy)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.codes = []

    def put(self, value: int, n: int) -> None:
        self.codes.append((value, n))

    def stuff(self) -> None:
        """next_start_code(): a 0 bit, then 1 bits to the byte."""
        n = sum(c[1] for c in self.codes) + 1
        self.put(0, 1)
        self.put((1 << (-n % 8)) - 1, -n % 8)

    def bytes(self) -> bytes:
        v = np.array([c[0] for c in self.codes], np.int64)
        n = np.array([c[1] for c in self.codes], np.int64)
        return _pack(v, n)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length codes MSB first (a whole number of
    bytes; no byte stuffing, which MPEG-4's VLCs do not need)."""
    keep = lengths > 0
    values, lengths = values[keep], lengths[keep]
    total = int(lengths.sum())
    if total % 8:
        raise ValueError("the codes do not fill whole bytes")
    start = np.cumsum(lengths) - lengths
    v = np.repeat(values, lengths)
    shift = np.repeat(start + lengths - 1, lengths) - np.arange(total)
    return np.packbits(((v >> shift) & 1).astype(np.uint8)).tobytes()


def stream_headers(width: int, height: int, fps: int) -> bytes:
    """The VOS, VO and VOL headers: Simple Profile, one rectangular
    8-bit 4:2:0 layer of ``width`` x ``height`` at a fixed rate of
    ``fps`` VOPs a second, H.263 quantisation, no resync markers."""
    if not 1 <= fps <= 65535:
        raise ValueError(f"fps {fps} is outside 1..65535")
    w = _BitWriter()
    w.put(0x1B0, 32)                 # visual_object_sequence_start_code
    w.put(0x01, 8)                   # profile_and_level_indication
    w.put(0x1B5, 32)                 # visual_object_start_code
    w.put(0, 1)                      # is_visual_object_identifier
    w.put(1, 4)                      # visual_object_type: video
    w.put(0, 1)                      # video_signal_type
    w.stuff()
    w.put(0x100, 32)                 # video_object_start_code
    w.put(0x120, 32)                 # video_object_layer_start_code
    w.put(0, 1)                      # random_accessible_vol
    w.put(1, 8)                      # video_object_type_indication: simple
    w.put(0, 1)                      # is_object_layer_identifier
    w.put(1, 4)                      # aspect_ratio_info: square
    w.put(0, 1)                      # vol_control_parameters
    w.put(0, 2)                      # video_object_layer_shape: rectangular
    w.put(1, 1)
    w.put(fps, 16)                   # vop_time_increment_resolution
    w.put(1, 1)
    w.put(1, 1)                      # fixed_vop_rate
    w.put(1, time_bits(fps))         # fixed_vop_time_increment
    w.put(1, 1)
    w.put(width, 13)
    w.put(1, 1)
    w.put(height, 13)
    w.put(1, 1)
    w.put(0, 1)                      # interlaced
    w.put(1, 1)                      # obmc_disable
    w.put(0, 1)                      # sprite_enable
    w.put(0, 1)                      # not_8_bit
    w.put(0, 1)                      # quant_type: H.263
    w.put(1, 1)                      # complexity_estimation_disable
    w.put(1, 1)                      # resync_marker_disable
    w.put(0, 1)                      # data_partitioned
    w.put(0, 1)                      # scalability
    w.stuff()
    return w.bytes()


def vop_header(index: int, fps: int) -> list:
    """The codes of frame ``index``'s I-VOP header."""
    seconds = index // fps - (index - 1) // fps if index else 0
    return [(0x1B6, 32), (0, 2), ((1 << seconds) - 1 << 1, seconds + 1),
            (1, 1), (index % fps, time_bits(fps)), (1, 1), (1, 1), (0, 3),
            (QSCALE, 5)]


def rgb_to_planes(rgb: np.ndarray) -> tuple:
    """(Y, Cb, Cr) uint8 planes of an (H, W, 3) uint8 frame of even
    sides, padded by edge replication to whole macroblocks: Y (16·mbh,
    16·mbw), chroma (8·mbh, 8·mbw), each chroma sample rounded from the
    exact mean of its 2x2 pixels."""
    h, w = rgb.shape[:2]
    c = rgb.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = ((16 << 16) + _Y_RGB[0] * r + _Y_RGB[1] * g + _Y_RGB[2] * b
         + (1 << 15)) >> 16

    def chroma(k):
        s = k[0] * r + k[1] * g + k[2] * b
        s = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((128 << 18) + s + (1 << 17)) >> 18

    mbh, mbw = -(-h // 16), -(-w // 16)

    def pad(p, m):
        return np.pad(p, ((0, m * mbh - p.shape[0]),
                          (0, m * mbw - p.shape[1])), mode="edge")

    return tuple(np.clip(pad(p, m), 0, 255).astype(np.uint8) for p, m in (
        (y, 16), (chroma(_CB_RGB), 8), (chroma(_CR_RGB), 8)))


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows, cols) plane -> (rows/8, cols/8, 64) blocks."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).transpose(0, 2, 1, 3).reshape(
        r // 8, c // 8, 64)


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """jfdctint's forward DCT of (..., 64) level-shifted samples: the
    DCT scaled up by 8, natural order."""
    blk = blocks.astype(np.int64).reshape(blocks.shape[:-1] + (8, 8))
    rows = _fdct_1d([blk[..., :, k] for k in range(8)], False)
    work = np.stack(rows, axis=-1)
    cols = _fdct_1d([work[..., k, :] for k in range(8)], True)
    return np.stack(cols, axis=-2).reshape(blocks.shape)


def _quantize(d8: np.ndarray) -> np.ndarray:
    """(..., 64) DCT x 8 of samples shifted by −128 -> quantised levels:
    the DC by its scaler, rounded (its true value is d8[0] / 8 + 1024);
    each AC coefficient to the H.263 level whose reconstruction
    (2·|L| + 1)·QSCALE is nearest (1.5·QSCALE the edge of level 1)."""
    q = np.empty_like(d8)
    q[..., 0] = (d8[..., 0] + 8192 + 4 * DC_SCALER) // (8 * DC_SCALER)
    a = np.abs(d8[..., 1:])
    lv = a // (16 * QSCALE)
    lv = np.where((lv == 0) & (a >= 12 * QSCALE), 1, lv)
    q[..., 1:] = np.sign(d8[..., 1:]) * np.minimum(lv, 2047)
    return q


def _dc_predict(dc: np.ndarray) -> np.ndarray:
    """The predicted DC level of each block of a component's grid of DC
    levels ``dc``: the neighbour above (C) when |F_A − F_B| < |F_B − F_C|
    (A left, B above-left, in dequantised units, 1024 outside the VOP),
    else the left one; divided by the scaler, rounded."""
    f = np.pad(dc * DC_SCALER, ((1, 0), (1, 0)), constant_values=1024)
    a, b, c = f[1:, :-1], f[:-1, :-1], f[:-1, 1:]
    pred = np.where(np.abs(a - b) < np.abs(b - c), c, a)
    return (pred + (DC_SCALER >> 1)) // DC_SCALER


# the "simple" inverse DCT of ffmpeg's decoder (simple_idct_template.c,
# 8-bit): cos(k·pi/16)·sqrt(2)·2^14, W4 one short; rows to 16 bits by
# 11, columns by 20
_W = (16383, 22725, 21407, 19266, 16383, 12873, 8867, 4520)


def _simple_idct_1d(x, shift: int, bias):
    w = _W
    a = w[4] * x[0] + bias
    a0 = a + w[2] * x[2] + w[4] * x[4] + w[6] * x[6]
    a1 = a + w[6] * x[2] - w[4] * x[4] - w[2] * x[6]
    a2 = a - w[6] * x[2] - w[4] * x[4] + w[2] * x[6]
    a3 = a - w[2] * x[2] + w[4] * x[4] - w[6] * x[6]
    b0 = w[1] * x[1] + w[3] * x[3] + w[5] * x[5] + w[7] * x[7]
    b1 = w[3] * x[1] - w[7] * x[3] - w[1] * x[5] - w[5] * x[7]
    b2 = w[5] * x[1] - w[1] * x[3] + w[7] * x[5] + w[3] * x[7]
    b3 = w[7] * x[1] - w[5] * x[3] + w[3] * x[5] - w[1] * x[7]
    return [v >> shift for v in (a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                                 a3 - b3, a2 - b2, a1 - b1, a0 - b0)]


def simple_idct(coef: np.ndarray) -> np.ndarray:
    """(..., 64) dequantised coefficients (natural order) -> (..., 8, 8)
    uint8 samples, as ffmpeg's MPEG-4 decoder reconstructs them (its
    simple IDCT: a row of zero AC coefficients is its DC times 8, and the
    rows are held in 16 bits)."""
    blk = coef.astype(np.int64).reshape(coef.shape[:-1] + (8, 8))
    rows = np.stack(_simple_idct_1d([blk[..., k] for k in range(8)], 11,
                                    1 << 10), axis=-1)
    dc_only = (blk[..., 1:] == 0).all(axis=-1, keepdims=True)
    rows = np.where(dc_only, (blk[..., :1] * 8) & 0xFFFF, rows)
    rows = ((rows + 0x8000) & 0xFFFF) - 0x8000
    cols = _simple_idct_1d([rows[..., k, :] for k in range(8)], 20,
                           _W[4] * ((1 << 19) // _W[4]))
    return np.clip(np.stack(cols, axis=-2), 0, 255).astype(np.uint8)


def encode_vop_plain(rgb: np.ndarray, index: int,
                     fps: int) -> tuple[bytes, tuple]:
    """The plain version of ``encode_vop`` and ``reconstruct``: frame
    ``index``'s I-VOP bytes for an (H, W, 3) uint8 frame of even sides,
    and the reconstruction (Y, Cb, Cr) planes, cropped to (H, W) and
    (H/2, W/2)."""
    h, w = rgb.shape[:2]
    planes = rgb_to_planes(rgb)
    mbh, mbw = planes[0].shape[0] // 16, planes[0].shape[1] // 16
    nmb = mbh * mbw
    levels, recon = [], []
    for p in planes:
        q = _quantize(_fdct(_blocks(p).astype(np.int64) - 128))
        levels.append((q, q[..., 0] - _dc_predict(q[..., 0])))
        # what a decoder reconstructs (QSCALE even: one less)
        deq = np.where(q == 0, 0, QSCALE * (2 * np.abs(q) + 1) - 1
                       ) * np.sign(q)
        deq[..., 0] = q[..., 0] * DC_SCALER
        blk = simple_idct(np.clip(deq, -2048, 2047))
        r, c = blk.shape[:2]
        recon.append(blk.transpose(0, 2, 1, 3).reshape(r * 8, c * 8))
    # blocks in stream order: per macroblock Y0 Y1 Y2 Y3 Cb Cr
    (qy, dy), (qb, db), (qr, dr) = levels
    qy = qy.reshape(mbh, 2, mbw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        nmb, 4, 64)
    dy = dy.reshape(mbh, 2, mbw, 2).transpose(0, 2, 1, 3).reshape(nmb, 4)
    coef = np.concatenate([qy, qb.reshape(nmb, 1, 64),
                           qr.reshape(nmb, 1, 64)], axis=1).reshape(-1, 64)
    ddc = np.concatenate([dy, db.reshape(nmb, 1), dr.reshape(nmb, 1)],
                         axis=1).reshape(-1)
    nb = 6 * nmb
    luma = np.tile(np.arange(6) < 4, nmb)
    ac = coef[:, ZIGZAG[1:64]]                  # zigzag positions 1..63
    coded = (ac != 0).any(axis=1).reshape(nmb, 6)
    cbpc = coded[:, 4] * 2 + coded[:, 5]
    cbpy = (coded[:, :4] * np.array([8, 4, 2, 1])).sum(axis=1)
    keys, vals, lens = [], [], []

    def emit(key, v, n):
        keys.append(key)
        vals.append(np.asarray(v, np.int64))
        lens.append(np.asarray(n, np.int64))

    mb_key = np.arange(nmb) * 6 * 128
    mcbpc = np.array(_MCBPC)
    cbpy_t = np.array(_CBPY)
    emit(mb_key, mcbpc[cbpc, 0], mcbpc[cbpc, 1])
    emit(mb_key + 1, np.zeros(nmb), np.ones(nmb))       # ac_pred_flag
    emit(mb_key + 2, cbpy_t[cbpy, 0], cbpy_t[cbpy, 1])
    # each block's items after its macroblock's three: the DC size code,
    # its bits and marker, then each AC coefficient at its zigzag place
    bkey = np.arange(nb) * 128 + 3
    size = _category(ddc)
    dct = np.where(luma[:, None], np.array(_DC_LUMA)[size],
                   np.array(_DC_CHROMA)[size])
    emit(bkey, dct[:, 0], dct[:, 1])
    emit(bkey + 1, np.where(ddc < 0, ddc - 1, ddc) & ((1 << size) - 1), size)
    emit(bkey + 2, np.ones(nb), np.where(size > 8, 1, 0))
    bi, k = np.nonzero(ac)                            # row-major
    lv = ac[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    last = np.ones(len(bi), bool)
    last[:-1] = bi[1:] != bi[:-1]
    prev = np.where(first, -1, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    mag = np.abs(lv)
    inside = mag <= MAX_LEVEL
    li, ri, mi = last.astype(np.int64), run, np.minimum(mag, MAX_LEVEL)
    tlen = np.where(inside, _TC_LEN[li, ri, mi], 0)
    vlc = tlen > 0
    sign = (lv < 0).astype(np.int64)
    esc = ((((((ESCAPE[0] << 2 | 3) << 1 | li) << 6 | run) << 1 | 1) << 12
            | (lv & 0xFFF)) << 1) | 1
    emit(bi * 128 + 6 + k,
         np.where(vlc, _TC_CODE[li, ri, mi] << 1 | sign, esc),
         np.where(vlc, tlen + 1, 30))
    shapes = [x.shape for x in keys]
    vals, lens = (np.concatenate([np.broadcast_to(x, sh)
                                  for x, sh in zip(a, shapes)])
                  for a in (vals, lens))
    order = np.argsort(np.concatenate(keys), kind="stable")
    head = vop_header(index, fps)
    v = np.concatenate([[c for c, _ in head], vals[order]])
    n = np.concatenate([[b for _, b in head], lens[order]])
    pad = -int(n.sum() + 1) % 8
    v = np.concatenate([v, [0, (1 << pad) - 1]])
    n = np.concatenate([n, [1, pad]])
    return _pack(v, n), (recon[0][:h, :w], recon[1][:h // 2, :w // 2],
                         recon[2][:h // 2, :w // 2])


# ---------------------------------------------------------------------------
# the main path: host C++
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..ops import _build

        lib = _build.load_host("mpeg4_encode")
        lib.gstex_mp4v_vop.restype = ctypes.c_long
        lib.gstex_mp4v_vop.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        _lib = lib
    return _lib


def _vop(rgb: np.ndarray, index: int, fps: int, planes):
    """Run ``csrc/mpeg4_encode.cpp`` on one frame: the VOP's bytes, and
    the reconstruction into ``planes`` when it is an array."""
    lib = _library()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    if rgb.ndim != 3 or rgb.shape[2] != 3 or h % 2 or w % 2:
        raise ValueError(f"encode_vop takes (H, W, 3) frames of even "
                         f"sides, not {rgb.shape}")
    cap = 64 + 6 * 64 * 30 // 8 * (-(-h // 16)) * (-(-w // 16)) * 2
    out = np.empty(cap, np.uint8)
    n = lib.gstex_mp4v_vop(rgb.ctypes.data, h, w, index, fps,
                           out.ctypes.data, cap,
                           None if planes is None else planes.ctypes.data)
    if n < 0:
        raise RuntimeError("the VOP outgrew its buffer")
    return out[:n].tobytes()


def encode_vop(rgb: np.ndarray, index: int, fps: int) -> bytes:
    """Frame ``index``'s I-VOP bytes for an (H, W, 3) uint8 frame of even
    sides, encoded by ``csrc/mpeg4_encode.cpp``."""
    return _vop(rgb, index, fps, None)


def reconstruct(rgb: np.ndarray) -> tuple:
    """The (Y, Cb, Cr) planes a decoder shows of ``encode_vop``'s bytes
    for ``rgb``, as ``encode_vop_plain`` gives them (the same C++)."""
    h, w = rgb.shape[:2]
    planes = np.empty(h * w * 3 // 2, np.uint8)
    _vop(rgb, 0, 1, planes)
    return (planes[:h * w].reshape(h, w),
            planes[h * w:h * w * 5 // 4].reshape(h // 2, w // 2),
            planes[h * w * 5 // 4:].reshape(h // 2, w // 2))


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(width, height, fps, sizes, offset, headers, max_bytes) -> bytes:
    n = len(sizes)
    movie = round(n * 1000 / fps)
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, 1000, movie), struct.pack(">IH", 0x10000, 0x100),
        bytes(10), _MATRIX, bytes(24), struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(
        ">IIIII", 0, 0, 1, 0, movie), bytes(8), struct.pack(
        ">hhhH", 0, 0, 0, 0), _MATRIX, struct.pack(
        ">II", width << 16, height << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n,
                                                0x55C4, 0))
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide",
                     bytes(12), b"VideoHandler\x00")
    vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 0, 1)))
    avg = int(sum(sizes) * 8 * fps / max(n, 1))
    es = _descriptor(0x03, struct.pack(">HB", 1, 0) + _descriptor(
        0x04, bytes([0x20, 0x11]) + max_bytes.to_bytes(3, "big")
        + struct.pack(">II", max_bytes * 8 * fps, avg)
        + _descriptor(0x05, headers)) + _descriptor(0x06, b"\x02"))
    entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", width, height, 0x480000, 0x480000,
                             0, 1), bytes(32), struct.pack(">Hh", 0x18, -1),
                 _full_box(b"esds", 0, 0, es))
    stbl = _box(
        b"stbl",
        _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
        _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
        _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
        _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
        _full_box(b"stco", 0, 0, struct.pack(">II", 1, offset)))
    minf = _box(b"minf", vmhd, dinf, stbl)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
    return _box(b"moov", mvhd, trak)


class Mp4Writer:
    """An .mp4 of intra-coded MPEG-4 Part 2 video, written frame by frame:
    ``write`` encodes a frame (``encode_vop``) and appends it to
    ``mdat``; ``close`` writes ``moov``. Per frame, ``sizes`` holds its
    bytes, ``encode_ms`` the encode's time on the host."""

    def __init__(self, path, fps: int, size: tuple[int, int]):
        self.fps = int(fps)
        self.size = (int(size[0]), int(size[1]))
        self.width, self.height = even_size(*self.size)
        self.headers = stream_headers(self.width, self.height, self.fps)
        self.sizes: list[int] = []
        self.encode_ms: list[float] = []
        self._f = io.open(path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 512),
                           b"isomiso2mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 0))

    def write(self, rgb: np.ndarray) -> None:
        rgb = np.asarray(rgb)
        want = (self.size[1], self.size[0], 3)
        if rgb.shape != want or rgb.dtype != np.uint8:
            raise ValueError(f"frame of {rgb.shape} {rgb.dtype}: this writer "
                             f"takes ({self.size[1]}, {self.size[0]}, 3) "
                             f"uint8")
        frame = rgb[:self.height, :self.width]
        t0 = time.perf_counter()
        data = encode_vop(frame, len(self.sizes), self.fps)
        self.encode_ms.append(1e3 * (time.perf_counter() - t0))
        if not self.sizes:
            data = self.headers + data
        self._f.write(data)
        self.sizes.append(len(data))

    def close(self) -> None:
        if self._f.closed:
            return
        end = self._f.tell()
        offset = self._mdat + 16
        self._f.write(_moov(self.width, self.height, self.fps, self.sizes,
                            offset, self.headers, max(self.sizes, default=0)))
        self._f.seek(self._mdat + 8)
        self._f.write(struct.pack(">Q", end - self._mdat))
        self._f.close()


def open(path, fps: int, size: tuple[int, int]) -> Mp4Writer:  # noqa: A001
    """An ``Mp4Writer`` of ``size`` = (width, height) frames at ``fps``
    (an int, as cv2's writer takes it for ``gstex-render``)."""
    return Mp4Writer(path, fps, size)
