"""Helpers of the JPEG tests: a lossless (SOF3) writer after ITU T.81
Annex H, and headers of the streams that PIL and the port refuse."""

import struct

import numpy as np

# one Huffman table for the 17 difference categories: six codes of 3
# bits, three of 4, then one each of 5 to 12 bits (no all-ones code)
LOSSLESS_BITS = [0, 0, 6, 3, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _codes():
    out, code, k = {}, 0, 0
    for length, n in enumerate(LOSSLESS_BITS, 1):
        for _ in range(n):
            out[k] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _predict(x, y, c, sel, pt):
    if y == 0 and c == 0:
        return 1 << (7 - pt)
    if y == 0:
        return int(x[y, c - 1])
    if c == 0:
        return int(x[y - 1, c])
    ra, rb, rc = int(x[y, c - 1]), int(x[y - 1, c]), int(x[y - 1, c - 1])
    return [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1][sel - 1]


def lossless_jpeg(img: np.ndarray, predictor: int = 1, pt: int = 0,
                  app: bytes = b"", ids=None, sampling=None) -> bytes:
    """An 8-bit lossless JPEG of an (H, W) or (H, W, C) uint8 image: one
    interleaved scan, predictor ``predictor`` (1-7) and point transform
    ``pt``; ``app`` goes after SOI. Every component is sampled 1x1, or
    at its (h, v) of ``sampling``: its plane takes every (hmax / h)-th
    column and (vmax / v)-th row of the image, whose size must be a
    multiple of (vmax, hmax)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    sampling = sampling or [(1, 1)] * nc
    hmax = max(sh for sh, _ in sampling)
    vmax = max(sv for _, sv in sampling)
    assert h % vmax == 0 and w % hmax == 0
    planes = [img[::vmax // sv, ::hmax // sh, c].astype(np.int64) >> pt
              for c, (sh, sv) in enumerate(sampling)]
    diffs = [[[(int(x[yy, xx]) - _predict(x, yy, xx, predictor, pt))
               & 0xFFFF for xx in range(x.shape[1])]
              for yy in range(x.shape[0])] for x in planes]
    codes, bits = _codes(), []
    for my in range(h // vmax):
        for mx in range(w // hmax):
            for c, (sh, sv) in enumerate(sampling):
                for v in range(sv):
                    for u in range(sh):
                        d = diffs[c][my * sv + v][mx * sh + u]
                        d = d - 65536 if d > 32768 else d
                        s = abs(d).bit_length() if d != 32768 else 16
                        bits.append(codes[s])
                        if 0 < s < 16:
                            bits.append(((d if d >= 0 else d - 1)
                                         & ((1 << s) - 1), s))
    acc = "".join(format(v, f"0{n}b") for v, n in bits)
    acc += "1" * (-len(acc) % 8)
    data = bytearray()
    for i in range(0, len(acc), 8):
        data.append(int(acc[i:i + 8], 2))
        if data[-1] == 0xFF:
            data.append(0)
    ids = ids or list(range(1, nc + 1))
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([ids[i], sh << 4 | sv, 0])
        for i, (sh, sv) in enumerate(sampling))
    sos = bytes([nc]) + b"".join(bytes([ids[i], 0]) for i in range(nc))
    return (b"\xff\xd8" + app + marker(0xC3, sof)
            + marker(0xC4, bytes([0]) + bytes(LOSSLESS_BITS)
                     + bytes(range(17)))
            + marker(0xDA, sos + bytes([predictor, 0, pt])) + bytes(data)
            + b"\xff\xd9")


def frame_only(sof: int, precision: int = 8, nc: int = 3) -> bytes:
    """SOI, a frame header of marker ``sof`` and a scan of zeros: what a
    decoder refuses by its frame header alone."""
    body = struct.pack(">BHHB", precision, 16, 16, nc) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(nc))
    sos = bytes([nc]) + b"".join(bytes([i + 1, 0]) for i in range(nc))
    return (b"\xff\xd8" + marker(sof, body)
            + marker(0xDA, sos + b"\x00\x3f\x00") + bytes(64) + b"\xff\xd9")


def with_huffman_table(data: bytes, cls: int, counts=None,
                       values=None) -> bytes:
    """``data`` with the first Huffman table of class ``cls`` (0 DC or
    lossless, 1 AC) given other ``counts`` (16 bytes) or ``values``, of
    the same total, so no segment length changes."""
    pos = 2
    while data[pos + 1] != 0xDA:
        size = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xC4:
            q = pos + 4
            while q < pos + 2 + size:
                n = sum(data[q + 1:q + 17])
                if data[q] >> 4 == cls:
                    counts = bytes(counts or data[q + 1:q + 17])
                    values = bytes(values or data[q + 17:q + 17 + n])
                    assert sum(counts) == len(values) == n
                    return (data[:q + 1] + counts + values
                            + data[q + 17 + n:])
                q += 17 + n
        pos += 2 + size
    raise ValueError(f"no Huffman table of class {cls}")
