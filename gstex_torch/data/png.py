"""8-bit PNG reading and writing with ``zlib`` and numpy (no image
library): non-interlaced RGB and RGBA, all five row filters."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}   # PNG colour type -> samples per pixel


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec 9.2); uint8 arrays."""
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prior
    if ftype == 1:
        # recon[x] = filt[x] + recon[x - bpp]: a running sum per channel
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} does not exist")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    n = len(out)
    for x in range(n):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """An (H, W, C) uint8 array from an 8-bit, non-interlaced RGB or RGBA
    PNG; anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB and RGBA "
                         f"PNGs are read (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior,
                                       bpp)
    return out.reshape(height, width, bpp)


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 image as an 8-bit RGB or RGBA
    PNG (no row filters)."""
    h, w, c = img.shape
    ctype = {3: 2, 4: 6}[c]
    img = np.ascontiguousarray(img, np.uint8)
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
