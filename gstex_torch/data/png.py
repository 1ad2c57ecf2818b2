"""8-bit PNG reading and writing with ``zlib`` and numpy (no image
library): non-interlaced grey, grey-alpha, RGB and RGBA, all five row
filters. ``read_image`` reads a PNG or a JPEG (``data/jpeg.py``)
by the file's signature, not its suffix, and masks of either are read as
PIL's ``convert("L")`` reads them. The card's machine has no image
library."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import SIGNATURE as JPEG_SIGNATURE
from .jpeg import read_jpeg

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel: grey, RGB, grey-alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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
    """An (H, W, C) uint8 array from an 8-bit, non-interlaced grey (C 1),
    grey-alpha (2), RGB (3) or RGBA (4) PNG; anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == JPEG_SIGNATURE:
        raise ValueError(f"{path} is a JPEG image, not a PNG: read it with "
                         f"read_image")
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
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, "
                         f"grey-alpha, RGB and RGBA PNGs are read (bit depth "
                         f"{depth}, colour type {ctype}, interlace "
                         f"{interlace})")
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


def to_grey(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 grey levels of an (H, W, C) image as PIL's
    ``convert("L")`` makes them: grey as it is (alpha dropped), colour by
    the ITU-R 601 weights 299/587/114 per mille in PIL's fixed point."""
    if img.shape[-1] <= 2:
        return img[..., 0]
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def read_image(path) -> np.ndarray:
    """(H, W, C) uint8 samples of a PNG (``read_png``) or a JPEG
    (``jpeg.read_jpeg``: C 1 or 3), told apart by the file's signature."""
    with open(path, "rb") as f:
        head = f.read(3)
    if head == JPEG_SIGNATURE:
        return read_jpeg(path)
    return read_png(path)


def read_mask(path) -> np.ndarray:
    """A binary (H, W) uint8 mask from a PNG or JPEG: 1 where its grey
    level (as ``to_grey``: a grey file's samples, a colour one's luma) is
    above 127."""
    return (to_grey(read_image(path)) > 127).astype(np.uint8)


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, C) uint8 image, C of 1 to 4, as an 8-bit grey,
    grey-alpha, RGB or RGBA PNG (no row filters)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """The bytes of ``write_png``'s file for ``img``."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    img = np.ascontiguousarray(img, np.uint8)
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
