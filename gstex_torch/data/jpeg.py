"""Baseline JPEG decoding and encoding with numpy (no image library), to
the bytes of libjpeg-turbo, which PIL and cv2 use.

Decoding covers baseline and extended-sequential Huffman streams of 8-bit
samples: grey, and YCbCr (or Adobe/'RGB'-tagged RGB) at 4:4:4, 4:2:2 and
4:2:0, restart markers, any image size, APPn and COM segments skipped.
It mirrors libjpeg-turbo's default decompression: the integer "islow"
inverse DCT (``jidctint.c``), "fancy" triangular chroma upsampling
(``h2v1_fancy_upsample`` / ``h2v2_fancy_upsample``, edges replicated at
the component's own size) and the fixed-point YCbCr->RGB tables
(``jdcolor.c``), so a frame decodes to the bytes of PIL's
``Image.open(path).convert("RGB")``. Progressive, lossless,
arithmetic-coded, 12-bit and CMYK streams raise ``ValueError``.

``decode`` is the main path: the whole decode in host C++
(``csrc/jpeg_decode.cpp``, built at first use by ``ops/_build.py`` and
called through ctypes, which releases the GIL, so frames decode in a
thread pool). ``decode_plain`` is the same decoder in Python and numpy,
its plain version, kept for the tests. A failed build raises; nothing
falls back to the plain version.

``encode`` is the counterpart of PIL's ``save(format="JPEG",
quality=q)`` with its defaults: libjpeg's quality scaling of the standard
quantization tables, 4:2:0 for colour (grey stays one component), the
standard Huffman tables, the integer forward DCT (``jfdctint.c``) and
libjpeg-turbo's reciprocal quantization, a JFIF APP0 header; its bytes
are PIL's.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

SIGNATURE = b"\xff\xd8\xff"
UNSUPPORTED = "ROADMAP Queue 1 item 10"

# zigzag position -> natural (row-major) index; the 16 extra entries keep
# a corrupt run inside the block, as libjpeg's jpeg_natural_order does
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16, np.int64)

_SOF_MODES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what} JPEG streams are not decoded by the port "
                      f"(baseline Huffman 8-bit only): {UNSUPPORTED}")


# ---------------------------------------------------------------------------
# stream structure
# ---------------------------------------------------------------------------

class _Stream:
    """The markers of one JPEG stream, parsed."""

    def __init__(self, data: bytes):
        if data[:3] != SIGNATURE:
            raise ValueError("not a JPEG stream (no SOI marker)")
        self.data = data
        self.qt = {}                 # id -> (64,) int64, natural order
        self.huff = {}               # (class, id) -> (bits[16], values)
        self.comps = []              # dicts: id, h, v, tq
        self.height = self.width = 0
        self.restart = 0
        self.jfif = False
        self.adobe = None            # Adobe APP14 transform flag
        self.scans = []              # (components, tables, segments)
        pos = 2
        n = len(data)
        while pos < n:
            if data[pos] != 0xFF:
                raise ValueError(f"JPEG stream: no marker at byte {pos}")
            while pos < n and data[pos] == 0xFF:
                pos += 1
            marker = data[pos]
            pos += 1
            if marker == 0xD9:
                break
            if marker == 0x01 or 0xD0 <= marker <= 0xD7:
                continue
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            body = data[pos + 2:pos + length]
            pos += length
            if marker in (0xC0, 0xC1):
                self._frame(body)
            elif marker in _SOF_MODES:
                raise _unsupported(_SOF_MODES[marker])
            elif marker == 0xCC:
                raise _unsupported("arithmetic-coded")
            elif marker == 0xC4:
                self._huffman(body)
            elif marker == 0xDB:
                self._quant(body)
            elif marker == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif marker == 0xE0 and body[:5] == b"JFIF\x00":
                self.jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                self.adobe = body[11]
            elif marker == 0xDA:
                pos = self._scan(body, pos)
        if not self.comps:
            raise ValueError("JPEG stream has no frame header")
        if not self.scans:
            raise ValueError("JPEG stream has no scan")

    def _frame(self, body: bytes) -> None:
        precision, self.height, self.width, nc = struct.unpack(">BHHB",
                                                               body[:6])
        if precision != 8:
            raise _unsupported(f"{precision}-bit")
        if nc == 4:
            raise _unsupported("CMYK/YCCK (4-component)")
        if nc not in (1, 3):
            raise _unsupported(f"{nc}-component")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG frame with a zero size (DNL) is not "
                             "supported")
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                               "tq": tq})

    def _huffman(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            bits = list(body[pos + 1:pos + 17])
            values = list(body[pos + 17:pos + 17 + sum(bits)])
            self.huff[(tc_th >> 4, tc_th & 15)] = (bits, values)
            pos += 17 + sum(bits)

    def _quant(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            if pq == 0:
                zz = np.frombuffer(body[pos + 1:pos + 65], np.uint8)
                pos += 65
            else:
                zz = np.frombuffer(body[pos + 1:pos + 129], ">u2")
                pos += 129
            table = np.zeros(64, np.int64)
            table[ZIGZAG[:64]] = zz
            self.qt[tq] = table

    def _scan(self, body: bytes, pos: int) -> int:
        ns = body[0]
        entries, tables = [], []
        for i in range(ns):
            cid, tdta = body[1 + 2 * i:3 + 2 * i]
            ci = next((k for k, c in enumerate(self.comps) if c["id"] == cid),
                      None)
            if ci is None:
                raise ValueError(f"JPEG scan names unknown component {cid}")
            entries.append(ci)
            tables.append((tdta >> 4, tdta & 15))
        ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
        if ss != 0 or se != 63 or ahal != 0:
            raise _unsupported("progressive (spectral selection)")
        segments, end = _entropy_segments(self.data, pos)
        self.scans.append((entries, tables, segments))
        return end

    # geometry --------------------------------------------------------------
    @property
    def hmax(self) -> int:
        return max(c["h"] for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c["v"] for c in self.comps)

    def comp_size(self, c) -> tuple[int, int]:
        """(rows, cols) of a component's samples (libjpeg's
        downsampled_height / downsampled_width)."""
        return (-(-self.height * c["v"] // self.vmax),
                -(-self.width * c["h"] // self.hmax))

    def mcus(self) -> tuple[int, int]:
        return (-(-self.height // (8 * self.vmax)),
                -(-self.width // (8 * self.hmax)))

    def color_space(self) -> str:
        """'grey', 'ycc' or 'rgb', as libjpeg's default_decompress_parms
        decides."""
        if len(self.comps) == 1:
            return "grey"
        if self.jfif:
            return "ycc"
        if self.adobe is not None:
            return "rgb" if self.adobe == 0 else "ycc"
        ids = [c["id"] for c in self.comps]
        return "rgb" if ids == [82, 71, 66] else "ycc"

    def check_sampling(self) -> None:
        for c in self.comps:
            rh, rv = self.hmax // c["h"], self.vmax // c["v"]
            if (self.hmax % c["h"] or self.vmax % c["v"]
                    or (rh, rv) not in ((1, 1), (2, 1), (2, 2))):
                raise _unsupported(
                    f"chroma sampling {c['h']}x{c['v']} of "
                    f"{self.hmax}x{self.vmax}")


def _entropy_segments(data: bytes, pos: int) -> tuple[list, int]:
    """The entropy-coded data of a scan from ``pos``: a list of byte
    strings split at restart markers, byte stuffing removed; and the
    position of the marker that ends the scan."""
    segments, cur = [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            cur += data[pos:]
            segments.append(bytes(cur))
            return segments, n
        cur += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            segments.append(bytes(cur))
            return segments, j


# ---------------------------------------------------------------------------
# entropy decoding (the plain version's Python loop)
# ---------------------------------------------------------------------------

class _Huffman:
    """Canonical decoding tables: per code length, the least and greatest
    code and the index of its first value."""

    def __init__(self, bits, values):
        self.values = values
        self.mincode, self.maxcode, self.valptr = [0] * 17, [-1] * 18, [0] * 17
        code = k = 0
        for length in range(1, 17):
            n = bits[length - 1]
            self.valptr[length] = k
            self.mincode[length] = code
            code += n
            k += n
            self.maxcode[length] = code - 1 if n else -1
            code <<= 1
        self.maxcode[17] = 1 << 30


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def bit(self) -> int:
        i = self.pos >> 3
        byte = self.data[i] if i < len(self.data) else 0
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def decode(self, h: _Huffman) -> int:
        code = self.bit()
        length = 1
        while length <= 16 and code > h.maxcode[length]:
            code = (code << 1) | self.bit()
            length += 1
        if length > 16:
            return 0               # corrupt data: libjpeg returns 0
        return h.values[h.valptr[length] + code - h.mincode[length]]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_block(bits: _Bits, dc: _Huffman, ac: _Huffman, pred: int,
                  out: np.ndarray) -> int:
    s = bits.decode(dc)
    pred += _extend(bits.bits(s), s) if s else 0
    out[0] = pred
    k = 1
    while k < 64:
        rs = bits.decode(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            out[ZIGZAG[k]] = _extend(bits.bits(s), s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break
    return pred


def _coefficients(st: _Stream) -> list[np.ndarray]:
    """Each component's quantized coefficients, (rows, cols, 64) blocks in
    natural order, decoded by the Python loop."""
    my, mx = st.mcus()
    coefs = [np.zeros((my * c["v"], mx * c["h"], 64), np.int64)
             for c in st.comps]
    for entries, tables, segments in st.scans:
        hufs = [(_Huffman(*st.huff[(0, td)]), _Huffman(*st.huff[(1, ta)]))
                for td, ta in tables]
        if len(entries) == 1:
            c = st.comps[entries[0]]
            rows, cols = st.comp_size(c)
            units = [[(entries[0], 0, by, bx)]
                     for by in range(-(-rows // 8))
                     for bx in range(-(-cols // 8))]
        else:
            units = []
            for my_i in range(my):
                for mx_i in range(mx):
                    unit = []
                    for e, ci in enumerate(entries):
                        c = st.comps[ci]
                        for v in range(c["v"]):
                            for h in range(c["h"]):
                                unit.append((ci, e, my_i * c["v"] + v,
                                             mx_i * c["h"] + h))
                    units.append(unit)
        per_segment = st.restart or len(units)
        for s0 in range(0, len(units), per_segment):
            seg = s0 // per_segment
            bits = _Bits(segments[seg] if seg < len(segments) else b"")
            pred = [0] * len(st.comps)
            for unit in units[s0:s0 + per_segment]:
                for ci, e, by, bx in unit:
                    dc, ac = hufs[0] if len(entries) == 1 else hufs[e]
                    pred[ci] = _decode_block(bits, dc, ac, pred[ci],
                                             coefs[ci][by, bx])
    return coefs


# ---------------------------------------------------------------------------
# the integer inverse DCT, upsampling and colour conversion (numpy)
# ---------------------------------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x, shift):
    """jidctint's 1-D pass on x[0..7] (int64 arrays), descaled by
    ``shift`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 + z3 * -_F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0, tmp1 = tmp0 * _F0298, tmp1 * _F2053
    tmp2, tmp3 = tmp2 * _F3072, tmp3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    return [_descale(v, shift) for v in (
        t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
        t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3)]


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) quantized coefficients (natural order) -> (..., 8, 8)
    uint8 samples, as libjpeg-turbo's ``jpeg_idct_islow`` (its SIMD
    versions saturate where the C version's range table would wrap; the
    two agree on every in-range value, and this one saturates)."""
    blk = (coef.astype(np.int64) * qt).reshape(coef.shape[:-1] + (8, 8))
    cols = _idct_1d([blk[..., k, :] for k in range(8)],
                    _CONST_BITS - _PASS1_BITS)
    work = np.stack(cols, axis=-2)                 # (..., row, col)
    rows = _idct_1d([work[..., :, k] for k in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=-1) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def _plane(blocks: np.ndarray) -> np.ndarray:
    """(rows, cols, 8, 8) sample blocks -> (rows*8, cols*8)."""
    r, c = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, c * 8)


def _fancy_h2(p: np.ndarray, width: int, bias_left: int, bias_right: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle filter on (column sums of) ``p``: output column
    2c is (3·p[c] + p[c−1] + bias_left) >> shift, 2c+1 is (3·p[c] + p[c+1]
    + bias_right) >> shift; edges replicated."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + bias_left) >> shift
    out[:, 1::2] = (3 * p + right + bias_right) >> shift
    return out[:, :width]


def upsample_fancy(p: np.ndarray, rh: int, rv: int, height: int,
                   width: int) -> np.ndarray:
    """A component's (rows, cols) samples upsampled by (rh, rv) as
    libjpeg-turbo's h2v1_fancy_upsample (2, 1) and h2v2_fancy_upsample
    (2, 2) do; (1, 1) is the identity. Cropped to (height, width)."""
    p = p.astype(np.int64)
    if (rh, rv) == (1, 1):
        return p[:height, :width]
    if rv == 1:
        return _fancy_h2(p, width, 1, 2, 2)[:height]
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], width), np.int64)
    out[0::2] = _fancy_h2(3 * p + above, width, 8, 7, 4)
    out[1::2] = _fancy_h2(3 * p + below, width, 8, 7, 4)
    return out[:height]


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_I = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _I + 32768) >> 16
_CB_B = (_fix(1.77200) * _I + 32768) >> 16
_CR_G = -_fix(0.71414) * _I
_CB_G = -_fix(0.34414) * _I + 32768


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` tables on int arrays -> (..., 3)
    uint8."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_plain(data: bytes) -> np.ndarray:
    """The plain version of ``decode``: (H, W, 1) grey or (H, W, 3) RGB
    uint8, decoded in Python and numpy."""
    st = _Stream(bytes(data))
    st.check_sampling()
    coefs = _coefficients(st)
    planes = []
    for c, co in zip(st.comps, coefs):
        if c["tq"] not in st.qt:
            raise ValueError(f"JPEG stream lacks quantization table "
                             f"{c['tq']}")
        rows, cols = st.comp_size(c)
        plane = _plane(idct_islow(co, st.qt[c["tq"]]))[:rows, :cols]
        planes.append(upsample_fancy(plane, st.hmax // c["h"],
                                     st.vmax // c["v"], st.height, st.width))
    space = st.color_space()
    if space == "grey":
        return planes[0].astype(np.uint8)[..., None]
    if space == "rgb":
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# the main path: host C++
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..ops import _build

        lib = _build.load_host("jpeg_decode")
        for fn in (lib.gstex_jpeg_info, lib.gstex_jpeg_decode):
            fn.restype = ctypes.c_int
        lib.gstex_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p, ctypes.c_int]
        lib.gstex_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def decode(data: bytes) -> np.ndarray:
    """(H, W, 1) grey or (H, W, 3) RGB uint8 samples of a baseline JPEG
    stream, decoded by ``csrc/jpeg_decode.cpp``."""
    lib = _library()
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    hwc = (ctypes.c_int * 3)()
    if lib.gstex_jpeg_info(data, len(data), hwc, err, 256) != 0:
        raise ValueError(err.value.decode())
    out = np.empty((hwc[0], hwc[1], hwc[2]), np.uint8)
    if lib.gstex_jpeg_decode(data, len(data), out.ctypes.data, err,
                             256) != 0:
        raise ValueError(err.value.decode())
    return out


def jpeg_size(path) -> tuple[int, int]:
    """(height, width) from a JPEG file's frame header, read marker by
    marker up to it."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
        pos = 2
        while True:
            while pos + 4 > len(data):
                more = f.read(1 << 16)
                if not more:
                    raise ValueError(f"{path}: no JPEG frame header")
                data += more
            if data[pos] != 0xFF:
                raise ValueError(f"{path}: no marker at byte {pos}")
            marker = data[pos + 1]
            if marker == 0xFF:
                pos += 1
                continue
            (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                while pos + 9 > len(data):
                    data += f.read(1 << 16)
                return struct.unpack(">HH", data[pos + 5:pos + 9])
            pos += 2 + length


def read_jpeg(path) -> np.ndarray:
    """``decode`` of a file's bytes."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# ---------------------------------------------------------------------------
# encoding (numpy, vectorized over blocks)
# ---------------------------------------------------------------------------

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# the standard Huffman tables (ITU T.81 Annex K.3): bits, values
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
            list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              list(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")))


def _codes(table) -> tuple[np.ndarray, np.ndarray]:
    """(256,) code and (256,) length of each symbol of a Huffman table."""
    bits, values = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[values[k]], len_of[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality(q, force_baseline=TRUE)`` luminance
    and chrominance tables, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def one(basic):
        return np.clip((basic * scale + 50) // 100, 1, 255)

    return one(_STD_LUMA_Q), one(_STD_CHROMA_Q)


def _fdct_1d(x, pass2: bool):
    """jfdctint's 1-D pass; pass 1 scales up by 2^PASS1_BITS, pass 2
    descales."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if pass2:
        out[0] = _descale(t10 + t11, _PASS1_BITS)
        out[4] = _descale(t10 - t11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    else:
        out[0] = (t10 + t11) << _PASS1_BITS
        out[4] = (t10 - t11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    out[2] = _descale(z1 + t13 * _F0765, shift)
    out[6] = _descale(z1 + t12 * -_F1847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return out


def _quantize(d: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's reciprocal quantization of forward-DCT output
    (scaled by 8) by ``qt`` (natural order): (..., 64) int64."""
    div = qt * 8
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // div
    fr = (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, fq)
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    fq = np.where(~pow2 & (fr > div // 2), fq + 1, fq)
    t = np.abs(d)
    q = ((t + c) * fq) >> r
    return np.where(d < 0, -q, q)


def _fdct_quant(samples: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(rows, cols) uint8 plane (a multiple of 8 each way) -> (rows/8,
    cols/8, 64) quantized coefficients, natural order."""
    r, c = samples.shape
    blk = (samples.astype(np.int64) - 128).reshape(r // 8, 8, c // 8, 8)
    blk = blk.transpose(0, 2, 1, 3)                 # (br, bc, row, col)
    rows = _fdct_1d([blk[..., :, k] for k in range(8)], False)
    work = np.stack(rows, axis=-1)
    cols = _fdct_1d([work[..., k, :] for k in range(8)], True)
    d = np.stack(cols, axis=-2).reshape(r // 8, c // 8, 64)
    return _quantize(d, qt)


def _pad_edge(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                  mode="edge")


def _rgb_to_ycc(rgb: np.ndarray):
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off
          + half - 1) >> 16
    cr = (_fix(0.5) * r + off + half - 1 - _fix(0.41869) * g
          - _fix(0.08131) * b) >> 16
    return y, cb, cr


def _downsample_h2v2(p: np.ndarray, out_cols: int) -> np.ndarray:
    """jcsample's h2v2_downsample: 2x2 means with the alternating bias
    1, 2, 1, 2 along each output row; ``p`` already has an even number of
    rows; its columns are replicated out to 2·out_cols first."""
    p = _pad_edge(p, p.shape[0], 2 * out_cols).astype(np.int64)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _component_blocks(plane: np.ndarray, h: int, v: int, mcu_rows: int,
                      mcu_cols: int, qt: np.ndarray) -> np.ndarray:
    """A component's quantized blocks over the whole MCU grid, (mcu_rows·v,
    mcu_cols·h, 64): real blocks from ``plane`` (padded by replication as
    libjpeg's prep and downsample controllers do), dummy blocks past its
    edge as jccoefct makes them (zero AC, the DC of the block before)."""
    rows, cols = plane.shape
    bh, bw = -(-rows // 8), -(-cols // 8)
    coef = _fdct_quant(_pad_edge(plane, bh * 8, bw * 8), qt)
    full = np.zeros((mcu_rows * v, mcu_cols * h, 64), np.int64)
    full[:bh, :bw] = coef
    for bx in range(bw, mcu_cols * h):         # dummy columns
        full[:bh, bx, 0] = full[:bh, bx - 1, 0]
    for by in range(bh, mcu_rows * v):         # dummy rows
        # every block of an MCU's dummy row takes the DC of the MCU
        # buffer's block before the row: the last block of the row above
        full[by, :, 0] = full[by - 1, np.arange(mcu_cols * h) // h * h
                              + h - 1, 0]
    return full


def _huffman_bits(blocks: np.ndarray, comp_of_block: np.ndarray,
                  dc_tabs, ac_tabs) -> tuple[np.ndarray, np.ndarray]:
    """Every code of ``blocks`` ((N, 64) natural order, in stream order,
    each DC already a difference) as (values, lengths) in emission order:
    per block the DC category's code and its magnitude bits, then per
    nonzero AC coefficient a ZRL for each 16 zeros before it, its
    run/size symbol and magnitude bits, then an EOB unless the block's
    last coefficient is nonzero."""
    n = blocks.shape[0]
    zz = blocks[:, ZIGZAG[:64]]
    dc_code = np.stack([t[0] for t in dc_tabs])     # (ncomp, 256)
    dc_len = np.stack([t[1] for t in dc_tabs])
    ac_code = np.stack([t[0] for t in ac_tabs])
    ac_len = np.stack([t[1] for t in ac_tabs])
    comp = comp_of_block
    dc = zz[:, 0]
    dcat = _category(dc)
    ac = zz[:, 1:]
    bi, k = np.nonzero(ac)                          # row-major
    val = ac[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, -1, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    nzrl = run // 16
    cat = _category(val)
    sym = (run % 16) * 16 + cat
    cb = comp[bi]
    last_k = np.full(n, -1)
    last_k[bi] = k
    eob = last_k < 62
    # where each item lands: a block's items are its 2 DC items, then
    # per coefficient its ZRLs, symbol and bits, then its EOB
    per_coef = nzrl + 2
    per_block = 2 + eob + np.bincount(bi, per_coef, minlength=n).astype(
        np.int64)
    block_start = np.concatenate([[0], np.cumsum(per_block)[:-1]])
    coef_end = np.cumsum(per_coef)
    coef_start = coef_end - per_coef
    # offset of each coefficient's items within its block's AC items
    block_first = np.maximum.accumulate(
        np.where(first, np.arange(len(bi)), 0))
    at = block_start[bi] + 2 + coef_start - coef_start[block_first]
    total = int(per_block.sum())
    values = np.zeros(total, np.int64)
    lengths = np.zeros(total, np.int64)
    values[block_start] = dc_code[comp, dcat]
    lengths[block_start] = dc_len[comp, dcat]
    values[block_start + 1] = _magnitude(dc, dcat)
    lengths[block_start + 1] = dcat
    for z in range(3):
        has = nzrl > z
        values[at[has] + z] = ac_code[cb[has], 0xF0]
        lengths[at[has] + z] = ac_len[cb[has], 0xF0]
    values[at + nzrl] = ac_code[cb, sym]
    lengths[at + nzrl] = ac_len[cb, sym]
    values[at + nzrl + 1] = _magnitude(val, cat)
    lengths[at + nzrl + 1] = cat
    end = block_start + per_block - 1
    values[end[eob]] = ac_code[comp[eob], 0]
    lengths[end[eob]] = ac_len[comp[eob], 0]
    return values, lengths


def _category(x: np.ndarray) -> np.ndarray:
    """Bits needed for |x| (0 for 0)."""
    a = np.abs(x)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _magnitude(x: np.ndarray, cat: np.ndarray) -> np.ndarray:
    """The ``cat`` low bits that code ``x`` (negative: x − 1)."""
    return np.where(x < 0, x - 1, x) & ((np.int64(1) << cat) - 1)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length codes MSB first, pad with 1 bits to a
    byte, and stuff a zero byte after every 0xFF."""
    keep = lengths > 0
    values, lengths = values[keep], lengths[keep]
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    # one entry per bit: its code's value, shifted down to that bit
    v = np.repeat(values, lengths)
    shift = np.repeat(start + lengths - 1, lengths) - np.arange(total)
    bits = np.ones(-(-total // 8) * 8, np.uint8)
    bits[:total] = (v >> shift) & 1
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def encode(img: np.ndarray, quality: int = 75) -> bytes:
    """The bytes of PIL's ``Image.fromarray(img).save(f, format="JPEG",
    quality=quality)``: (H, W) or (H, W, 1) grey, (H, W, 3) RGB uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("encode takes uint8 images")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        comps = [(img, 1, 1, 0)]
    elif img.ndim == 3 and img.shape[-1] == 3:
        y, cb, cr = _rgb_to_ycc(img)
        comps = [(y, 2, 2, 0), (cb, 1, 1, 1), (cr, 1, 1, 1)]
    else:
        raise ValueError(f"encode takes grey or RGB images, not "
                         f"{img.shape}")
    height, width = img.shape[:2]
    lq, cq = quality_tables(quality)
    qts = (lq, cq)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcu_rows, mcu_cols = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    coefs = []
    for plane, h, v, tq in comps:
        if (h, v) == (hmax, vmax):
            samples = plane
        else:
            ccols = -(-width * h // hmax)
            bw = -(-ccols // 8)
            even = _pad_edge(plane, height + height % 2, width)
            samples = _downsample_h2v2(even, bw * 8)
        coefs.append(_component_blocks(samples, h, v, mcu_rows, mcu_cols,
                                       qts[tq]))
    # stream order: per MCU, each component's h·v blocks in raster order
    order = []
    comp_of = []
    for ci, (_, h, v, _) in enumerate(comps):
        by = (np.arange(mcu_rows)[:, None, None, None] * v
              + np.arange(v)[None, None, :, None])
        bx = (np.arange(mcu_cols)[None, :, None, None] * h
              + np.arange(h)[None, None, None, :])
        by, bx = np.broadcast_arrays(by, bx)
        blk = coefs[ci][by, bx]                 # (mr, mc, v, h, 64)
        order.append(blk.reshape(mcu_rows, mcu_cols, v * h, 64))
        comp_of.append(np.full((mcu_rows, mcu_cols, v * h), ci))
    blocks = np.concatenate(order, axis=2).reshape(-1, 64).copy()
    comp_of_block = np.concatenate(comp_of, axis=2).reshape(-1)
    # DC differences per component, in stream order
    for ci in range(len(comps)):
        sel = comp_of_block == ci
        dc = blocks[sel, 0]
        blocks[sel, 0] = np.diff(dc, prepend=0)
    tab = [0 if c[3] == 0 else 1 for c in comps]
    dc_tabs = [_codes(_DC_LUMA if t == 0 else _DC_CHROMA) for t in tab]
    ac_tabs = [_codes(_AC_LUMA if t == 0 else _AC_CHROMA) for t in tab]
    values, lengths = _huffman_bits(blocks, comp_of_block, dc_tabs,
                                       ac_tabs)
    scan = _pack(values, lengths)

    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq in sorted({c[3] for c in comps}):
        out.append(_marker(0xDB, bytes([tq]) + bytes(
            qts[tq][ZIGZAG[:64]].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for ci, (_, h, v, tq) in enumerate(comps):
        sof += bytes([ci + 1, h * 16 + v, tq])
    out.append(_marker(0xC0, sof))
    for tq in sorted({c[3] for c in comps}):
        for cls, tables in ((0, (_DC_LUMA, _DC_CHROMA)),
                            (1, (_AC_LUMA, _AC_CHROMA))):
            bits, vals = tables[tq]
            out.append(_marker(0xC4, bytes([cls * 16 + tq]) + bytes(bits)
                               + bytes(vals)))
    sos = bytes([len(comps)])
    for ci, (_, _, _, tq) in enumerate(comps):
        sos += bytes([ci + 1, tq * 16 + tq])
    out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img: np.ndarray, quality: int = 75) -> None:
    """Write ``encode(img, quality)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode(img, quality))
