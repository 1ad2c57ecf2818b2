"""JPEG decoding and baseline encoding with numpy (no image library), to
the bytes of libjpeg-turbo, which PIL and cv2 use.

Decoding covers every 8-bit stream that PIL's ``Image.open(path)
.convert("RGB")`` decodes through libjpeg-turbo 3:

- baseline and extended-sequential, progressive (``jdphuff.c``: DC and
  AC first and refinement scans, end-of-band runs) and lossless
  (``jdlossls.c``: predictors 1-7, point transform) Huffman streams, and
  arithmetic-coded sequential and progressive ones (``jdarith.c``: the
  QM decoder, DC statistics conditioned by DAC's L and U, AC by K);
- grey, YCbCr, RGB (Adobe transform 0 or component ids 'R', 'G', 'B';
  lossless without JFIF), and CMYK or YCCK (4 components, by the Adobe
  transform), at every integral sampling factor from 1 to 4;
- restart markers, any image size, APPn and COM segments skipped.

It mirrors libjpeg-turbo's default decompression: the integer "islow"
inverse DCT (``jidctint.c``); ``jdsample.c``'s upsampling ("fancy"
triangles for 2x1, 1x2 and 2x2 where the component is more than 2
samples wide, box replication otherwise, and always for lossless
streams); the fixed-point YCbCr->RGB tables (``jdcolor.c``); and for
4 components PIL's inversion of Adobe CMYK and its ``CMYK -> RGB``
conversion. So a frame decodes to the bytes of PIL's
``Image.open(path).convert("RGB")``: grey as one channel, every colour
stream as RGB.

A progressive stream whose scans leave one of the first nine AC
coefficients of a component incomplete is smoothed block by block as
libjpeg does (``jdcoefct.c:decompress_smooth_data``); a complete one is
not.

Streams PIL refuses raise ``ValueError``: 12-bit and 16-bit samples,
differential (hierarchical) frames, arithmetic-coded lossless ones,
fractional sampling ratios, lossless YCbCr, and Huffman tables libjpeg
refuses (a DC symbol past 15, a code of all ones). So do streams cut
short where PIL's libjpeg runs out of data (``_Feed``): a cut marker
segment it needs; a progressive or multi-scan stream without its EOI
marker (read whole before the first line is output); a single scan
whose Huffman decoder reads ahead past the stream's end, its 57-bit
fills replayed from the codes' lengths as jdhuff.c's slow and fast paths
make them (``_HuffFeed``), so that a stream which lacks only its EOI
decodes where PIL's does; arithmetic-coded data that ends before its
last MCU; and arithmetic-coded data across one of PIL's 64 KiB reads,
inside which that decoder cannot suspend.

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
UNSUPPORTED = "PIL refuses them too, so the JAX package's loader does"

# zigzag position -> natural (row-major) index; the 16 extra entries keep
# a corrupt run inside the block, as libjpeg's jpeg_natural_order does
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16, np.int64)
_NATURAL = [int(k) for k in ZIGZAG]

# frame markers: (progressive, lossless, arithmetic)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, True, False),
        0xC9: (False, False, True), 0xCA: (True, False, True)}
_REFUSED_SOF = {
    0xC5: "differential sequential", 0xC6: "differential progressive",
    0xC7: "differential lossless", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}
MAX_BLOCKS_IN_MCU = 10
# the first AC coefficients (zigzag 1-9) whose incomplete bits make
# libjpeg smooth a progressive stream's blocks
_SMOOTHED_COEFS = 9
# jdcoefct.c's block smoothing: per zigzag coefficient k (0 the DC), the
# weights of the 5x5 DC values around a block (rows top to bottom,
# columns left to right) whose sum, times the DC's quantizer, estimates
# it. [0] where some AC data was sent (k 1-5 only), [1] where none was.
def _rows(*r):
    return [list(x) for x in r]


_ODD = (-7, 50, 0, -50, 7)
_EVEN = (-1, 13, -24, 13, -1)
_SMOOTH_K = np.zeros((2, 10, 5, 5), np.int64)
_SMOOTH_K[0, 1, 2] = _ODD
_SMOOTH_K[0, 2, :, 2] = _ODD
_SMOOTH_K[0, 3, :, 2] = _EVEN
_SMOOTH_K[0, 4] = _rows((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0,) * 5,
                        (1, -10, 0, 10, -1), (0, 1, 0, -1, 0))
_SMOOTH_K[0, 5, 2] = _EVEN
_SMOOTH_K[1, 0] = _rows((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6),
                        (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
                        (-2, -6, -8, -6, -2))
_SMOOTH_K[1, 1] = _rows((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3),
                        (-3, 38, 0, -38, 3), (-3, 13, 0, -13, 3),
                        (-1, -1, 0, 1, 1))
_SMOOTH_K[1, 2] = _SMOOTH_K[1, 1].T
_SMOOTH_K[1, 3] = _rows((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
                        (0, 2, 7, 2, 0), (0, 0, 1, 0, 0))
_SMOOTH_K[1, 4] = _rows((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0,) * 5,
                        (0, -9, 0, 9, 0), (1, 0, 0, 0, -1))
_SMOOTH_K[1, 5] = _SMOOTH_K[1, 3].T
_SMOOTH_K[1, 6] = _rows((0,) * 5, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0),
                        (0, 1, 0, -1, 0), (0,) * 5)
_SMOOTH_K[1, 7] = _rows((0,) * 5, (0, 1, -3, 1, 0), (0,) * 5,
                        (0, -1, 3, -1, 0), (0,) * 5)
_SMOOTH_K[1, 8] = _SMOOTH_K[1, 7].T
_SMOOTH_K[1, 9] = _SMOOTH_K[1, 6].T

# ITU T.81 Table D.2 as libjpeg's jaricom.c holds it: per state, Qe, the
# next state after an LPS (with the MPS switch in bit 7) and after an MPS;
# state 113 is the fixed probability 0.5
_QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
# (Qe, next state and sense switch after an LPS, next state after an MPS)
_QE = [(qe, nl | sw << 7, nm) for qe, nl, nm, sw in _QE_TABLE]


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what} JPEG streams are not decoded: {UNSUPPORTED}")


def _truncated(where: str) -> ValueError:
    return ValueError(f"JPEG stream truncated {where}: PIL's libjpeg runs "
                      f"out of data there, and PIL raises")


def _s16(x: int) -> int:
    """x as libjpeg's 16-bit JCOEF holds it."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


# ---------------------------------------------------------------------------
# stream structure
# ---------------------------------------------------------------------------

class _Scan:
    """One scan: its components (frame indices), the tables, spectral
    selection and successive approximation as of its SOS, and its
    entropy-coded segments (split at restart markers), each with the
    stream position of its first byte and of the code byte of the marker
    that ends it (``None`` where the data runs to the stream's end)."""

    def __init__(self, comps, td, ta, ss, se, ah, al, restart, huff, dac,
                 segments, starts, markers):
        self.comps, self.td, self.ta = comps, td, ta
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.restart, self.huff, self.dac = restart, huff, dac
        self.segments, self.starts, self.markers = segments, starts, markers


class _Stream:
    """The markers of one JPEG stream, parsed."""

    def __init__(self, data: bytes):
        if data[:3] != SIGNATURE:
            raise ValueError("not a JPEG stream (no SOI marker)")
        self.data = data
        self.qt = {}                 # id -> (64,) int64, natural order
        self.huff = {}               # (class, id) -> (bits[16], values)
        self.dac_l, self.dac_u, self.dac_k = [0] * 16, [1] * 16, [5] * 16
        self.comps = []              # dicts: id, h, v, tq
        self.height = self.width = 0
        self.progressive = self.lossless = self.arith = False
        self.restart = 0
        self.jfif = False
        self.adobe = None            # Adobe APP14 transform flag
        self.scans = []
        self.eoi = False             # the EOI marker was reached
        pos = 2
        n = len(data)
        while pos < n:
            if data[pos] != 0xFF:
                raise ValueError(f"JPEG stream: no marker at byte {pos}")
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                break
            marker = data[pos]
            pos += 1
            if marker == 0xD9:
                self.eoi = True
                break
            if marker == 0x01 or 0xD0 <= marker <= 0xD7:
                continue
            if pos + 2 > n or pos + struct.unpack(
                    ">H", data[pos:pos + 2])[0] > n:
                # libjpeg reads on past a single scan's data only at the
                # end, whose want of data PIL forgives
                if self.scans and not self.multi_scan:
                    break
                raise _truncated("in a marker segment")
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            body = data[pos + 2:pos + length]
            pos += length
            if marker in _SOF:
                self.progressive, self.lossless, self.arith = _SOF[marker]
                self._frame(body)
            elif marker in _REFUSED_SOF:
                raise _unsupported(_REFUSED_SOF[marker])
            elif marker == 0xC4:
                self._huffman(body)
            elif marker == 0xCC:
                self._dac(body)
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

    @property
    def multi_scan(self) -> bool:
        """libjpeg's has_multiple_scans: a progressive frame, or a first
        scan without every component. Such a stream is read to its EOI
        before the first line is output."""
        return self.progressive or len(self.scans[0].comps) < len(
            self.comps)

    def _frame(self, body: bytes) -> None:
        precision, self.height, self.width, nc = struct.unpack(">BHHB",
                                                               body[:6])
        if precision != 8:
            raise _unsupported(f"{precision}-bit")
        if nc not in (1, 3, 4):
            raise _unsupported(f"{nc}-component")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG frame with a zero size (DNL) is not "
                             "supported")
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                               "tq": tq & 3})
        self.check_sampling()

    def _huffman(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            bits = list(body[pos + 1:pos + 17])
            values = list(body[pos + 17:pos + 17 + sum(bits)])
            self.huff[(tc_th >> 4, tc_th & 15)] = (bits, values)
            pos += 17 + sum(bits)

    def _dac(self, body: bytes) -> None:
        for pos in range(0, len(body) - 1, 2):
            index, val = body[pos], body[pos + 1]
            if index >= 32:
                raise ValueError(f"JPEG DAC table index {index} bad")
            if index >= 16:
                self.dac_k[index - 16] = val
            else:
                self.dac_l[index], self.dac_u[index] = val & 15, val >> 4
                if val & 15 > val >> 4:
                    raise ValueError(f"JPEG DAC value {val} bad")

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
            self.qt[tq & 3] = table

    def _scan(self, body: bytes, pos: int) -> int:
        if not self.comps:
            raise ValueError("JPEG scan before the frame header")
        ns = body[0]
        entries, td, ta = [], [], []
        for i in range(ns):
            cid, tdta = body[1 + 2 * i:3 + 2 * i]
            ci = next((k for k, c in enumerate(self.comps) if c["id"] == cid),
                      None)
            if ci is None:
                raise ValueError(f"JPEG scan names unknown component {cid}")
            entries.append(ci)
            td.append(tdta >> 4)
            ta.append(tdta & 15)
        ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahal >> 4, ahal & 15
        if self.progressive and (ss > se or se > 63 or (ss == 0 and se)
                                 or (ss and ns != 1) or ah > 13 or al > 13):
            raise ValueError(f"JPEG progression bad: Ss {ss} Se {se} "
                             f"Ah {ah} Al {al} over {ns} components")
        if ns > 1 and sum(self.comps[ci]["h"] * self.comps[ci]["v"]
                          for ci in entries) > MAX_BLOCKS_IN_MCU:
            raise _unsupported(f"more than {MAX_BLOCKS_IN_MCU} blocks an MCU")
        if not self.arith:
            for cls, ids in ((0, td), (1, ta)):
                used = (cls == 0 and (self.lossless or ss == 0 and ah == 0)
                        or cls == 1 and not self.lossless and (
                            se > 0 if self.progressive else True))
                if used and any((cls, t) not in self.huff for t in ids):
                    raise ValueError("JPEG scan uses an undefined Huffman "
                                     "table")
                if used and not all(_huffman_usable(
                        *self.huff[(cls, t)],
                        255 if cls else 16 if self.lossless else 15)
                        for t in ids):
                    raise ValueError("JPEG Huffman table bad")
        segments, starts, markers, end = _entropy_segments(self.data, pos)
        self.scans.append(_Scan(
            entries, td, ta, ss, se, ah, al, self.restart,
            {k: _Huffman(*v) for k, v in self.huff.items()},
            (list(self.dac_l), list(self.dac_u), list(self.dac_k)),
            segments, starts, markers))
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
        """The MCU grid of an interleaved scan: one sample an MCU's unit
        in lossless streams, an 8x8 block otherwise."""
        b = 1 if self.lossless else 8
        return (-(-self.height // (b * self.vmax)),
                -(-self.width // (b * self.hmax)))

    def color_space(self) -> str:
        """'grey', 'ycc', 'rgb', 'cmyk' or 'ycck', as libjpeg-turbo's
        default_decompress_parms decides."""
        if len(self.comps) == 1:
            return "grey"
        if len(self.comps) == 4:
            return ("cmyk" if self.adobe is None or self.adobe == 0
                    else "ycck")
        if self.jfif:
            return "ycc"
        if self.adobe is not None:
            return "rgb" if self.adobe == 0 else "ycc"
        ids = [c["id"] for c in self.comps]
        if ids == [82, 71, 66]:
            return "rgb"
        if self.lossless:
            return "rgb"
        return "ycc"

    def check_sampling(self) -> None:
        hmax, vmax = self.hmax, self.vmax
        for c in self.comps:
            if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
                raise _unsupported(f"sampling {c['h']}x{c['v']}")
            if hmax % c["h"] or vmax % c["v"]:
                raise _unsupported(
                    f"fractional sampling ({c['h']}x{c['v']} of "
                    f"{hmax}x{vmax})")


def _entropy_segments(data: bytes, pos: int) -> tuple:
    """The entropy-coded data of a scan from ``pos``: a list of byte
    strings split at restart markers, byte stuffing removed; the stream
    position where each starts; that of the code byte of the marker
    that ends each (``None`` for data that runs to the stream's end);
    and the position of the marker that ends the scan."""
    segments, starts, markers, cur = [], [pos], [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            cur += data[pos:]
            segments.append(bytes(cur))
            markers.append(None)
            return segments, starts, markers, n
        cur += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(cur))
            markers.append(j + 1)
            starts.append(j + 2)
            cur = bytearray()
            pos = j + 2
        else:
            segments.append(bytes(cur))
            markers.append(j + 1)
            return segments, starts, markers, j


# ---------------------------------------------------------------------------
# entropy decoding (the plain version's Python loop)
# ---------------------------------------------------------------------------

def _huffman_usable(bits, values, max_symbol: int) -> bool:
    """jdhuff.c's jpeg_make_d_derived_tbl checks, made where a scan uses
    a table: the counts make a prefix code (no code of all ones), and no
    symbol passes ``max_symbol`` (15 for a DC table, 16 for a lossless
    one, 255 for an AC one)."""
    code = 0
    for length, n in enumerate(bits, 1):
        code += n
        if code >= 1 << length:
            return False
        code <<= 1
    return max(values, default=0) <= max_symbol


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
    """The bits of one restart interval's bytes, zeros after them. With
    ``events`` (a list) each Huffman code appends its length and each
    run of n received bits appends −n, what ``_HuffFeed`` replays."""

    def __init__(self, data: bytes, events=None):
        self.data, self.pos = data, 0
        self.events = events

    def bit(self) -> int:
        i = self.pos >> 3
        byte = self.data[i] if i < len(self.data) else 0
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        if self.events is not None and n:
            self.events.append(-n)
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
        if self.events is not None:
            self.events.append(length)
        if length > 16:
            return 0               # corrupt data: libjpeg returns 0
        return h.values[h.valptr[length] + code - h.mincode[length]]


# How PIL feeds libjpeg-turbo, which decides where a stream cut short
# raises: ``ImageFile.load`` passes the file in reads of 64 KiB
# (``ImageFile.MAXBLOCK``), one more each time the decoder suspends for
# want of data, and raises when there is none. jdhuff.c fills its 64-bit
# bit buffer to at least 57 bits (MIN_GET_BITS) wherever a check finds
# fewer bits than it needs, and decodes an MCU on its fast path (6 bytes
# at a time where 16 bits or fewer are left) where no restart interval
# is set and at least 512 bytes a block (BUFSIZE) are left in the read.
_READ = 1 << 16
_MIN_GET_BITS = 57
_FAST_BYTES_A_BLOCK = 512


class _Feed:
    """A stream as PIL feeds it to libjpeg: ``extent`` bytes read so
    far. ``need`` is a read that may suspend: PIL reads on, and past the
    stream's end raises."""

    def __init__(self, data: bytes):
        self.data, self.n = data, len(data)
        self.extent = min(_READ, self.n)

    def need(self, pos: int) -> None:
        while pos >= self.extent:
            if self.extent >= self.n:
                raise _truncated("in its entropy-coded data")
            self.extent = min(self.extent + _READ, self.n)

    def arith_limit(self, scan: _Scan, seg: int) -> tuple:
        """How many bytes of segment ``seg`` jdarith.c may fetch (the
        marker that ends it counts as one past its data), and the error
        one more raises: its fetches cannot suspend, so one past the
        bytes read so far is an error in PIL."""
        data, end = scan.segments[seg], scan.markers[seg]
        self.need(scan.starts[seg] - 1)
        if end is not None and end < self.extent:
            return len(data) + 1, None
        # the destuffed bytes whose last stream byte was read (an 0xFF
        # needs the byte after it)
        raw = self.data[scan.starts[seg]:self.extent]
        limit = len(raw.replace(b"\xff\x00", b"\xff")) - raw.endswith(
            b"\xff")
        return min(limit, len(data)), (
            _truncated("in its arithmetic-coded data")
            if self.extent == self.n else ValueError(
                "arithmetic-coded JPEG data across one of PIL's 64 KiB "
                "reads is not decoded: PIL's libjpeg cannot suspend inside "
                "it and raises (a broken data stream)"))


class _HuffFeed:
    """libjpeg-turbo's reads of one Huffman scan (jdhuff.c, jdlhuff.c)
    fed as ``_Feed`` feeds them: ``mcu`` replays an MCU's code lengths
    and received bits (``_Bits`` events) through the bit buffer, on the
    fast path where jdhuff.c takes it; an MCU that suspends is taken
    again from its start once PIL has read more."""

    def __init__(self, feed: _Feed, blocks: int, fast: bool):
        self.feed = feed
        self.fast_bytes = _FAST_BYTES_A_BLOCK * blocks if fast else None
        self.q = self.bits = 0
        self.marker = False

    def segment(self, start: int) -> None:
        """A scan's or restart interval's data from ``start``: the
        marker before it read, the bit buffer empty."""
        self.feed.need(start - 1)
        self.q, self.bits, self.marker = start, 0, False

    def mcu(self, events: list) -> None:
        feed = self.feed
        while not self.marker:
            q, bits = self.q, self.bits
            if (self.fast_bytes is not None
                    and feed.extent - q >= self.fast_bytes
                    and self._fast(events)):
                return
            self.q, self.bits = q, bits
            if self._slow(events):
                return
            self.q, self.bits = q, bits
            feed.need(feed.extent)

    def _check(self, n: int) -> bool:
        """CHECK_BIT_BUFFER: a fill where fewer than n bits are left;
        False where it would read past what PIL has read."""
        if self.bits >= n:
            return True
        data, extent, q = self.feed.data, self.feed.extent, self.q
        while self.bits < _MIN_GET_BITS:
            if q >= extent:
                return False
            c = data[q]
            q += 1
            if c == 0xFF:
                while c == 0xFF:
                    if q >= extent:
                        return False
                    c = data[q]
                    q += 1
                if c:                  # a marker: zeros from here
                    self.q, self.marker = q, True
                    return True
            self.bits += 8
        self.q = q
        return True

    def _slow(self, events: list) -> bool:
        """decode_mcu_slow's checks (HUFF_DECODE, jpeg_huff_decode)."""
        for ev in events:
            if ev > 0:
                if not self._check(8):
                    return False
                if ev > 8:
                    if not self._check(9):
                        return False
                    self.bits -= 9
                    for _ in range(ev - 9):
                        if not self._check(1):
                            return False
                        self.bits -= 1
                else:
                    self.bits -= ev
            else:
                if not self._check(-ev):
                    return False
                self.bits += ev
            if self.marker:
                return True
        return True

    def _fast(self, events: list) -> bool:
        """decode_mcu_fast's fills (FILL_BIT_BUFFER_FAST); False at a
        marker, where jdhuff.c takes the MCU again on the slow path."""
        data, n = self.feed.data, self.feed.n
        for ev in events:
            if self.bits <= 16:
                q = self.q
                for _ in range(6):
                    c0 = data[q]
                    q += 1
                    if c0 == 0xFF:
                        if q >= n or data[q]:
                            return False
                        q += 1
                self.q = q
                self.bits += 48
            self.bits -= abs(ev)
        return True


class _Arith:
    """libjpeg's arith_decode (``jdarith.c``) over one restart interval's
    bytes: the C register holds the interval's base and the input bits,
    zeros follow the data. A fetch past ``limit`` raises ``stop``
    (``_Feed.arith_limit``), where PIL's libjpeg raises."""

    def __init__(self, data: bytes, limit: int | None = None, stop=None):
        self.data, self.pos = data, 0
        self.limit = len(data) + 1 if limit is None else limit
        self.stop = stop
        self.c = self.a = 0
        self.ct = -16
        self.dead = False          # a magnitude or spectral overflow

    def decode(self, st: list, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                if self.limit <= self.pos <= len(self.data):
                    raise self.stop
                byte = (self.data[self.pos] if self.pos < len(self.data)
                        else 0)
                self.pos += 1
                self.c = (self.c << 8) | byte
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[i]
        qe, nl, nm = _QE[sv & 0x7F]
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _huff_dc_diff(bits: _Bits, dc: _Huffman) -> int:
    s = bits.decode(dc)
    return _extend(bits.bits(s), s) if s else 0


def _huff_block(bits: _Bits, dc: _Huffman, ac: _Huffman, pred: int,
                out: np.ndarray) -> int:
    pred += _huff_dc_diff(bits, dc)
    out[0] = _s16(pred)
    k = 1
    while k < 64:
        rs = bits.decode(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            out[_NATURAL[k]] = _extend(bits.bits(s), s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break
    return pred


def _huff_ac_first(bits, ac, out, ss, se, al, eobrun) -> int:
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.decode(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            out[_NATURAL[k]] = _s16(_extend(bits.bits(s), s) * (1 << al))
        elif r == 15:
            k += 15
        else:
            eobrun = 1 << r
            if r:
                eobrun += bits.bits(r)
            return eobrun - 1
        k += 1
    return 0


def _refine_bit(bits, out, pos, p1, m1) -> None:
    if bits.bit() and not out[pos] & p1:
        out[pos] += p1 if out[pos] >= 0 else m1


def _huff_ac_refine(bits, ac, out, ss, se, al, eobrun) -> int:
    """jdphuff.c's decode_mcu_AC_refine on one block."""
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = bits.decode(ac)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.bit() else m1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += bits.bits(r)
                break
            while k <= se:
                pos = _NATURAL[k]
                if out[pos]:
                    _refine_bit(bits, out, pos, p1, m1)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                out[_NATURAL[k]] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            pos = _NATURAL[k]
            if out[pos]:
                _refine_bit(bits, out, pos, p1, m1)
            k += 1
        eobrun -= 1
    return eobrun


class _ArithStats:
    """The statistics of one scan's restart interval: 64 DC and 256 AC
    bins a table, the fixed-probability bin, each component's DC
    prediction and conditioning context."""

    def __init__(self, ncomp: int):
        self.dc = [[0] * 64 for _ in range(16)]
        self.ac = [[0] * 256 for _ in range(16)]
        self.fixed = [113]
        self.last_dc = [0] * ncomp
        self.context = [0] * ncomp


def _arith_magnitude(dec: _Arith, st: list, m: int, i: int) -> tuple:
    """Figure F.23's chain of magnitude decisions from bin ``i``, ``m``
    doubling at each 1: (m, the bin that ended it); the caller's
    magnitude bits start 14 bins further."""
    while dec.decode(st, i):
        m <<= 1
        if m == 0x8000:
            dec.dead = True
            return 0, i
        i += 1
    return m, i


def _arith_dc_diff(dec: _Arith, stats: _ArithStats, e: int, tbl: int,
                   lo: int, hi: int) -> int:
    st = stats.dc[tbl]
    s0 = stats.context[e]
    if dec.decode(st, s0) == 0:
        stats.context[e] = 0
        return 0
    sign = dec.decode(st, s0 + 1)
    i = s0 + 2 + sign
    m = dec.decode(st, i)
    if m:
        m, i = _arith_magnitude(dec, st, 1, 20)
        if dec.dead:
            return 0
    if m < (1 << lo) >> 1:
        stats.context[e] = 0
    elif m > (1 << hi) >> 1:
        stats.context[e] = 12 + sign * 4
    else:
        stats.context[e] = 4 + sign * 4
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac_value(dec: _Arith, stats: _ArithStats, st: list, i: int,
                    k: int, kx: int) -> int:
    """The value of the AC coefficient at zigzag ``k`` whose bin row
    starts at ``i`` (its 'nonzero' decision taken)."""
    sign = dec.decode(stats.fixed, 0)
    i += 2
    m = dec.decode(st, i)
    if m and dec.decode(st, i):
        m, i = _arith_magnitude(dec, st, 2, 189 if k <= kx else 217)
        if dec.dead:
            return 0
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_block(dec, stats, e, scan, ci_tables, out) -> None:
    """jdarith.c's decode_mcu on one block (sequential)."""
    td, ta = ci_tables
    lo, hi, kx = scan.dac[0][td], scan.dac[1][td], scan.dac[2][ta]
    diff = _arith_dc_diff(dec, stats, e, td, lo, hi)
    if dec.dead:
        return
    stats.last_dc[e] = (stats.last_dc[e] + diff) & 0xFFFF
    out[0] = _s16(stats.last_dc[e])
    st = stats.ac[ta]
    k = 0
    while k < 63:
        i = 3 * k
        if dec.decode(st, i):
            return
        while True:
            k += 1
            if dec.decode(st, i + 1):
                break
            i += 3
            if k >= 63:
                dec.dead = True
                return
        v = _arith_ac_value(dec, stats, st, i, k, kx)
        if dec.dead:
            return
        out[_NATURAL[k]] = _s16(v)


def _arith_ac_first(dec, stats, scan, out) -> None:
    ta = scan.ta[0]
    st, kx = stats.ac[ta], scan.dac[2][ta]
    k = scan.ss
    while k <= scan.se:
        i = 3 * (k - 1)
        if dec.decode(st, i):
            return
        while dec.decode(st, i + 1) == 0:
            i += 3
            k += 1
            if k > scan.se:
                dec.dead = True
                return
        v = _arith_ac_value(dec, stats, st, i, k, kx)
        if dec.dead:
            return
        out[_NATURAL[k]] = _s16(v * (1 << scan.al))
        k += 1


def _arith_ac_refine(dec, stats, scan, out) -> None:
    st = stats.ac[scan.ta[0]]
    p1, m1 = 1 << scan.al, -1 << scan.al
    kex = scan.se
    while kex > 0 and not out[_NATURAL[kex]]:
        kex -= 1
    k = scan.ss
    while k <= scan.se:
        i = 3 * (k - 1)
        if k > kex and dec.decode(st, i):
            return
        while True:
            pos = _NATURAL[k]
            if out[pos]:
                if dec.decode(st, i + 2):
                    out[pos] += m1 if out[pos] < 0 else p1
                break
            if dec.decode(st, i + 1):
                out[pos] = m1 if dec.decode(stats.fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > scan.se:
                dec.dead = True
                return
        k += 1


def _huff_feed(st: _Stream, scan: _Scan, feed: _Feed, blocks: int):
    """The ``_HuffFeed`` of a sequential Huffman scan whose data runs to
    the stream's end (where PIL's verdict turns on the bytes libjpeg
    reads ahead), else ``None``: a marker ends the data of the others,
    and a stream read to its EOI before output (``multi_scan``) has
    one."""
    if st.arith or st.progressive or scan.markers[-1] is not None:
        return None
    return _HuffFeed(feed, blocks, fast=not (scan.restart or st.lossless))


def _units(st: _Stream, scan: _Scan) -> list:
    """The scan's MCUs in order, each a list of (scan entry, by, bx):
    an interleaved scan's MCU holds each component's h x v blocks (or
    samples, lossless); a single component's scan walks the
    component's own blocks, ceil(cols/8) x ceil(rows/8)."""
    b = 1 if st.lossless else 8
    if len(scan.comps) == 1:
        rows, cols = st.comp_size(st.comps[scan.comps[0]])
        return [[(0, by, bx)] for by in range(-(-rows // b))
                for bx in range(-(-cols // b))]
    my, mx = st.mcus()
    units = []
    for my_i in range(my):
        for mx_i in range(mx):
            unit = []
            for e, ci in enumerate(scan.comps):
                c = st.comps[ci]
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        unit.append((e, my_i * c["v"] + v,
                                     mx_i * c["h"] + h))
            units.append(unit)
    return units


def _intervals(scan: _Scan, units: list):
    """(decoder input, the interval's MCUs) per restart interval."""
    per = scan.restart or len(units)
    for s0 in range(0, len(units), per):
        seg = s0 // per
        if seg >= len(scan.segments) and scan.markers[-1] is None:
            # libjpeg reads the restart marker past the stream's end
            raise _truncated("before a restart marker")
        yield (scan.segments[seg] if seg < len(scan.segments) else b"",
               units[s0:s0 + per])


def _coefficients(st: _Stream) -> list[np.ndarray]:
    """Each component's quantized coefficients, (rows, cols, 64) blocks in
    natural order, decoded by the Python loop from every scan."""
    my, mx = st.mcus()
    coefs = [np.zeros((my * c["v"], mx * c["h"], 64), np.int64)
             for c in st.comps]
    coef_bits = [[-1] * 64 for _ in st.comps]
    feed = _Feed(st.data)
    for scan in st.scans:
        units = _units(st, scan)
        blocks = [coefs[ci] for ci in scan.comps]
        first = scan.ah == 0
        if st.progressive:
            for ci in scan.comps:
                for k in range(scan.ss, scan.se + 1):
                    coef_bits[ci][k] = scan.al
        hf = _huff_feed(st, scan, feed, len(units[0]))
        for seg, (data, mcus) in enumerate(_intervals(scan, units)):
            events = None
            if st.arith:
                dec = _Arith(data, *(feed.arith_limit(scan, seg)
                                     if seg < len(scan.segments) else ()))
                stats = _ArithStats(len(scan.comps))
            else:
                if hf is not None:
                    hf.segment(scan.starts[seg])
                    events = []
                dec, pred, eobrun = (_Bits(data, events),
                                     [0] * len(scan.comps), 0)
            for unit in mcus:
                if events is not None:
                    events.clear()
                for e, by, bx in unit:
                    out = blocks[e][by, bx]
                    if st.arith and dec.dead:
                        break
                    if not st.progressive:
                        if st.arith:
                            _arith_block(dec, stats, e, scan,
                                         (scan.td[e], scan.ta[e]), out)
                        else:
                            pred[e] = _huff_block(
                                dec, scan.huff[(0, scan.td[e])],
                                scan.huff[(1, scan.ta[e])], pred[e], out)
                    elif scan.ss == 0 and first:
                        if st.arith:
                            td = scan.td[e]
                            diff = _arith_dc_diff(dec, stats, e, td,
                                                  scan.dac[0][td],
                                                  scan.dac[1][td])
                            if dec.dead:
                                break
                            stats.last_dc[e] = (stats.last_dc[e]
                                                + diff) & 0xFFFF
                            out[0] = _s16(stats.last_dc[e] << scan.al)
                        else:
                            pred[e] += _huff_dc_diff(
                                dec, scan.huff[(0, scan.td[e])])
                            out[0] = _s16(pred[e] * (1 << scan.al))
                    elif scan.ss == 0:
                        bit = (dec.decode(stats.fixed, 0) if st.arith
                               else dec.bit())
                        if bit:
                            out[0] |= 1 << scan.al
                    elif st.arith:
                        (_arith_ac_first if first else _arith_ac_refine)(
                            dec, stats, scan, out)
                    else:
                        eobrun = (_huff_ac_first if first
                                  else _huff_ac_refine)(
                            dec, scan.huff[(1, scan.ta[0])], out, scan.ss,
                            scan.se, scan.al, eobrun)
                if events is not None:
                    hf.mcu(events)
    if st.progressive and _smoothing_ok(st, coef_bits):
        coefs = [_smoothed(st, c, co, bits)
                 for c, co, bits in zip(st.comps, coefs, coef_bits)]
    return coefs


def _smoothing_ok(st: _Stream, coef_bits) -> bool:
    """libjpeg-turbo's smoothing_ok at the output pass: every component
    has its DC and the quantizers of its first ten coefficients, and the
    scans leave one of the first nine AC coefficients of some component
    incomplete (``coef_bits`` per zigzag index: the Al of its last scan,
    −1 if none sent it)."""
    for c, bits in zip(st.comps, coef_bits):
        q = st.qt.get(c["tq"])
        if (q is None or bits[0] < 0
                or any(q[_NATURAL[k]] == 0
                       for k in range(_SMOOTHED_COEFS + 1))):
            return False
    return any(bits[k] != 0 for bits in coef_bits
               for k in range(1, _SMOOTHED_COEFS + 1))


def _smoothed(st: _Stream, c: dict, co: np.ndarray, bits) -> np.ndarray:
    """jdcoefct.c's decompress_smooth_data on one component's (rows,
    cols, 64) coefficients: in each block of the image, a first AC
    coefficient still zero and not known to be exact (its ``bits`` not 0)
    is estimated from the 5x5 DC values around the block (``_SMOOTH_K``),
    rounded and held under 2^Al; with no AC data at all the DC is
    replaced by their weighted mean too. Rows and columns past the edge
    repeat the last, as libjpeg's block-row pointers do: on the last iMCU
    row counted in its own block rows, so a dummy row of the padded grid
    can stand below a row above it."""
    t = st.mcus()[0]
    v = c["v"]
    rows, cols = st.comp_size(c)
    hib, wib = -(-rows // 8), -(-cols // 8)
    r = np.arange(hib)
    block_rows = np.where(r // v < t - 1, v, hib - (t - 1) * v)
    ibr = r // v * block_rows + r % v
    n = block_rows * t
    prev = np.where(ibr > 0, r - 1, r)
    nxt = np.where(ibr < n - 1, r + 1, r)
    ri = np.stack([np.where(ibr > 1, r - 2, prev), prev, r, nxt,
                   np.where(ibr < n - 2, r + 2, nxt)], axis=1)
    ci = np.clip(np.arange(wib)[:, None] + np.arange(-2, 3), 0, wib - 1)
    dc = co[..., 0][ri[:, None, :, None], ci[None, :, None, :]]
    change_dc = all(bits[k] == -1 for k in range(1, _SMOOTHED_COEFS + 1))
    q = st.qt[c["tq"]].astype(np.int64)
    out = co.copy()
    blk = out[:hib, :wib]
    for k in range(0 if change_dc else 1, 10 if change_dc else 6):
        if k and bits[k] == 0:
            continue
        num = q[0] * np.einsum("hwij,ij->hw", dc, _SMOOTH_K[int(change_dc),
                                                            k])
        qk = int(q[_NATURAL[k]])
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if k and bits[k] > 0:
            pred = np.minimum(pred, (1 << bits[k]) - 1)
        pred = np.where(num >= 0, pred, -pred)
        at = blk[..., _NATURAL[k]]
        blk[..., _NATURAL[k]] = np.where((at == 0) | (k == 0), pred, at)
    return out


def _lossless_samples(st: _Stream) -> list[np.ndarray]:
    """Each component's (rows, cols) samples of a lossless stream:
    jdlhuff.c's differences, undifferenced as jdlossls.c does (the first
    row of a scan or restart interval from its left neighbour and the
    first sample from 2^(7 - Pt); the next rows' first column from
    above, the rest by the scan's predictor), scaled by the point
    transform."""
    my, mx = st.mcus()
    out = [None] * len(st.comps)
    feed = _Feed(st.data)
    for scan in st.scans:
        diffs = [np.zeros((my * st.comps[ci]["v"], mx * st.comps[ci]["h"]),
                          np.int64) for ci in scan.comps]
        units = _units(st, scan)
        per_row = (mx if len(scan.comps) > 1 else
                   st.comp_size(st.comps[scan.comps[0]])[1])
        if scan.restart % per_row:
            raise ValueError("lossless JPEG restart interval is not a "
                             "whole number of MCU rows")
        reset_rows = set()
        mcu_rows = 0
        hf = _huff_feed(st, scan, feed, len(units[0]))
        for seg, (data, mcus) in enumerate(_intervals(scan, units)):
            reset_rows.add(mcu_rows)
            mcu_rows += len(mcus) // per_row
            events = None
            if hf is not None:
                hf.segment(scan.starts[seg])
                events = []
            bits = _Bits(data, events)
            for unit in mcus:
                if events is not None:
                    events.clear()
                for e, y, x in unit:
                    s = bits.decode(scan.huff[(0, scan.td[e])])
                    diffs[e][y, x] = (32768 if s == 16 else
                                      _extend(bits.bits(s), s) if s else 0)
                if events is not None:
                    hf.mcu(events)
        for e, ci in enumerate(scan.comps):
            c = st.comps[ci]
            rows, cols = st.comp_size(c)
            v = c["v"] if len(scan.comps) > 1 else 1
            d = diffs[e]
            x = np.zeros((rows, cols), np.int64)
            for y in range(rows):
                if y // v in reset_rows and y % v == 0:
                    prev = None
                row = x[y]
                for i in range(cols):
                    if prev is None:
                        p = (1 << (7 - scan.al)) if i == 0 else int(row[i - 1])
                    elif i == 0:
                        p = int(prev[0])
                    else:
                        ra, rb, rc = int(row[i - 1]), int(prev[i]), int(
                            prev[i - 1])
                        p = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                             rb + ((ra - rc) >> 1), (ra + rb) >> 1)[
                                 scan.ss - 1]
                    row[i] = (int(d[y, i]) + p) & 0xFFFF
                prev = row
            out[ci] = (x << scan.al) & 0xFF
    if any(o is None for o in out):
        raise ValueError("JPEG stream leaves a component without a scan")
    return out


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


def upsample(p: np.ndarray, rh: int, rv: int, height: int, width: int,
             fancy: bool = True) -> np.ndarray:
    """A component's (rows, cols) samples upsampled by (rh, rv) as
    libjpeg-turbo's jdsample.c picks the method: with ``fancy`` (DCT
    streams), h2v1_fancy_upsample (2, 1) and h2v2_fancy_upsample (2, 2)
    where the component is more than 2 samples wide, h1v2_fancy_upsample
    (1, 2); else box replication (h2v1/h2v2_upsample, int_upsample).
    Cropped to (height, width)."""
    p = p.astype(np.int64)
    cols = p.shape[1]
    if (rh, rv) == (1, 1):
        return p[:height, :width]
    if fancy and (rh, rv) == (2, 1) and cols > 2:
        return _fancy_h2(p, width, 1, 2, 2)[:height]
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    if fancy and (rh, rv) == (1, 2):
        out = np.empty((2 * p.shape[0], cols), np.int64)
        out[0::2] = (3 * p + above + 1) >> 2
        out[1::2] = (3 * p + below + 2) >> 2
        return out[:height, :width]
    if fancy and (rh, rv) == (2, 2) and cols > 2:
        out = np.empty((2 * p.shape[0], width), np.int64)
        out[0::2] = _fancy_h2(3 * p + above, width, 8, 7, 4)
        out[1::2] = _fancy_h2(3 * p + below, width, 8, 7, 4)
        return out[:height]
    return np.repeat(np.repeat(p, rv, axis=0), rh, axis=1)[:height, :width]


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


def cmyk_to_rgb(inverted: np.ndarray, k: np.ndarray) -> np.ndarray:
    """PIL's ``cmyk2rgb`` on what its "CMYK;I" rawmode makes of
    libjpeg's CMYK output: ``inverted`` (..., 3) is 255 − C, M, Y and
    ``k`` (...) is libjpeg's K, which the inversion makes PIL's 255 − K.
    Each channel is K − K·(255 − C)/255, rounded as PIL's MULDIV255."""
    nk = k.astype(np.int64)[..., None]
    t = inverted.astype(np.int64) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_plain(data: bytes) -> np.ndarray:
    """The plain version of ``decode``: (H, W, 1) grey or (H, W, 3) RGB
    uint8, decoded in Python and numpy."""
    st = _Stream(bytes(data))
    if st.multi_scan and not st.eoi:
        raise _truncated("before its EOI marker")
    space = st.color_space()
    if st.lossless and space not in ("grey", "rgb", "cmyk"):
        raise _unsupported("lossless YCCK" if space == "ycck"
                           else "lossless YCbCr")
    for c in st.comps:
        if not st.lossless and c["tq"] not in st.qt:
            raise ValueError(f"JPEG stream lacks quantization table "
                             f"{c['tq']}")
    if st.lossless:
        samples = _lossless_samples(st)
    else:
        samples = []
        for c, co in zip(st.comps, _coefficients(st)):
            rows, cols = st.comp_size(c)
            samples.append(_plane(idct_islow(co, st.qt[c["tq"]]))[
                :rows, :cols])
    planes = [upsample(p, st.hmax // c["h"], st.vmax // c["v"], st.height,
                       st.width, fancy=not st.lossless)
              for c, p in zip(st.comps, samples)]
    if space == "grey":
        return planes[0].astype(np.uint8)[..., None]
    if space == "rgb":
        return np.stack(planes, axis=-1).astype(np.uint8)
    if space == "ycc":
        return ycc_to_rgb(*planes)
    if space == "cmyk":
        inverted = 255 - np.stack(planes[:3], axis=-1)
    else:
        inverted = ycc_to_rgb(*planes[:3])
    return cmyk_to_rgb(inverted, planes[3])



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
    """(H, W, 1) grey or (H, W, 3) RGB uint8 samples of a JPEG stream
    of any kind the module decodes, decoded by ``csrc/jpeg_decode.cpp``."""
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
