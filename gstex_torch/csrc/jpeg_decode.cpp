// Baseline JPEG decoding on the host, to the bytes of libjpeg-turbo's
// default decompression (what PIL's Image.open(...).convert("RGB") and
// cv2.imread return): Huffman entropy decoding of baseline and
// extended-sequential 8-bit streams (interleaved or one component a scan,
// restart markers), the integer "islow" inverse DCT of jidctint.c,
// "fancy" triangular chroma upsampling (h2v1 / h2v2, edges replicated at
// the component's own size) and jdcolor.c's fixed-point YCbCr->RGB.
// Grey streams give one channel; 4:4:4, 4:2:2 and 4:2:0 colour give RGB.
// Progressive, lossless, arithmetic-coded, 12-bit and CMYK streams are
// refused with a message. The same decoder in Python and numpy is
// gstex_torch/data/jpeg.py:decode_plain.
//
// Plain C interface, called through ctypes (which releases the GIL):
//   gstex_jpeg_info(data, n, hwc[3], err, errlen)   -> 0 or -1
//   gstex_jpeg_decode(data, n, out, err, errlen)    -> 0 or -1
// out is (H, W, C) uint8, C = hwc[2].

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* kUnsupported = "ROADMAP Queue 1 item 10";

// zigzag position -> natural index; 16 extra entries keep a corrupt run
// inside the block, as libjpeg's jpeg_natural_order does
const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

struct Huffman {
  bool present = false;
  int mincode[17] = {0};
  int maxcode[18] = {0};
  int valptr[17] = {0};
  uint8_t values[256] = {0};
  // lookahead: for each 8-bit prefix, (length << 8 | value), 0 if longer
  uint16_t look[256] = {0};

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    present = true;
    std::memcpy(values, vals, std::min(nvals, 256));
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; ++len) {
      int n = bits[len - 1];
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < n; ++i) {
        if (len <= 8) {
          int shift = 8 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            look[((code + i) << shift) | j] =
                static_cast<uint16_t>((len << 8) | values[(k + i) & 255]);
          }
        }
      }
      code += n;
      k += n;
      maxcode[len] = n ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 1 << 30;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int rows = 0, cols = 0;    // downsampled_height / downsampled_width
  int brows = 0, bcols = 0;  // blocks allocated (the MCU grid)
  std::vector<int16_t> coef;  // brows * bcols * 64, natural order
};

// Bit reader over one restart interval's entropy-coded bytes, in place:
// 0xFF00 is a 0xFF data byte, a marker ends the data (zeros follow).
struct Bits {
  const uint8_t* d;
  long n, pos;
  uint64_t acc = 0;
  int nacc = 0;
  bool hit_marker = false;

  void fill() {
    while (nacc <= 56) {
      unsigned byte = 0;
      if (!hit_marker && pos < n) {
        byte = d[pos];
        if (byte == 0xFF) {
          long p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;  // fill bytes
          if (p < n && d[p] == 0x00) {
            pos = p + 1;
          } else {
            hit_marker = true;
            pos = p - 1;   // at the marker's 0xFF
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nacc);
      nacc += 8;
    }
  }
  int get(int s) {
    if (s == 0) return 0;
    if (nacc < s) fill();
    int v = static_cast<int>(acc >> (64 - s));
    acc <<= s;
    nacc -= s;
    return v;
  }
  int decode(const Huffman& h) {
    if (nacc < 16) fill();
    int look = h.look[acc >> 56];
    if (look) {
      int len = look >> 8;
      acc <<= len;
      nacc -= len;
      return look & 255;
    }
    int code = get(1);
    int len = 1;
    while (len <= 16 && code > h.maxcode[len]) {
      code = (code << 1) | get(1);
      ++len;
    }
    if (len > 16) return 0;  // corrupt data: libjpeg returns 0
    return h.values[(h.valptr[len] + code - h.mincode[len]) & 255];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Scan {
  std::vector<int> comps;
  std::vector<int> dc, ac;
};

struct Decoder {
  const uint8_t* d;
  long n;
  int height = 0, width = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool jfif = false;
  int adobe = -1;
  bool have_frame = false;
  std::vector<Component> comps;
  int qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman huff[2][4];
  int mcu_rows = 0, mcu_cols = 0;

  Decoder(const uint8_t* data, long len) : d(data), n(len) {}

  [[noreturn]] static void fail(const std::string& m) { throw Error{m}; }
  [[noreturn]] static void unsupported(const std::string& what) {
    fail(what + " JPEG streams are not decoded by the port (baseline "
         "Huffman 8-bit only): " + kUnsupported);
  }

  int u16(long p) const {
    if (p + 1 >= n) fail("JPEG stream truncated");
    return (d[p] << 8) | d[p + 1];
  }

  void frame(long p, int len) {
    if (len < 6) fail("JPEG frame header truncated");
    int precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    if (precision != 8) unsupported(std::to_string(precision) + "-bit");
    if (nc == 4) unsupported("CMYK/YCCK (4-component)");
    if (nc != 1 && nc != 3) unsupported(std::to_string(nc) + "-component");
    if (height == 0 || width == 0)
      fail("JPEG frame with a zero size (DNL) is not supported");
    if (len < 6 + 3 * nc) fail("JPEG frame header truncated");
    comps.clear();
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i] & 3;
      if (c.h < 1 || c.v < 1) fail("JPEG component with zero sampling");
      comps.push_back(c);
    }
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps) {
      int rh = hmax / c.h, rv = vmax / c.v;
      bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                 (rh == 2 && rv == 2));
      if (!ok)
        unsupported("chroma sampling " + std::to_string(c.h) + "x" +
                    std::to_string(c.v) + " of " + std::to_string(hmax) +
                    "x" + std::to_string(vmax));
    }
    mcu_rows = (height + 8 * vmax - 1) / (8 * vmax);
    mcu_cols = (width + 8 * hmax - 1) / (8 * hmax);
    for (auto& c : comps) {
      c.rows = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) /
                                vmax);
      c.cols = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) /
                                hmax);
      c.brows = mcu_rows * c.v;
      c.bcols = mcu_cols * c.h;
    }
    have_frame = true;
  }

  void huffman(long p, int len) {
    long end = p + len;
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("JPEG Huffman table id out of range");
      if (p + 17 > end) fail("JPEG Huffman table truncated");
      int total = 0;
      for (int i = 0; i < 16; ++i) total += d[p + 1 + i];
      if (total > 256 || p + 17 + total > end)
        fail("JPEG Huffman table truncated");
      huff[tc][th].build(d + p + 1, d + p + 17, total);
      p += 17 + total;
    }
  }

  void quant(long p, int len) {
    long end = p + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3) fail("JPEG quantization table id out of range");
      int size = pq ? 128 : 64;
      if (p + 1 + size > end) fail("JPEG quantization table truncated");
      for (int i = 0; i < 64; ++i)
        qt[tq][kZigzag[i]] = pq ? u16(p + 1 + 2 * i) : d[p + 1 + i];
      qt_present[tq] = true;
      p += 1 + size;
    }
  }

  // Decode one scan from its entropy-coded data at `p`; returns the
  // position of the marker that ends it.
  long scan(long p, int len) {
    if (!have_frame) fail("JPEG scan before the frame header");
    int ns = d[p];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) fail("JPEG scan header bad");
    Scan s;
    for (int i = 0; i < ns; ++i) {
      int cid = d[p + 1 + 2 * i], t = d[p + 2 + 2 * i];
      int ci = -1;
      for (size_t k = 0; k < comps.size(); ++k)
        if (comps[k].id == cid) ci = static_cast<int>(k);
      if (ci < 0) fail("JPEG scan names an unknown component");
      if ((t >> 4) > 3 || (t & 15) > 3) fail("JPEG scan table id bad");
      if (!huff[0][t >> 4].present || !huff[1][t & 15].present)
        fail("JPEG scan uses an undefined Huffman table");
      s.comps.push_back(ci);
      s.dc.push_back(t >> 4);
      s.ac.push_back(t & 15);
    }
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns],
        ahal = d[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0)
      unsupported("progressive (spectral selection)");
    for (auto& c : comps)
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.brows) * c.bcols * 64, 0);

    long pos = p + len;
    // units of the scan: MCUs (interleaved) or single blocks
    long units_y, units_x;
    if (ns == 1) {
      const Component& c = comps[s.comps[0]];
      units_y = (c.rows + 7) / 8;
      units_x = (c.cols + 7) / 8;
    } else {
      units_y = mcu_rows;
      units_x = mcu_cols;
    }
    long total = units_y * units_x;
    long per = restart ? restart : total;
    int pred[4] = {0, 0, 0, 0};
    Bits bits{d, n, pos};
    for (long u = 0; u < total; ++u) {
      if (u > 0 && u % per == 0) {
        // to the restart marker: skip what is left of the interval
        long q = bits.pos;
        while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] >= 0xD0 &&
                              d[q + 1] <= 0xD7)) {
          if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF &&
              !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7))
            break;   // another marker: the data ends early
          ++q;
        }
        if (q + 1 < n && d[q] == 0xFF && d[q + 1] >= 0xD0 &&
            d[q + 1] <= 0xD7)
          q += 2;
        bits = Bits{d, n, q};
        std::fill(pred, pred + 4, 0);
      }
      long uy = u / units_x, ux = u % units_x;
      for (int e = 0; e < ns; ++e) {
        Component& c = comps[s.comps[e]];
        const Huffman& dc = huff[0][s.dc[e]];
        const Huffman& ac = huff[1][s.ac[e]];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int v = 0; v < bh; ++v)
          for (int h = 0; h < bw; ++h) {
            long by = uy * bh + v, bx = ux * bw + h;
            int16_t* out = &c.coef[(by * c.bcols + bx) * 64];
            int t = bits.decode(dc);
            int diff = t ? extend(bits.get(t), t) : 0;
            pred[s.comps[e]] += diff;
            out[0] = static_cast<int16_t>(pred[s.comps[e]]);
            for (int k = 1; k < 64;) {
              int rs = bits.decode(ac);
              int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                out[kZigzag[k]] = static_cast<int16_t>(
                    extend(bits.get(sz), sz));
                ++k;
              } else if (r == 15) {
                k += 16;
              } else {
                break;
              }
            }
          }
      }
    }
    // the scan ends at the next marker other than RSTn
    long q = bits.pos;
    while (q + 1 < n) {
      if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF &&
          !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7))
        return q;
      ++q;
    }
    return n;
  }

  void parse(bool decode_scans) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF)
      fail("not a JPEG stream (no SOI marker)");
    long p = 2;
    bool any_scan = false;
    while (p < n) {
      if (d[p] != 0xFF) fail("JPEG stream: no marker where one is due");
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) break;
      int marker = d[p++];
      if (marker == 0xD9) break;
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      int len = u16(p);
      if (len < 2 || p + len > n) fail("JPEG marker segment truncated");
      long body = p + 2;
      int blen = len - 2;
      p += len;
      switch (marker) {
        case 0xC0: case 0xC1: frame(body, blen); break;
        case 0xC2: unsupported("progressive");
        case 0xC3: unsupported("lossless");
        case 0xC5: case 0xC6: case 0xC7: unsupported("differential");
        case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE:
        case 0xCF: unsupported("arithmetic-coded");
        case 0xC4: huffman(body, blen); break;
        case 0xDB: quant(body, blen); break;
        case 0xDD: if (blen >= 2) restart = u16(body); break;
        case 0xE0:
          if (blen >= 5 && std::memcmp(d + body, "JFIF\0", 5) == 0)
            jfif = true;
          break;
        case 0xEE:
          if (blen >= 12 && std::memcmp(d + body, "Adobe", 5) == 0)
            adobe = d[body + 11];
          break;
        case 0xDA:
          if (!decode_scans) {
            if (!have_frame) fail("JPEG scan before the frame header");
            return;
          }
          any_scan = true;
          p = scan(body, blen);
          break;
        default: break;
      }
    }
    if (!have_frame) fail("JPEG stream has no frame header");
    if (decode_scans && !any_scan) fail("JPEG stream has no scan");
  }

  int channels() const { return comps.size() == 1 ? 1 : 3; }

  bool rgb_space() const {
    if (comps.size() == 1 || jfif) return false;
    if (adobe >= 0) return adobe == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }
};

// ---------------------------------------------------------------------------
// jidctint.c's islow IDCT in 32-bit arithmetic, as libjpeg-turbo's SIMD
// versions compute it (equal to the C version's 64-bit sums on every
// stream whose dequantized coefficients fit 16 bits); the result
// saturates as the SIMD versions' packs do. Eight columns (pass 1) or
// eight rows (pass 2) go through each statement together.
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// x[k][lane] -> out[k][lane], descaled by `shift` bits
inline void idct_lanes(const int32_t (&x)[8][8], int32_t (&out)[8][8],
                       int shift) {
  const int32_t round = 1 << (shift - 1);
  for (int l = 0; l < 8; ++l) {
    int32_t z2 = x[2][l], z3 = x[6][l];
    int32_t z1 = (z2 + z3) * F0541;
    int32_t tmp2 = z1 - z3 * F1847;
    int32_t tmp3 = z1 + z2 * F0765;
    int32_t tmp0 = (x[0][l] + x[4][l]) * (1 << kConstBits);
    int32_t tmp1 = (x[0][l] - x[4][l]) * (1 << kConstBits);
    int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
            t12 = tmp1 - tmp2;
    tmp0 = x[7][l];
    tmp1 = x[5][l];
    tmp2 = x[3][l];
    tmp3 = x[1][l];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    out[0][l] = (t10 + tmp3 + round) >> shift;
    out[7][l] = (t10 - tmp3 + round) >> shift;
    out[1][l] = (t11 + tmp2 + round) >> shift;
    out[6][l] = (t11 - tmp2 + round) >> shift;
    out[2][l] = (t12 + tmp1 + round) >> shift;
    out[5][l] = (t12 - tmp1 + round) >> shift;
    out[3][l] = (t13 + tmp0 + round) >> shift;
    out[4][l] = (t13 - tmp0 + round) >> shift;
  }
}

inline uint8_t clamp8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One block of coefficients (natural order) -> 8x8 samples at `dst`.
void idct_block(const int16_t* coef, const int* q, uint8_t* dst,
                long stride) {
  int32_t x[8][8], w[8][8], t[8][8], y[8][8];
  for (int i = 0; i < 64; ++i) x[i >> 3][i & 7] = int32_t(coef[i]) * q[i];
  idct_lanes(x, w, kConstBits - kPass1Bits);     // w[row][col]
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) t[c][r] = w[r][c];
  idct_lanes(t, y, kConstBits + kPass1Bits + 3);  // y[col][row]
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) dst[r * stride + c] = clamp8(y[c][r] + 128);
}

// ---------------------------------------------------------------------------
// fancy upsampling (jdsample.c), one output row at a time
// ---------------------------------------------------------------------------

// the horizontal triangle filter on (column sums) s[0..cols): output 2c is
// (3 s[c] + s[c-1] + bl) >> shift, 2c+1 is (3 s[c] + s[c+1] + br) >> shift,
// edges replicated; `out` holds 2 * cols values
inline void fancy_row(const int* s, int cols, int bl, int br, int shift,
                      uint8_t* out) {
  if (cols == 1) {
    out[0] = static_cast<uint8_t>((4 * s[0] + bl) >> shift);
    out[1] = static_cast<uint8_t>((4 * s[0] + br) >> shift);
    return;
  }
  out[0] = static_cast<uint8_t>((4 * s[0] + bl) >> shift);
  out[1] = static_cast<uint8_t>((3 * s[0] + s[1] + br) >> shift);
  for (int c = 1; c < cols - 1; ++c) {
    int m = 3 * s[c];
    out[2 * c] = static_cast<uint8_t>((m + s[c - 1] + bl) >> shift);
    out[2 * c + 1] = static_cast<uint8_t>((m + s[c + 1] + br) >> shift);
  }
  int c = cols - 1;
  out[2 * c] = static_cast<uint8_t>((3 * s[c] + s[c - 1] + bl) >> shift);
  out[2 * c + 1] = static_cast<uint8_t>((4 * s[c] + br) >> shift);
}

struct Plane {
  std::vector<uint8_t> samples;   // the IDCT output, block-padded
  long stride;
  int rows, cols, rh, rv;
  std::vector<int> sums;
  std::vector<uint8_t> row;       // one upsampled row (2 * cols)

  // row y of the full-size (upsampled) component
  const uint8_t* get(int y) {
    if (rh == 1 && rv == 1) return &samples[y * stride];
    if (rv == 1) {
      const uint8_t* p = &samples[y * stride];
      for (int c = 0; c < cols; ++c) sums[c] = p[c];
      fancy_row(sums.data(), cols, 1, 2, 2, row.data());
      return row.data();
    }
    int i = y >> 1;
    int far = (y & 1) ? std::min(i + 1, rows - 1) : std::max(i - 1, 0);
    const uint8_t* p = &samples[i * stride];
    const uint8_t* q = &samples[far * stride];
    for (int c = 0; c < cols; ++c) sums[c] = 3 * p[c] + q[c];
    fancy_row(sums.data(), cols, 8, 7, 4, row.data());
    return row.data();
  }
};

inline int fix16(double x) { return static_cast<int>(x * 65536 + 0.5); }

void decode_all(Decoder& dec, uint8_t* out) {
  const int H = dec.height, W = dec.width;
  std::vector<Plane> planes;
  for (auto& c : dec.comps) {
    if (!dec.qt_present[c.tq])
      Decoder::fail("JPEG stream lacks a quantization table it uses");
    if (c.coef.empty())
      c.coef.assign(static_cast<size_t>(c.brows) * c.bcols * 64, 0);
    Plane pl;
    pl.stride = long(c.bcols) * 8;
    pl.samples.resize(static_cast<size_t>(c.brows) * 8 * pl.stride);
    for (int by = 0; by < c.brows; ++by)
      for (int bx = 0; bx < c.bcols; ++bx)
        idct_block(&c.coef[(long(by) * c.bcols + bx) * 64], dec.qt[c.tq],
                   &pl.samples[long(by) * 8 * pl.stride + bx * 8], pl.stride);
    pl.rows = c.rows;
    pl.cols = c.cols;
    pl.rh = dec.hmax / c.h;
    pl.rv = dec.vmax / c.v;
    pl.sums.resize(c.cols);
    pl.row.resize(2 * static_cast<size_t>(c.cols) + 2);
    planes.push_back(std::move(pl));
  }
  if (planes.size() == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + long(y) * W, planes[0].get(y), W);
    return;
  }
  const bool rgb = dec.rgb_space();
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int x = i - 128;
    cr_r[i] = (fix16(1.40200) * x + 32768) >> 16;
    cb_b[i] = (fix16(1.77200) * x + 32768) >> 16;
    cr_g[i] = -fix16(0.71414) * x;
    cb_g[i] = -fix16(0.34414) * x + 32768;
  }
  for (int y = 0; y < H; ++y) {
    const uint8_t* Y = planes[0].get(y);
    const uint8_t* Cb = planes[1].get(y);
    const uint8_t* Cr = planes[2].get(y);
    uint8_t* o = out + long(y) * W * 3;
    if (rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = Y[x];
        o[3 * x + 1] = Cb[x];
        o[3 * x + 2] = Cr[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int l = Y[x], cb = Cb[x], cr = Cr[x];
      o[3 * x] = clamp8(l + cr_r[cr]);
      o[3 * x + 1] = clamp8(l + ((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp8(l + cb_b[cb]);
    }
  }
}

void set_error(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", m.c_str());
}

}  // namespace

extern "C" int gstex_jpeg_info(const unsigned char* data, long n, int* hwc,
                               char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse(false);
    hwc[0] = dec.height;
    hwc[1] = dec.width;
    hwc[2] = dec.channels();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

extern "C" int gstex_jpeg_decode(const unsigned char* data, long n,
                                 unsigned char* out, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse(true);
    decode_all(dec, out);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}
