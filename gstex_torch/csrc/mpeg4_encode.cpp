// One intra-coded MPEG-4 Part 2 (ISO/IEC 14496-2, Simple Profile) VOP
// on the host: RGB -> Y'CbCr 4:2:0 (BT.601 limited range in 16.16 fixed
// point, each chroma sample the rounded mean of its 2x2 pixels), edge
// padding to whole macroblocks, jfdctint.c's integer forward DCT, the
// intra DC scaler and DC prediction, the H.263 quantisation method at
// vop_quant 2 (each AC level the one whose reconstruction is nearest),
// the zigzag scan, the intra TCOEF VLCs (Table B-16) and escape mode 3;
// optionally the reconstruction a decoder makes (the simple IDCT of
// ffmpeg's). The same encoder in numpy is
// gstex_torch/data/video.py:encode_vop_plain; the two give the same bytes.
//
// Plain C interface, called through ctypes (which releases the GIL):
//   gstex_mp4v_vop(rgb, h, w, index, fps, out, cap, recon)
//     -> bytes written, or -1 when they would pass `cap`
// rgb is (h, w, 3) uint8 with h and w even; recon, when not null, gets
// the Y (h, w), Cb and Cr (h/2, w/2) planes one after the other.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Table B-16: (code, length) of (last, run, level) in the order of
// kRun / kLevel; entries from kLast1 code last = 1
const uint16_t kTcoef[102][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},
    {0x13, 6},  {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},
    {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
    {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},   {0x14, 6},  {0x16, 7},
    {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},
    {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
    {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},
    {0x18, 8},  {0x23, 11}, {0x17, 8},  {0x19, 9},  {0x18, 9},  {0x7, 10},
    {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
    {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},
    {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
    {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}};
const uint8_t kRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  1,
    1,  1,  1,  2,  2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  4,  5,  5,
    5,  6,  6,  6,  7,  7,  7,  8,  8,  9,  9,  10, 11, 12, 13, 14, 0,
    0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  2,  2,  3,  3,  4,  4,  5,
    5,  6,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const uint8_t kLevel[102] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 1,  2,  3,  4,  5,  6,  7,
    8,  9,  10, 1,  2,  3,  4,  5,  1,  2,  3,  4,  1,  2,  3,  1,  2,
    3,  1,  2,  3,  1,  2,  3,  1,  2,  1,  2,  1,  1,  1,  1,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  1,  2,  3,  1,  2,  1,  2,  1,  2,  1,
    2,  1,  2,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1};
constexpr int kLast1 = 67, kMaxLevel = 27;
// dct_dc_size (Tables B-13, B-14), mcbpc (B-6), cbpy (B-8)
const uint8_t kDcLuma[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                                {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                                {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChroma[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                                  {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                                  {1, 10}, {1, 11}, {1, 12}};
const uint8_t kMcbpc[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                              {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4},
                              {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};

// (last, run, level) -> (code << 8 | length), 0 where escape mode 3 codes it
struct Vlc {
  uint32_t t[2][64][kMaxLevel + 1];
  Vlc() {
    std::memset(t, 0, sizeof(t));
    for (int i = 0; i < 102; ++i)
      t[i >= kLast1][kRun[i]][kLevel[i]] = kTcoef[i][0] << 8 | kTcoef[i][1];
  }
};
const Vlc kVlc;

struct BitWriter {
  uint8_t* out;
  long cap, n = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool overflow = false;

  void put(uint64_t v, int len) {
    if (len == 0) return;
    acc = (acc << len) | (v & ((uint64_t(1) << len) - 1));
    nacc += len;
    while (nacc >= 8) {
      nacc -= 8;
      if (n < cap)
        out[n] = static_cast<uint8_t>(acc >> nacc);
      else
        overflow = true;
      ++n;
    }
  }
};

int time_bits(int fps) {
  int b = 0;
  for (int v = fps - 1; v > 0; v >>= 1) ++b;
  return std::max(b, 1);
}

// every VOP's vop_quant, and the intra DC scaler Table 7-1 gives it
constexpr int kQscale = 2, kDcScaler = 8;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// jfdctint.c's 1-D pass on x[0..7] (stride `s`), in place
void fdct_1d(int64_t* x, int s, bool pass2) {
  int64_t tmp0 = x[0] + x[7 * s], tmp7 = x[0] - x[7 * s];
  int64_t tmp1 = x[s] + x[6 * s], tmp6 = x[s] - x[6 * s];
  int64_t tmp2 = x[2 * s] + x[5 * s], tmp5 = x[2 * s] - x[5 * s];
  int64_t tmp3 = x[3 * s] + x[4 * s], tmp4 = x[3 * s] - x[4 * s];
  int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
          t12 = tmp1 - tmp2;
  int shift;
  if (pass2) {
    x[0] = descale(t10 + t11, kPass1Bits);
    x[4 * s] = descale(t10 - t11, kPass1Bits);
    shift = kConstBits + kPass1Bits;
  } else {
    x[0] = (t10 + t11) * (1 << kPass1Bits);
    x[4 * s] = (t10 - t11) * (1 << kPass1Bits);
    shift = kConstBits - kPass1Bits;
  }
  int64_t z1 = (t12 + t13) * F0541;
  x[2 * s] = descale(z1 + t13 * F0765, shift);
  x[6 * s] = descale(z1 - t12 * F1847, shift);
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  int64_t z5 = (z3 + z4) * F1175;
  tmp4 *= F0298;
  tmp5 *= F2053;
  tmp6 *= F3072;
  tmp7 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  x[7 * s] = descale(tmp4 + z1 + z3, shift);
  x[5 * s] = descale(tmp5 + z2 + z4, shift);
  x[3 * s] = descale(tmp6 + z2 + z3, shift);
  x[s] = descale(tmp7 + z1 + z4, shift);
}

// the "simple" inverse DCT of ffmpeg's decoder (simple_idct_template.c,
// 8-bit): cos(k pi/16) sqrt(2) 2^14, W4 one short; one 1-D pass on x[0..7]
// (stride `s`) with `bias` added, descaled by `shift`
const int64_t kW[8] = {16383, 22725, 21407, 19266, 16383, 12873, 8867, 4520};

void simple_idct_1d(int64_t* x, int s, int shift, int64_t bias) {
  const int64_t* w = kW;
  int64_t x0 = x[0], x1 = x[s], x2 = x[2 * s], x3 = x[3 * s], x4 = x[4 * s],
          x5 = x[5 * s], x6 = x[6 * s], x7 = x[7 * s];
  int64_t a = w[4] * x0 + bias;
  int64_t a0 = a + w[2] * x2 + w[4] * x4 + w[6] * x6;
  int64_t a1 = a + w[6] * x2 - w[4] * x4 - w[2] * x6;
  int64_t a2 = a - w[6] * x2 - w[4] * x4 + w[2] * x6;
  int64_t a3 = a - w[2] * x2 + w[4] * x4 - w[6] * x6;
  int64_t b0 = w[1] * x1 + w[3] * x3 + w[5] * x5 + w[7] * x7;
  int64_t b1 = w[3] * x1 - w[7] * x3 - w[1] * x5 - w[5] * x7;
  int64_t b2 = w[5] * x1 - w[1] * x3 + w[7] * x5 + w[3] * x7;
  int64_t b3 = w[7] * x1 - w[5] * x3 + w[3] * x5 - w[1] * x7;
  x[0] = (a0 + b0) >> shift;
  x[s] = (a1 + b1) >> shift;
  x[2 * s] = (a2 + b2) >> shift;
  x[3 * s] = (a3 + b3) >> shift;
  x[4 * s] = (a3 - b3) >> shift;
  x[5 * s] = (a2 - b2) >> shift;
  x[6 * s] = (a1 - b1) >> shift;
  x[7 * s] = (a0 - b0) >> shift;
}

// rows first, held in 16 bits (a row of zero AC coefficients is its DC
// times 8), then columns; x is (8, 8) natural order
void simple_idct(int64_t* x) {
  for (int r = 0; r < 8; ++r) {
    int64_t* row = x + r * 8;
    bool dc_only = true;
    for (int c = 1; c < 8; ++c) dc_only &= row[c] == 0;
    if (dc_only) {
      int64_t v = int16_t((row[0] * 8) & 0xFFFF);
      for (int c = 0; c < 8; ++c) row[c] = v;
      continue;
    }
    simple_idct_1d(row, 1, 11, 1 << 10);
    for (int c = 0; c < 8; ++c) row[c] = int16_t(row[c] & 0xFFFF);
  }
  for (int c = 0; c < 8; ++c)
    simple_idct_1d(x + c, 8, 20, kW[4] * ((1 << 19) / kW[4]));
}

struct Plane {
  int rows, cols;  // padded to whole blocks of the macroblock grid
  std::vector<uint8_t> px;
  std::vector<int> level;  // (rows/8 * cols/8) * 64 quantised, natural
  std::vector<int> dc_diff;  // per block
};

// a component's blocks: forward DCT, quantisation, DC prediction, and
// the reconstruction into `rec` (stride rec_cols), when not null
void code_plane(Plane& p, uint8_t* rec, int rec_rows, int rec_cols) {
  const int br = p.rows / 8, bc = p.cols / 8;
  const int q = kQscale, scaler = kDcScaler;
  p.level.assign(static_cast<size_t>(br) * bc * 64, 0);
  p.dc_diff.assign(static_cast<size_t>(br) * bc, 0);
  int64_t x[64];
  for (int by = 0; by < br; ++by)
    for (int bx = 0; bx < bc; ++bx) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          x[r * 8 + c] =
              int64_t(p.px[size_t(by * 8 + r) * p.cols + bx * 8 + c]) - 128;
      for (int r = 0; r < 8; ++r) fdct_1d(x + r * 8, 1, false);
      for (int c = 0; c < 8; ++c) fdct_1d(x + c, 8, true);
      int* lv = &p.level[(size_t(by) * bc + bx) * 64];
      lv[0] = static_cast<int>((x[0] + 8192 + 4 * scaler) / (8 * scaler));
      for (int i = 1; i < 64; ++i) {
        int64_t a = std::llabs(x[i]);
        int64_t l = a / (16 * q);
        if (l == 0 && a >= 12 * q) l = 1;
        l = std::min<int64_t>(l, 2047);
        lv[i] = static_cast<int>(x[i] < 0 ? -l : l);
      }
    }
  // DC prediction in dequantised units, 1024 outside the VOP
  auto f = [&](int by, int bx) -> int {
    if (by < 0 || bx < 0) return 1024;
    return p.level[(size_t(by) * bc + bx) * 64] * scaler;
  };
  for (int by = 0; by < br; ++by)
    for (int bx = 0; bx < bc; ++bx) {
      int a = f(by, bx - 1), b = f(by - 1, bx - 1), c = f(by - 1, bx);
      int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
      pred = (pred + (scaler >> 1)) / scaler;
      p.dc_diff[size_t(by) * bc + bx] =
          p.level[(size_t(by) * bc + bx) * 64] - pred;
    }
  if (!rec) return;
  for (int by = 0; by < br; ++by)
    for (int bx = 0; bx < bc; ++bx) {
      const int* lv = &p.level[(size_t(by) * bc + bx) * 64];
      x[0] = int64_t(lv[0]) * scaler;
      for (int i = 1; i < 64; ++i) {
        int l = std::abs(lv[i]);
        int64_t v = l ? q * (2 * l + 1) - 1 : 0;  // q even: one less
        x[i] = lv[i] < 0 ? -v : v;
      }
      for (int i = 0; i < 64; ++i)
        x[i] = std::min<int64_t>(std::max<int64_t>(x[i], -2048), 2047);
      simple_idct(x);
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) {
          int y = by * 8 + r, xx = bx * 8 + c;
          if (y >= rec_rows || xx >= rec_cols) continue;
          int64_t v = x[r * 8 + c];
          v = v < 0 ? 0 : (v > 255 ? 255 : v);
          rec[size_t(y) * rec_cols + xx] = static_cast<uint8_t>(v);
        }
    }
}

void put_dc(BitWriter& bw, int dc_diff, bool luma) {
  int a = std::abs(dc_diff), size = 0;
  while (a >> size) ++size;
  const uint8_t* dc = luma ? kDcLuma[size] : kDcChroma[size];
  bw.put(dc[0], dc[1]);
  bw.put(static_cast<uint64_t>(dc_diff < 0 ? dc_diff - 1 : dc_diff), size);
  if (size > 8) bw.put(1, 1);
}

void put_ac(BitWriter& bw, const int* lv) {
  int lastk = 0;
  for (int k = 1; k < 64; ++k)
    if (lv[kZigzag[k]]) lastk = k;
  int run = 0;
  for (int k = 1; k <= lastk; ++k) {
    int l = lv[kZigzag[k]];
    if (!l) {
      ++run;
      continue;
    }
    int last = k == lastk, mag = std::abs(l);
    uint32_t e = mag <= kMaxLevel ? kVlc.t[last][run][mag] : 0;
    if (e) {
      bw.put((uint64_t(e >> 8) << 1) | (l < 0), (e & 255) + 1);
    } else {
      uint64_t v = (3 << 2) | 3;
      v = (v << 1) | last;
      v = (v << 6) | run;
      v = (v << 1) | 1;
      v = (v << 12) | (static_cast<uint32_t>(l) & 0xFFF);
      v = (v << 1) | 1;
      bw.put(v, 30);
    }
    run = 0;
  }
}

}  // namespace

extern "C" long gstex_mp4v_vop(const uint8_t* rgb, int h, int w, int index,
                               int fps, uint8_t* out, long cap,
                               uint8_t* recon) {
  const int mbh = (h + 15) / 16, mbw = (w + 15) / 16;
  Plane y{mbh * 16, mbw * 16, {}, {}, {}};
  Plane cb{mbh * 8, mbw * 8, {}, {}, {}};
  Plane cr{mbh * 8, mbw * 8, {}, {}, {}};
  y.px.resize(size_t(y.rows) * y.cols);
  cb.px.resize(size_t(cb.rows) * cb.cols);
  cr.px.resize(size_t(cr.rows) * cr.cols);
  auto clamp8 = [](int64_t v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  for (int r = 0; r < y.rows; ++r)
    for (int c = 0; c < y.cols; ++c) {
      const uint8_t* p =
          rgb + (size_t(std::min(r, h - 1)) * w + std::min(c, w - 1)) * 3;
      y.px[size_t(r) * y.cols + c] = clamp8(
          ((16 << 16) + 16829LL * p[0] + 33039LL * p[1] + 6416LL * p[2] +
           (1 << 15)) >> 16);
    }
  for (int r = 0; r < cb.rows; ++r)
    for (int c = 0; c < cb.cols; ++c) {
      int rr = std::min(r, h / 2 - 1), cc = std::min(c, w / 2 - 1);
      int64_t sb = 0, sr = 0;
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx) {
          const uint8_t* p =
              rgb + (size_t(2 * rr + dy) * w + 2 * cc + dx) * 3;
          sb += -9714LL * p[0] - 19070LL * p[1] + 28784LL * p[2];
          sr += 28784LL * p[0] - 24103LL * p[1] - 4681LL * p[2];
        }
      cb.px[size_t(r) * cb.cols + c] =
          clamp8(((128LL << 18) + sb + (1 << 17)) >> 18);
      cr.px[size_t(r) * cr.cols + c] =
          clamp8(((128LL << 18) + sr + (1 << 17)) >> 18);
    }
  uint8_t* ry = recon;
  uint8_t* rb = recon ? recon + size_t(h) * w : nullptr;
  uint8_t* rr = recon ? rb + size_t(h / 2) * (w / 2) : nullptr;
  code_plane(y, ry, h, w);
  code_plane(cb, rb, h / 2, w / 2);
  code_plane(cr, rr, h / 2, w / 2);

  BitWriter bw{out, cap};
  const int tb = time_bits(fps);
  const int seconds = index ? index / fps - (index - 1) / fps : 0;
  bw.put(0x1B6, 32);                      // vop_start_code
  bw.put(0, 2);                           // vop_coding_type: I
  bw.put(((uint64_t(1) << seconds) - 1) << 1, seconds + 1);
  bw.put(1, 1);
  bw.put(index % fps, tb);                // vop_time_increment
  bw.put(1, 1);
  bw.put(1, 1);                           // vop_coded
  bw.put(0, 3);                           // intra_dc_vlc_thr
  bw.put(kQscale, 5);                     // vop_quant
  const int ybc = y.cols / 8, cbc = cb.cols / 8;
  for (int my = 0; my < mbh; ++my)
    for (int mx = 0; mx < mbw; ++mx) {
      const int* blk[6];
      int diff[6];
      for (int i = 0; i < 4; ++i) {
        size_t b = size_t(2 * my + i / 2) * ybc + 2 * mx + i % 2;
        blk[i] = &y.level[b * 64];
        diff[i] = y.dc_diff[b];
      }
      size_t b = size_t(my) * cbc + mx;
      blk[4] = &cb.level[b * 64];
      diff[4] = cb.dc_diff[b];
      blk[5] = &cr.level[b * 64];
      diff[5] = cr.dc_diff[b];
      bool coded[6];
      for (int i = 0; i < 6; ++i) {
        coded[i] = false;
        for (int k = 1; k < 64; ++k) coded[i] |= blk[i][kZigzag[k]] != 0;
      }
      int cbpc = coded[4] * 2 + coded[5];
      int cbpy = coded[0] * 8 + coded[1] * 4 + coded[2] * 2 + coded[3];
      bw.put(kMcbpc[cbpc][0], kMcbpc[cbpc][1]);
      bw.put(0, 1);                       // ac_pred_flag
      bw.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
      for (int i = 0; i < 6; ++i) {
        put_dc(bw, diff[i], i < 4);
        if (coded[i]) put_ac(bw, blk[i]);
      }
    }
  // next_start_code(): a 0 bit, then 1 bits to the byte
  int pad = (8 - (bw.nacc + 1) % 8) % 8;
  bw.put(0, 1);
  bw.put((uint64_t(1) << pad) - 1, pad);
  return bw.overflow ? -1 : bw.n;
}
