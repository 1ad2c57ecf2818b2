// JPEG decoding on the host, to the bytes of libjpeg-turbo 3's default
// decompression as PIL's Image.open(...).convert("RGB") returns them:
// - Huffman streams, baseline and extended-sequential, progressive
//   (jdphuff.c: DC and AC first and refinement scans, end-of-band runs)
//   and lossless (jdlossls.c: predictors 1-7, point transform);
//   arithmetic-coded sequential and progressive streams (jdarith.c: the
//   QM decoder, DAC conditioning); restart markers throughout;
// - the integer "islow" inverse DCT of jidctint.c; jdsample.c's
//   upsampling at every integral factor (fancy h2v1, h1v2, h2v2 where it
//   applies, box replication otherwise and for lossless streams);
// - jdcolor.c's fixed-point YCbCr->RGB, and for CMYK / YCCK PIL's
//   inversion of Adobe CMYK and its CMYK->RGB conversion.
// Grey streams give one channel, every colour stream RGB. Streams PIL
// refuses (12-bit, differential, arithmetic lossless, fractional
// sampling, lossless YCbCr) are refused with a message, and so are
// streams cut short where PIL's libjpeg runs out of data (Feed,
// HuffFeed: a cut marker segment it needs, a multi-scan stream without
// its EOI, a single scan whose Huffman decoder reads ahead past the end,
// arithmetic-coded data that ends early or crosses one of PIL's 64 KiB
// reads). A progressive
// stream whose scans leave low AC coefficients incomplete has its blocks
// smoothed as jdcoefct.c's decompress_smooth_data does. The same decoder
// in Python and numpy is gstex_torch/data/jpeg.py:decode_plain.
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

const char* kUnsupported =
    "PIL refuses them too, so the JAX package's loader does";
constexpr int kMaxBlocksInMcu = 10;
constexpr int kSmoothedCoefs = 9;

// jdcoefct.c's block smoothing: per zigzag coefficient k (0 the DC), the
// weights of the 5x5 DC values around a block (rows top to bottom,
// columns left to right) whose sum, times the DC's quantizer, estimates
// it. [0] where some AC data was sent (k 1-5 only), [1] where none was.
const int16_t kSmoothK[2][10][25] = {
    {
        {},
        {0, 0, 0, 0, 0,  // AC01
         0, 0, 0, 0, 0,
         -7, 50, 0, -50, 7,
         0, 0, 0, 0, 0,
         0, 0, 0, 0, 0},
        {0, 0, -7, 0, 0,  // AC10
         0, 0, 50, 0, 0,
         0, 0, 0, 0, 0,
         0, 0, -50, 0, 0,
         0, 0, 7, 0, 0},
        {0, 0, -1, 0, 0,  // AC20
         0, 0, 13, 0, 0,
         0, 0, -24, 0, 0,
         0, 0, 13, 0, 0,
         0, 0, -1, 0, 0},
        {0, -1, 0, 1, 0,  // AC11
         -1, 10, 0, -10, 1,
         0, 0, 0, 0, 0,
         1, -10, 0, 10, -1,
         0, 1, 0, -1, 0},
        {0, 0, 0, 0, 0,  // AC02
         0, 0, 0, 0, 0,
         -1, 13, -24, 13, -1,
         0, 0, 0, 0, 0,
         0, 0, 0, 0, 0},
        {},
        {},
        {},
        {},
    },
    {
        {-2, -6, -8, -6, -2,  // DC
         -6, 6, 42, 6, -6,
         -8, 42, 152, 42, -8,
         -6, 6, 42, 6, -6,
         -2, -6, -8, -6, -2},
        {-1, -1, 0, 1, 1,  // AC01
         -3, 13, 0, -13, 3,
         -3, 38, 0, -38, 3,
         -3, 13, 0, -13, 3,
         -1, -1, 0, 1, 1},
        {-1, -3, -3, -3, -1,  // AC10
         -1, 13, 38, 13, -1,
         0, 0, 0, 0, 0,
         1, -13, -38, -13, 1,
         1, 3, 3, 3, 1},
        {0, 0, 1, 0, 0,  // AC20
         0, 2, 7, 2, 0,
         0, -5, -14, -5, 0,
         0, 2, 7, 2, 0,
         0, 0, 1, 0, 0},
        {-1, 0, 0, 0, 1,  // AC11
         0, 9, 0, -9, 0,
         0, 0, 0, 0, 0,
         0, -9, 0, 9, 0,
         1, 0, 0, 0, -1},
        {0, 0, 0, 0, 0,  // AC02
         0, 2, -5, 2, 0,
         1, 7, -14, 7, 1,
         0, 2, -5, 2, 0,
         0, 0, 0, 0, 0},
        {0, 0, 0, 0, 0,  // AC03
         0, 1, 0, -1, 0,
         0, 2, 0, -2, 0,
         0, 1, 0, -1, 0,
         0, 0, 0, 0, 0},
        {0, 0, 0, 0, 0,  // AC12
         0, 1, -3, 1, 0,
         0, 0, 0, 0, 0,
         0, -1, 3, -1, 0,
         0, 0, 0, 0, 0},
        {0, 0, 0, 0, 0,  // AC21
         0, 1, 0, -1, 0,
         0, -3, 0, 3, 0,
         0, 1, 0, -1, 0,
         0, 0, 0, 0, 0},
        {0, 0, 0, 0, 0,  // AC30
         0, 1, 2, 1, 0,
         0, 0, 0, 0, 0,
         0, -1, -2, -1, 0,
         0, 0, 0, 0, 0},
    },
};

// zigzag position -> natural index; 16 extra entries keep a corrupt run
// inside the block, as libjpeg's jpeg_natural_order does
const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU T.81 Table D.2 as jaricom.c holds it: Qe, next state after an LPS
// (its MPS switch in bit 7), next state after an MPS; state 113 is the
// fixed probability 0.5
struct QeEntry {
  uint16_t qe;
  uint8_t nl, nm;
};
const QeEntry kQe[114] = {
    {0x5a1d, 1 | 128, 1},   {0x2586, 14, 2},    {0x1114, 16, 3},
    {0x080b, 18, 4},        {0x03d8, 20, 5},    {0x01da, 23, 6},
    {0x00e5, 25, 7},        {0x006f, 28, 8},    {0x0036, 30, 9},
    {0x001a, 33, 10},       {0x000d, 35, 11},   {0x0006, 9, 12},
    {0x0003, 10, 13},       {0x0001, 12, 13},   {0x5a7f, 15 | 128, 15},
    {0x3f25, 36, 16},       {0x2cf2, 38, 17},   {0x207c, 39, 18},
    {0x17b9, 40, 19},       {0x1182, 42, 20},   {0x0cef, 43, 21},
    {0x09a1, 45, 22},       {0x072f, 46, 23},   {0x055c, 48, 24},
    {0x0406, 49, 25},       {0x0303, 51, 26},   {0x0240, 52, 27},
    {0x01b1, 54, 28},       {0x0144, 56, 29},   {0x00f5, 57, 30},
    {0x00b7, 59, 31},       {0x008a, 60, 32},   {0x0068, 62, 33},
    {0x004e, 63, 34},       {0x003b, 32, 35},   {0x002c, 33, 9},
    {0x5ae1, 37 | 128, 37}, {0x484c, 64, 38},   {0x3a0d, 65, 39},
    {0x2ef1, 67, 40},       {0x261f, 68, 41},   {0x1f33, 69, 42},
    {0x19a8, 70, 43},       {0x1518, 72, 44},   {0x1177, 73, 45},
    {0x0e74, 74, 46},       {0x0bfb, 75, 47},   {0x09f8, 77, 48},
    {0x0861, 78, 49},       {0x0706, 79, 50},   {0x05cd, 48, 51},
    {0x04de, 50, 52},       {0x040f, 50, 53},   {0x0363, 51, 54},
    {0x02d4, 52, 55},       {0x025c, 53, 56},   {0x01f8, 54, 57},
    {0x01a4, 55, 58},       {0x0160, 56, 59},   {0x0125, 57, 60},
    {0x00f6, 58, 61},       {0x00cb, 59, 62},   {0x00ab, 61, 63},
    {0x008f, 61, 32},       {0x5b12, 65 | 128, 65}, {0x4d04, 80, 66},
    {0x412c, 81, 67},       {0x37d8, 82, 68},   {0x2fe8, 83, 69},
    {0x293c, 84, 70},       {0x2379, 86, 71},   {0x1edf, 87, 72},
    {0x1aa9, 87, 73},       {0x174e, 72, 74},   {0x1424, 72, 75},
    {0x119c, 74, 76},       {0x0f6b, 74, 77},   {0x0d51, 75, 78},
    {0x0bb6, 77, 79},       {0x0a40, 77, 48},   {0x5832, 80 | 128, 81},
    {0x4d1c, 88, 82},       {0x438e, 89, 83},   {0x3bdd, 90, 84},
    {0x34ee, 91, 85},       {0x2eae, 92, 86},   {0x299a, 93, 87},
    {0x2516, 86, 71},       {0x5570, 88 | 128, 89}, {0x4ca9, 95, 90},
    {0x44d9, 96, 91},       {0x3e22, 97, 92},   {0x3824, 99, 93},
    {0x32b4, 99, 94},       {0x2e17, 93, 86},   {0x56a8, 95 | 128, 96},
    {0x4f46, 101, 97},      {0x47e5, 102, 98},  {0x41cf, 103, 99},
    {0x3c3d, 104, 100},     {0x375e, 99, 93},   {0x5231, 105, 102},
    {0x4c0f, 106, 103},     {0x4639, 107, 104}, {0x415e, 103, 99},
    {0x5627, 105 | 128, 106}, {0x50e7, 108, 107}, {0x4b85, 109, 103},
    {0x5597, 110, 109},     {0x504f, 111, 107}, {0x5a10, 110 | 128, 111},
    {0x5522, 112, 109},     {0x59eb, 112 | 128, 111}, {0x5a1d, 113, 113}};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }
[[noreturn]] void unsupported(const std::string& what) {
  fail(what + " JPEG streams are not decoded: " + kUnsupported);
}
std::string truncated(const std::string& where) {
  return "JPEG stream truncated " + where +
         ": PIL's libjpeg runs out of data there, and PIL raises";
}
const char* kArithAcrossRead =
    "arithmetic-coded JPEG data across one of PIL's 64 KiB reads is not "
    "decoded: PIL's libjpeg cannot suspend inside it and raises (a broken "
    "data stream)";

// How PIL feeds libjpeg-turbo, which decides where a stream cut short
// raises: ImageFile.load passes the file in reads of 64 KiB
// (ImageFile.MAXBLOCK), one more each time the decoder suspends for want
// of data, and raises when there is none. jdhuff.c fills its 64-bit bit
// buffer to at least 57 bits (MIN_GET_BITS) wherever a check finds fewer
// bits than it needs, and decodes an MCU on its fast path (6 bytes at a
// time where 16 bits or fewer are left) where no restart interval is set
// and at least 512 bytes a block (BUFSIZE) are left in the read.
constexpr long kRead = 1 << 16;
constexpr int kMinGetBits = 57;
constexpr long kFastBytesABlock = 512;

// The stream as PIL feeds it: `extent` bytes read so far. need() is a
// read that may suspend: PIL reads on, and past the stream's end raises.
struct Feed {
  const uint8_t* d;
  long n, extent;
  Feed(const uint8_t* data, long len)
      : d(data), n(len), extent(std::min(kRead, len)) {}
  void need(long pos) {
    while (pos >= extent) {
      if (extent >= n) fail(truncated("in its entropy-coded data"));
      extent = std::min(extent + kRead, n);
    }
  }
};

// libjpeg-turbo's reads of one Huffman scan (jdhuff.c, jdlhuff.c) fed as
// Feed feeds them: mcu() replays an MCU's code lengths (> 0) and received
// bits (< 0, the Bits events) through the bit buffer, on the fast path
// where jdhuff.c takes it; an MCU that suspends is taken again from its
// start once PIL has read more.
struct HuffFeed {
  Feed* feed;
  long fast_bytes;  // -1: the slow path only
  long q = 0;
  int bits = 0;
  bool marker = false;

  // a scan's or restart interval's data from `start`: the marker before
  // it read, the bit buffer empty
  void segment(long start) {
    feed->need(start - 1);
    q = start;
    bits = 0;
    marker = false;
  }

  void mcu(const std::vector<int>& ev) {
    while (!marker) {
      const long q0 = q;
      const int b0 = bits;
      if (fast_bytes >= 0 && feed->extent - q >= fast_bytes && fast(ev))
        return;
      q = q0;
      bits = b0;
      if (slow(ev)) return;
      q = q0;
      bits = b0;
      feed->need(feed->extent);
    }
  }

  // CHECK_BIT_BUFFER: a fill where fewer than n bits are left; false
  // where it would read past what PIL has read
  bool check(int n) {
    if (bits >= n) return true;
    const uint8_t* d = feed->d;
    const long extent = feed->extent;
    long p = q;
    while (bits < kMinGetBits) {
      if (p >= extent) return false;
      int c = d[p++];
      if (c == 0xFF) {
        while (c == 0xFF) {
          if (p >= extent) return false;
          c = d[p++];
        }
        if (c) {  // a marker: zeros from here
          q = p;
          marker = true;
          return true;
        }
      }
      bits += 8;
    }
    q = p;
    return true;
  }

  // decode_mcu_slow's checks (HUFF_DECODE, jpeg_huff_decode)
  bool slow(const std::vector<int>& ev) {
    for (int e : ev) {
      if (e > 0) {
        if (!check(8)) return false;
        if (e > 8) {
          if (!check(9)) return false;
          bits -= 9;
          for (int i = 9; i < e; ++i) {
            if (!check(1)) return false;
            bits -= 1;
          }
        } else {
          bits -= e;
        }
      } else {
        if (!check(-e)) return false;
        bits += e;
      }
      if (marker) return true;
    }
    return true;
  }

  // decode_mcu_fast's fills (FILL_BIT_BUFFER_FAST); false at a marker,
  // where jdhuff.c takes the MCU again on the slow path
  bool fast(const std::vector<int>& ev) {
    const uint8_t* d = feed->d;
    const long n = feed->n;
    for (int e : ev) {
      if (bits <= 16) {
        long p = q;
        for (int i = 0; i < 6; ++i) {
          const int c0 = d[p++];
          if (c0 == 0xFF) {
            if (p >= n || d[p]) return false;
            ++p;
          }
        }
        q = p;
        bits += 48;
      }
      bits -= e > 0 ? e : -e;
    }
    return true;
  }
};

struct Huffman {
  bool present = false;
  bool fits = true;   // no code of all ones: the counts make a prefix code
  int max_value = 0;  // the greatest symbol
  int mincode[17] = {0};
  int maxcode[18] = {0};
  int valptr[17] = {0};
  uint8_t values[256] = {0};
  // lookahead: for each 8-bit prefix, (length << 8 | value), 0 if longer
  uint16_t look[256] = {0};

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    present = true;
    std::memset(values, 0, sizeof(values));
    std::memcpy(values, vals, std::min(nvals, 256));
    max_value = 0;
    for (int i = 0; i < std::min(nvals, 256); ++i)
      max_value = std::max(max_value, int(vals[i]));
    fits = true;
    for (int len = 1, code = 0; len <= 16; ++len) {
      code += bits[len - 1];
      if (code >= (1 << len)) fits = false;
      code <<= 1;
    }
    std::memset(look, 0, sizeof(look));
    if (!fits) return;  // refused where a scan uses it
    int code = 0, k = 0;
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

  // jdhuff.c's jpeg_make_d_derived_tbl checks, made where a scan uses the
  // table: a prefix code, and symbols at most `max_symbol` (15 for a DC
  // table, 16 for a lossless one, 255 for an AC one)
  bool usable(int max_symbol) const { return fits && max_value <= max_symbol; }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int rows = 0, cols = 0;    // downsampled_height / downsampled_width
  int brows = 0, bcols = 0;  // blocks (samples, lossless) of the MCU grid
  std::vector<int16_t> coef;  // brows * bcols * 64, natural order
  std::vector<uint8_t> samples;  // lossless: rows * cols
  int coef_bits[64];
};

// Reads one restart interval's entropy-coded bytes in place: 0xFF00 is a
// 0xFF data byte, a marker ends the data (zeros follow). A read at or
// past `stop` (jdarith.c's fetches, which cannot suspend, past what PIL
// has read) raises `stop_msg`.
struct Bytes {
  const uint8_t* d;
  long n, pos;
  long stop = -1;  // -1: no limit
  std::string stop_msg;
  bool hit_marker = false;

  unsigned next() {
    if (hit_marker) return 0;
    if (stop >= 0 && pos >= stop) fail(stop_msg);
    if (pos >= n) return 0;
    unsigned byte = d[pos];
    if (byte != 0xFF) {
      ++pos;
      return byte;
    }
    long p = pos + 1;
    while (p < n && d[p] == 0xFF) ++p;  // fill bytes
    if (stop >= 0 && p >= stop) fail(stop_msg);
    if (p < n && d[p] == 0x00) {
      pos = p + 1;
      return 0xFF;
    }
    hit_marker = true;
    pos = p - 1;  // at the marker's 0xFF
    return 0;
  }
};

// The bits of one restart interval. With `ev` set, each Huffman code
// appends its length and each run of n received bits appends -n, what
// HuffFeed replays.
struct Bits {
  Bytes in;
  uint64_t acc = 0;
  int nacc = 0;
  std::vector<int>* ev = nullptr;

  void fill() {
    while (nacc <= 56) {
      acc |= static_cast<uint64_t>(in.next()) << (56 - nacc);
      nacc += 8;
    }
  }
  int take(int s) {
    if (s == 0) return 0;
    if (nacc < s) fill();
    int v = static_cast<int>(acc >> (64 - s));
    acc <<= s;
    nacc -= s;
    return v;
  }
  int get(int s) {
    if (ev && s) ev->push_back(-s);
    return take(s);
  }
  int decode(const Huffman& h) {
    if (nacc < 16) fill();
    int look = h.look[acc >> 56];
    if (look) {
      int len = look >> 8;
      acc <<= len;
      nacc -= len;
      if (ev) ev->push_back(len);
      return look & 255;
    }
    int code = take(1);
    int len = 1;
    while (len <= 16 && code > h.maxcode[len]) {
      code = (code << 1) | take(1);
      ++len;
    }
    if (ev) ev->push_back(len);
    if (len > 16) return 0;  // corrupt data: libjpeg returns 0
    return h.values[(h.valptr[len] + code - h.mincode[len]) & 255];
  }
};

// jdarith.c's arith_decode: C holds the interval's base and the input
// bits, CT counts the bits left in it
struct Arith {
  Bytes in;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool dead = false;  // a magnitude or spectral overflow ends the interval

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | in.next();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const QeEntry& e = kQe[sv & 0x7F];
    int64_t qe = e.qe;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ e.nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ e.nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ e.nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ e.nm);
      }
    }
    return sv >> 7;
  }
};

// one restart interval's arithmetic statistics
struct ArithStats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
  uint8_t fixed = 113;
  int last_dc[4] = {0, 0, 0, 0};
  int context[4] = {0, 0, 0, 0};
  ArithStats() {
    std::memset(dc, 0, sizeof(dc));
    std::memset(ac, 0, sizeof(ac));
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int16_t s16(int v) { return static_cast<int16_t>(v); }

struct Scan {
  int ns = 0;
  int comps[4], td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

// ---- Huffman block decoders (jdhuff.c, jdphuff.c) ----

int huff_dc_diff(Bits& b, const Huffman& dc) {
  int t = b.decode(dc);
  return t ? extend(b.get(t), t) : 0;
}

void huff_block(Bits& b, const Huffman& dc, const Huffman& ac, int& pred,
                int16_t* out) {
  pred += huff_dc_diff(b, dc);
  out[0] = s16(pred);
  for (int k = 1; k < 64;) {
    int rs = b.decode(ac);
    int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      out[kZigzag[k]] = s16(extend(b.get(sz), sz));
      ++k;
    } else if (r == 15) {
      k += 16;
    } else {
      break;
    }
  }
}

void huff_ac_first(Bits& b, const Huffman& ac, int16_t* out, const Scan& s,
                   int& eobrun) {
  if (eobrun > 0) {
    --eobrun;
    return;
  }
  for (int k = s.ss; k <= s.se; ++k) {
    int rs = b.decode(ac);
    int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      out[kZigzag[k]] =
          s16(static_cast<int>(static_cast<unsigned>(extend(b.get(sz), sz))
                               << s.al));
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun = 1 << r;
      if (r) eobrun += b.get(r);
      --eobrun;
      break;
    }
  }
}

inline void refine(Bits& b, int16_t* coef, int p1, int m1) {
  if (b.get(1) && (*coef & p1) == 0)
    *coef = s16(*coef + (*coef >= 0 ? p1 : m1));
}

void huff_ac_refine(Bits& b, const Huffman& ac, int16_t* out, const Scan& s,
                    int& eobrun) {
  const int p1 = 1 << s.al, m1 = -p1;
  int k = s.ss;
  if (eobrun == 0) {
    for (; k <= s.se; ++k) {
      int rs = b.decode(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        sz = b.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        break;
      }
      do {
        int16_t* coef = out + kZigzag[k];
        if (*coef != 0) {
          refine(b, coef, p1, m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= s.se);
      if (sz) out[kZigzag[k]] = s16(sz);
    }
  }
  if (eobrun > 0) {
    for (; k <= s.se; ++k) {
      int16_t* coef = out + kZigzag[k];
      if (*coef != 0) refine(b, coef, p1, m1);
    }
    --eobrun;
  }
}

// ---- arithmetic block decoders (jdarith.c) ----

// Figure F.23's chain from bin i: m doubles at each 1; returns the bin
// that ended it (the magnitude bits start 14 further)
int arith_chain(Arith& ar, uint8_t* st, int& m, int i) {
  while (ar.decode(st + i)) {
    if ((m <<= 1) == 0x8000) {
      ar.dead = true;
      return i;
    }
    ++i;
  }
  return i;
}

int arith_bits(Arith& ar, uint8_t* st, int m, int i) {
  int v = m;
  i += 14;
  while (m >>= 1)
    if (ar.decode(st + i)) v |= m;
  return v + 1;
}

int arith_dc_diff(Arith& ar, ArithStats& stats, int e, int tbl, int lo,
                  int hi) {
  uint8_t* st = stats.dc[tbl];
  int s0 = stats.context[e];
  if (ar.decode(st + s0) == 0) {
    stats.context[e] = 0;
    return 0;
  }
  int sign = ar.decode(st + s0 + 1);
  int i = s0 + 2 + sign;
  int m = ar.decode(st + i);
  if (m) {
    i = arith_chain(ar, st, m, 20);
    if (ar.dead) return 0;
  }
  if (m < static_cast<int>((1L << lo) >> 1))
    stats.context[e] = 0;
  else if (m > static_cast<int>((1L << hi) >> 1))
    stats.context[e] = 12 + sign * 4;
  else
    stats.context[e] = 4 + sign * 4;
  int v = arith_bits(ar, st, m, i);
  return sign ? -v : v;
}

// the value of the AC coefficient at zigzag k whose bins start at i (its
// "nonzero" decision taken)
int arith_ac_value(Arith& ar, ArithStats& stats, uint8_t* st, int i, int k,
                   int kx) {
  int sign = ar.decode(&stats.fixed);
  i += 2;
  int m = ar.decode(st + i);
  if (m && ar.decode(st + i)) {
    m = 2;
    i = arith_chain(ar, st, m, k <= kx ? 189 : 217);
    if (ar.dead) return 0;
  }
  int v = arith_bits(ar, st, m, i);
  return sign ? -v : v;
}

// ---------------------------------------------------------------------------

struct Decoder {
  const uint8_t* d;
  long n;
  int height = 0, width = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool jfif = false;
  int adobe = -1;
  bool have_frame = false, progressive = false, lossless = false,
       arith = false;
  std::vector<Component> comps;
  int qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman huff[2][4];
  int dac_l[16], dac_u[16], dac_k[16];
  int mcu_rows = 0, mcu_cols = 0;
  int first_scan_ns = 0;  // components of the first scan
  bool eoi = false;       // the EOI marker was reached
  Feed feed;

  Decoder(const uint8_t* data, long len) : d(data), n(len), feed(data, len) {
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
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
    if (nc != 1 && nc != 3 && nc != 4)
      unsupported(std::to_string(nc) + "-component");
    if (height == 0 || width == 0)
      fail("JPEG frame with a zero size (DNL) is not supported");
    if (len < 6 + 3 * nc) fail("JPEG frame header truncated");
    comps.assign(nc, Component());
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i] & 3;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        unsupported("sampling " + std::to_string(c.h) + "x" +
                    std::to_string(c.v));
    }
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps)
      if (hmax % c.h || vmax % c.v)
        unsupported("fractional sampling (" + std::to_string(c.h) + "x" +
                    std::to_string(c.v) + " of " + std::to_string(hmax) +
                    "x" + std::to_string(vmax) + ")");
    const int b = lossless ? 1 : 8;
    mcu_rows = (height + b * vmax - 1) / (b * vmax);
    mcu_cols = (width + b * hmax - 1) / (b * hmax);
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

  void conditioning(long p, int len) {
    for (long q = p; q + 1 < p + len; q += 2) {
      int index = d[q], val = d[q + 1];
      if (index >= 32) fail("JPEG DAC table index bad");
      if (index >= 16) {
        dac_k[index - 16] = val;
      } else {
        dac_l[index] = val & 15;
        dac_u[index] = val >> 4;
        if (dac_l[index] > dac_u[index]) fail("JPEG DAC value bad");
      }
    }
  }

  void quant(long p, int len) {
    long end = p + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 3;
      int size = pq ? 128 : 64;
      if (p + 1 + size > end) fail("JPEG quantization table truncated");
      for (int i = 0; i < 64; ++i)
        qt[tq][kZigzag[i]] = pq ? u16(p + 1 + 2 * i) : d[p + 1 + i];
      qt_present[tq] = true;
      p += 1 + size;
    }
  }

  Scan scan_header(long p, int len) {
    if (!have_frame) fail("JPEG scan before the frame header");
    Scan s;
    s.ns = d[p];
    if (s.ns < 1 || s.ns > 4 || len < 4 + 2 * s.ns)
      fail("JPEG scan header bad");
    int blocks = 0;
    for (int i = 0; i < s.ns; ++i) {
      int cid = d[p + 1 + 2 * i], t = d[p + 2 + 2 * i];
      int ci = -1;
      for (size_t k = 0; k < comps.size(); ++k)
        if (comps[k].id == cid) ci = static_cast<int>(k);
      if (ci < 0) fail("JPEG scan names an unknown component");
      s.comps[i] = ci;
      s.td[i] = t >> 4;
      s.ta[i] = t & 15;
      blocks += comps[ci].h * comps[ci].v;
    }
    s.ss = d[p + 1 + 2 * s.ns];
    s.se = d[p + 2 + 2 * s.ns];
    s.ah = d[p + 3 + 2 * s.ns] >> 4;
    s.al = d[p + 3 + 2 * s.ns] & 15;
    if (progressive &&
        (s.ss > s.se || s.se > 63 || (s.ss == 0 && s.se) ||
         (s.ss && s.ns != 1) || s.ah > 13 || s.al > 13))
      fail("JPEG progression bad");
    if (s.ns > 1 && blocks > kMaxBlocksInMcu)
      unsupported("more than " + std::to_string(kMaxBlocksInMcu) +
                  " blocks an MCU");
    if (!arith) {
      bool dc = lossless || (s.ss == 0 && s.ah == 0);
      bool ac = !lossless && (progressive ? s.se > 0 : true);
      for (int i = 0; i < s.ns; ++i)
        if ((dc && (s.td[i] > 3 || !huff[0][s.td[i]].present)) ||
            (ac && (s.ta[i] > 3 || !huff[1][s.ta[i]].present)))
          fail("JPEG scan uses an undefined Huffman table");
      for (int i = 0; i < s.ns; ++i)
        if ((dc && !huff[0][s.td[i]].usable(lossless ? 16 : 15)) ||
            (ac && !huff[1][s.ta[i]].usable(255)))
          fail("JPEG Huffman table bad");
    }
    return s;
  }

  // skip what is left of a restart interval, past its RSTn marker
  long to_restart(long q) const {
    while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] >= 0xD0 &&
                          d[q + 1] <= 0xD7)) {
      if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF)
        return q;  // another marker: the data ends early
      ++q;
    }
    // libjpeg reads the restart marker past the stream's end
    if (q + 1 >= n) fail(truncated("before a restart marker"));
    return q + 2;
  }

  // libjpeg's has_multiple_scans: a progressive frame, or a first scan
  // without every component. Such a stream is read to its EOI before the
  // first line is output.
  bool multi_scan() const {
    return progressive || first_scan_ns < static_cast<int>(comps.size());
  }

  // where the data from `q` ends: the next marker other than RSTn, or n
  long data_end(long q) const {
    for (; q + 1 < n; ++q)
      if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF &&
          !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7))
        return q;
    return n;
  }

  // Decode one scan from its entropy-coded data at `p`; returns the
  // position of the marker that ends it.
  long scan(long p, int len) {
    const Scan s = scan_header(p, len);
    const long pos = p + len;
    if (first_scan_ns == 0) first_scan_ns = s.ns;
    for (int e = 0; e < s.ns; ++e) {
      Component& c = comps[s.comps[e]];
      if (lossless) continue;
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.brows) * c.bcols * 64, 0);
      if (progressive)
        for (int k = s.ss; k <= s.se; ++k) c.coef_bits[k] = s.al;
    }
    const int b = lossless ? 1 : 8;
    // units of the scan: MCUs (interleaved) or the component's own blocks
    long units_y, units_x;
    if (s.ns == 1) {
      const Component& c = comps[s.comps[0]];
      units_y = (c.rows + b - 1) / b;
      units_x = (c.cols + b - 1) / b;
    } else {
      units_y = mcu_rows;
      units_x = mcu_cols;
    }
    const long total = units_y * units_x;
    const long per = restart ? restart : total;
    std::vector<std::vector<int32_t>> diffs;
    std::vector<char> reset_row;
    if (lossless) {
      if (per % units_x)
        fail("lossless JPEG restart interval is not a whole number of MCU "
             "rows");
      for (int e = 0; e < s.ns; ++e) {
        const Component& c = comps[s.comps[e]];
        diffs.emplace_back(static_cast<size_t>(c.brows) * c.bcols, 0);
      }
      reset_row.assign(units_y, 0);
    }
    Bits bits{Bytes{d, n, pos}};
    Arith ar{Bytes{d, n, pos}};
    ArithStats stats;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    long q = pos;
    // a sequential Huffman scan whose data runs to the stream's end:
    // PIL's verdict turns on the bytes libjpeg reads ahead (a marker ends
    // the data of the others, and a multi-scan stream is read to its EOI)
    const bool model = !arith && !progressive && data_end(pos) == n;
    long blocks = 0;
    for (int e = 0; e < s.ns; ++e)
      blocks += s.ns == 1 ? 1 : comps[s.comps[e]].h * comps[s.comps[e]].v;
    HuffFeed hf{&feed, restart || lossless ? -1 : kFastBytesABlock * blocks};
    std::vector<int> ev;
    for (long u = 0; u < total; ++u) {
      if (u % per == 0) {
        if (u > 0) q = to_restart(arith ? ar.in.pos : bits.in.pos);
        bits = Bits{Bytes{d, n, q}};
        ar = Arith{Bytes{d, n, q}};
        if (arith) {
          // jdarith.c's fetches cannot suspend: past what PIL has read
          // they raise
          feed.need(q - 1);
          ar.in.stop = feed.extent;
          ar.in.stop_msg = feed.extent == n
                               ? truncated("in its arithmetic-coded data")
                               : kArithAcrossRead;
        } else if (model) {
          hf.segment(q);
          bits.ev = &ev;
        }
        stats = ArithStats();
        std::fill(pred, pred + 4, 0);
        eobrun = 0;
        if (lossless) reset_row[u / units_x] = 1;
      }
      ev.clear();
      const long uy = u / units_x, ux = u % units_x;
      for (int e = 0; e < s.ns; ++e) {
        Component& c = comps[s.comps[e]];
        const int bh = s.ns == 1 ? 1 : c.v, bw = s.ns == 1 ? 1 : c.h;
        for (int v = 0; v < bh; ++v)
          for (int h = 0; h < bw; ++h) {
            const long by = uy * bh + v, bx = ux * bw + h;
            if (lossless) {
              int t = bits.decode(huff[0][s.td[e]]);
              diffs[e][by * c.bcols + bx] =
                  t == 16 ? 32768 : (t ? extend(bits.get(t), t) : 0);
              continue;
            }
            int16_t* out = &c.coef[(by * c.bcols + bx) * 64];
            if (arith)
              arith_block(ar, stats, s, e, out);
            else
              huff_unit(bits, s, e, pred[e], eobrun, out);
          }
      }
      if (model) hf.mcu(ev);
    }
    if (lossless) undifference(s, diffs, reset_row, units_x);
    // the scan ends at the next marker other than RSTn
    q = arith ? ar.in.pos : bits.in.pos;
    while (q + 1 < n) {
      if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF &&
          !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7))
        return q;
      ++q;
    }
    return n;
  }

  void huff_unit(Bits& b, const Scan& s, int e, int& pred, int& eobrun,
                 int16_t* out) {
    if (!progressive) {
      huff_block(b, huff[0][s.td[e]], huff[1][s.ta[e]], pred, out);
    } else if (s.ss == 0 && s.ah == 0) {
      pred += huff_dc_diff(b, huff[0][s.td[e]]);
      out[0] = s16(static_cast<int>(static_cast<unsigned>(pred) << s.al));
    } else if (s.ss == 0) {
      if (b.get(1)) out[0] = s16(out[0] | (1 << s.al));
    } else if (s.ah == 0) {
      huff_ac_first(b, huff[1][s.ta[0]], out, s, eobrun);
    } else {
      huff_ac_refine(b, huff[1][s.ta[0]], out, s, eobrun);
    }
  }

  void arith_block(Arith& ar, ArithStats& stats, const Scan& s, int e,
                   int16_t* out) {
    if (ar.dead) return;
    const int td = s.td[e], ta = s.ta[e];
    if (!progressive || (s.ss == 0 && s.ah == 0)) {
      int diff = arith_dc_diff(ar, stats, e, td, dac_l[td], dac_u[td]);
      if (ar.dead) return;
      stats.last_dc[e] = (stats.last_dc[e] + diff) & 0xFFFF;
      out[0] = s16(stats.last_dc[e] << (progressive ? s.al : 0));
      if (progressive) return;
      uint8_t* st = stats.ac[ta];
      for (int k = 0; k < 63;) {
        int i = 3 * k;
        if (ar.decode(st + i)) return;  // EOB
        for (;;) {
          ++k;
          if (ar.decode(st + i + 1)) break;
          i += 3;
          if (k >= 63) {
            ar.dead = true;
            return;
          }
        }
        int v = arith_ac_value(ar, stats, st, i, k, dac_k[ta]);
        if (ar.dead) return;
        out[kZigzag[k]] = s16(v);
      }
    } else if (s.ss == 0) {
      if (ar.decode(&stats.fixed)) out[0] = s16(out[0] | (1 << s.al));
    } else if (s.ah == 0) {
      uint8_t* st = stats.ac[ta];
      for (int k = s.ss; k <= s.se; ++k) {
        int i = 3 * (k - 1);
        if (ar.decode(st + i)) return;  // EOB
        while (ar.decode(st + i + 1) == 0) {
          i += 3;
          if (++k > s.se) {
            ar.dead = true;
            return;
          }
        }
        int v = arith_ac_value(ar, stats, st, i, k, dac_k[ta]);
        if (ar.dead) return;
        out[kZigzag[k]] =
            s16(static_cast<int>(static_cast<unsigned>(v) << s.al));
      }
    } else {
      uint8_t* st = stats.ac[ta];
      const int p1 = 1 << s.al, m1 = -p1;
      int kex = s.se;
      for (; kex > 0; --kex)
        if (out[kZigzag[kex]]) break;
      for (int k = s.ss; k <= s.se; ++k) {
        int i = 3 * (k - 1);
        if (k > kex && ar.decode(st + i)) return;  // EOB
        for (;;) {
          int16_t* coef = out + kZigzag[k];
          if (*coef) {
            if (ar.decode(st + i + 2))
              *coef = s16(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + i + 1)) {
            *coef = s16(ar.decode(&stats.fixed) ? m1 : p1);
            break;
          }
          i += 3;
          if (++k > s.se) {
            ar.dead = true;
            return;
          }
        }
      }
    }
  }

  // jdlossls.c's undifferencing of one scan's components
  void undifference(const Scan& s,
                    const std::vector<std::vector<int32_t>>& diffs,
                    const std::vector<char>& reset_row, long units_x) {
    (void)units_x;
    for (int e = 0; e < s.ns; ++e) {
      Component& c = comps[s.comps[e]];
      const int v = s.ns > 1 ? c.v : 1;
      std::vector<int> cur(c.cols), prev(c.cols);
      c.samples.assign(static_cast<size_t>(c.rows) * c.cols, 0);
      bool first = true;
      for (int y = 0; y < c.rows; ++y) {
        if (y % v == 0 && reset_row[y / v]) first = true;
        const int32_t* dr = &diffs[e][static_cast<size_t>(y) * c.bcols];
        for (int x = 0; x < c.cols; ++x) {
          int p;
          if (first) {
            p = x == 0 ? 1 << (7 - s.al) : cur[x - 1];
          } else if (x == 0) {
            p = prev[0];
          } else {
            int ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
            switch (s.ss) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
          }
          cur[x] = (dr[x] + p) & 0xFFFF;
          c.samples[static_cast<size_t>(y) * c.cols + x] =
              static_cast<uint8_t>(cur[x] << s.al);
        }
        first = false;
        std::swap(cur, prev);
      }
    }
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
      if (marker == 0xD9) {
        eoi = true;
        break;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (p + 2 > n || p + ((d[p] << 8) | d[p + 1]) > n) {
        // libjpeg reads on past a single scan's data only at the end,
        // whose want of data PIL forgives
        if (any_scan && !multi_scan()) break;
        fail(truncated("in a marker segment"));
      }
      int len = u16(p);
      if (len < 2) fail("JPEG marker segment truncated");
      long body = p + 2;
      int blen = len - 2;
      p += len;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          progressive = marker == 0xC2 || marker == 0xCA;
          lossless = marker == 0xC3;
          arith = marker == 0xC9 || marker == 0xCA;
          frame(body, blen);
          break;
        case 0xC5: unsupported("differential sequential");
        case 0xC6: unsupported("differential progressive");
        case 0xC7: unsupported("differential lossless");
        case 0xCB: unsupported("arithmetic-coded lossless");
        case 0xCD: unsupported("arithmetic-coded differential sequential");
        case 0xCE:
          unsupported("arithmetic-coded differential progressive");
        case 0xCF: unsupported("arithmetic-coded differential lossless");
        case 0xC4: huffman(body, blen); break;
        case 0xCC: conditioning(body, blen); break;
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
    if (decode_scans && !eoi && multi_scan())
      fail(truncated("before its EOI marker"));
  }

  int channels() const { return comps.size() == 1 ? 1 : 3; }

  // 'g'rey, 'y'cc, 'r'gb, 'c'myk or 'k' (ycck), as libjpeg-turbo's
  // default_decompress_parms decides
  char color_space() const {
    if (comps.size() == 1) return 'g';
    if (comps.size() == 4) return adobe < 0 || adobe == 0 ? 'c' : 'k';
    if (jfif) return 'y';
    if (adobe >= 0) return adobe == 0 ? 'r' : 'y';
    if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
      return 'r';
    return lossless ? 'r' : 'y';
  }

  // libjpeg-turbo's smoothing_ok at the output pass: every component has
  // its DC and the quantizers of its first ten coefficients, and the
  // scans leave one of the first nine AC coefficients of some component
  // incomplete (coef_bits: the Al of its last scan, -1 if none sent it)
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const auto& c : comps) {
      if (!qt_present[c.tq] || c.coef_bits[0] < 0) return false;
      for (int k = 0; k <= kSmoothedCoefs; ++k)
        if (qt[c.tq][kZigzag[k]] == 0) return false;
      for (int k = 1; k <= kSmoothedCoefs; ++k)
        useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data on component c's coefficients: in
  // each block of the image, a first AC coefficient still zero and not
  // known to be exact is estimated from the 5x5 DC values around the
  // block (kSmoothK), rounded and held under 2^Al; with no AC data at all
  // the DC is replaced by their weighted mean too. Rows and columns past
  // the edge repeat the last, as libjpeg's block-row pointers do: on the
  // last iMCU row counted in its own block rows, so a dummy row of the
  // padded grid can stand below a row above it.
  std::vector<int16_t> smoothed(const Component& c) const {
    std::vector<int16_t> out = c.coef;
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k <= kSmoothedCoefs; ++k) change_dc &= bits[k] == -1;
    const int64_t q00 = qt[c.tq][0];
    const int k0 = change_dc ? 0 : 1, k1 = change_dc ? 10 : 6;
    const int hib = (c.rows + 7) / 8, wib = (c.cols + 7) / 8;
    const int t = mcu_rows, v = c.v;
    for (int r = 0; r < hib; ++r) {
      const int block_rows = r / v < t - 1 ? v : hib - (t - 1) * v;
      const int ibr = r / v * block_rows + r % v, n = block_rows * t;
      int rows[5];
      rows[1] = ibr > 0 ? r - 1 : r;
      rows[0] = ibr > 1 ? r - 2 : rows[1];
      rows[2] = r;
      rows[3] = ibr < n - 1 ? r + 1 : r;
      rows[4] = ibr < n - 2 ? r + 2 : rows[3];
      for (int bx = 0; bx < wib; ++bx) {
        int dc[25];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) {
            const int x = std::min(std::max(bx + j - 2, 0), wib - 1);
            dc[i * 5 + j] = c.coef[(long(rows[i]) * c.bcols + x) * 64];
          }
        int16_t* blk = &out[(long(r) * c.bcols + bx) * 64];
        for (int k = k0; k < k1; ++k) {
          const int nat = kZigzag[k];
          if (k && (bits[k] == 0 || blk[nat] != 0)) continue;
          int64_t num = 0;
          for (int i = 0; i < 25; ++i)
            num += kSmoothK[change_dc][k][i] * dc[i];
          num *= q00;
          const int64_t qk = qt[c.tq][nat];
          int64_t pred = ((qk << 7) + (num < 0 ? -num : num)) / (qk << 8);
          if (k && bits[k] > 0 && pred >= (1 << bits[k]))
            pred = (1 << bits[k]) - 1;
          blk[nat] = s16(static_cast<int>(num < 0 ? -pred : pred));
        }
      }
    }
    return out;
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
// upsampling (jdsample.c), one output row at a time
// ---------------------------------------------------------------------------

// the horizontal triangle filter on (column sums) s[0..cols), cols > 1:
// output 2c is (3 s[c] + s[c-1] + bl) >> shift, 2c+1 is (3 s[c] + s[c+1]
// + br) >> shift, edges replicated; `out` holds 2 * cols values
inline void fancy_row(const int* s, int cols, int bl, int br, int shift,
                      uint8_t* out) {
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
  std::vector<uint8_t> samples;   // the component's samples, padded
  long stride = 0;
  int rows = 0, cols = 0, rh = 1, rv = 1;
  bool fancy = true;
  std::vector<int> sums;
  std::vector<uint8_t> row;       // one upsampled row

  // row y of the full-size (upsampled) component
  const uint8_t* get(int y) {
    if (rh == 1 && rv == 1) return &samples[y * stride];
    if (fancy && rh == 2 && rv == 1 && cols > 2) {
      const uint8_t* p = &samples[y * stride];
      for (int c = 0; c < cols; ++c) sums[c] = p[c];
      fancy_row(sums.data(), cols, 1, 2, 2, row.data());
      return row.data();
    }
    if (fancy && rh == 1 && rv == 2) {
      int i = y >> 1;
      int far = (y & 1) ? std::min(i + 1, rows - 1) : std::max(i - 1, 0);
      const int bias = (y & 1) ? 2 : 1;
      const uint8_t* p = &samples[i * stride];
      const uint8_t* q = &samples[far * stride];
      for (int c = 0; c < cols; ++c)
        row[c] = static_cast<uint8_t>((3 * p[c] + q[c] + bias) >> 2);
      return row.data();
    }
    if (fancy && rh == 2 && rv == 2 && cols > 2) {
      int i = y >> 1;
      int far = (y & 1) ? std::min(i + 1, rows - 1) : std::max(i - 1, 0);
      const uint8_t* p = &samples[i * stride];
      const uint8_t* q = &samples[far * stride];
      for (int c = 0; c < cols; ++c) sums[c] = 3 * p[c] + q[c];
      fancy_row(sums.data(), cols, 8, 7, 4, row.data());
      return row.data();
    }
    // box replication (h2v1/h2v2_upsample, int_upsample)
    const uint8_t* p = &samples[(y / rv) * stride];
    for (int c = 0; c < cols; ++c)
      std::memset(&row[static_cast<size_t>(c) * rh], p[c], rh);
    return row.data();
  }
};

inline int fix16(double x) { return static_cast<int>(x * 65536 + 0.5); }

void decode_all(Decoder& dec, uint8_t* out) {
  const int H = dec.height, W = dec.width;
  const char space = dec.color_space();
  if (dec.lossless && space != 'g' && space != 'r' && space != 'c')
    unsupported(space == 'k' ? "lossless YCCK" : "lossless YCbCr");
  const bool smooth = dec.smoothing_ok();
  std::vector<Plane> planes;
  for (auto& c : dec.comps) {
    Plane pl;
    if (dec.lossless) {
      if (c.samples.empty())
        fail("JPEG stream leaves a component without a scan");
      pl.samples = std::move(c.samples);
      pl.stride = c.cols;
    } else {
      if (!dec.qt_present[c.tq])
        fail("JPEG stream lacks a quantization table it uses");
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.brows) * c.bcols * 64, 0);
      if (smooth) c.coef = dec.smoothed(c);
      pl.stride = long(c.bcols) * 8;
      pl.samples.resize(static_cast<size_t>(c.brows) * 8 * pl.stride);
      for (int by = 0; by < c.brows; ++by)
        for (int bx = 0; bx < c.bcols; ++bx)
          idct_block(&c.coef[(long(by) * c.bcols + bx) * 64], dec.qt[c.tq],
                     &pl.samples[long(by) * 8 * pl.stride + bx * 8],
                     pl.stride);
    }
    pl.rows = c.rows;
    pl.cols = c.cols;
    pl.rh = dec.hmax / c.h;
    pl.rv = dec.vmax / c.v;
    pl.fancy = !dec.lossless;
    pl.sums.resize(c.cols);
    pl.row.resize(static_cast<size_t>(c.cols) * pl.rh + 2);
    planes.push_back(std::move(pl));
  }
  if (space == 'g') {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + long(y) * W, planes[0].get(y), W);
    return;
  }
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int x = i - 128;
    cr_r[i] = (fix16(1.40200) * x + 32768) >> 16;
    cb_b[i] = (fix16(1.77200) * x + 32768) >> 16;
    cr_g[i] = -fix16(0.71414) * x;
    cb_g[i] = -fix16(0.34414) * x + 32768;
  }
  for (int y = 0; y < H; ++y) {
    const uint8_t* A = planes[0].get(y);
    const uint8_t* B = planes[1].get(y);
    const uint8_t* C = planes[2].get(y);
    const uint8_t* K = planes.size() == 4 ? planes[3].get(y) : nullptr;
    uint8_t* o = out + long(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      int r, g, b;
      if (space == 'r') {
        r = A[x];
        g = B[x];
        b = C[x];
      } else if (space == 'c') {
        r = 255 - A[x];   // PIL's "CMYK;I": 255 - C, M, Y
        g = 255 - B[x];
        b = 255 - C[x];
      } else {
        int l = A[x], cb = B[x], cr = C[x];
        r = clamp8(l + cr_r[cr]);
        g = clamp8(l + ((cb_g[cb] + cr_g[cr]) >> 16));
        b = clamp8(l + cb_b[cb]);
      }
      if (K) {
        // PIL's cmyk2rgb: K - K * (255 - C) / 255, rounded as MULDIV255
        int nk = K[x];
        int t;
        t = r * nk + 128;
        r = nk - (((t >> 8) + t) >> 8);
        t = g * nk + 128;
        g = nk - (((t >> 8) + t) >> 8);
        t = b * nk + 128;
        b = nk - (((t >> 8) + t) >> 8);
      }
      o[3 * x] = clamp8(r);
      o[3 * x + 1] = clamp8(g);
      o[3 * x + 2] = clamp8(b);
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
