// Backward of the chunk-scan training forward (csrc/rasterize_v3_fwd.cu):
// chunks of 16 slots back to front, the transmittance before each slot
// recovered by a suffix product scan across the chunk, pair-space
// gradients out.
//
// Replaces: gstex_tpu/ops/rasterize_pallas3.py, _bwd_kernel3 (launched by
// rasterize_pallas3_bwd). Per pixel and chunk, with t_end the transmittance
// after the chunk (t_final for the last chunk walked) and q_j = 1 - alpha_j
// where slot j is applied (alpha_j > 0, j < ncontrib), else 1:
//   T_k = t_end / prod_{j>=k} q_j,  w_k = alpha_k * T_k
//   E_k, D_k, Bs_k = carried sums + exclusive suffix sums of w, w*m, s*w
//   dL/dalpha_k = T_k * s_k - Bs_k / (1 - alpha_k)
// then the chain rule of the other tiers to record fields 0-11, 15, 19-25
// of slot (t, k), written into d_records_t (T, S, 32), and to the texels
// of its bilinear fetch, written into d_charts_g (T, S, Ch, Cw, 3). Fields
// 12-14, 16-18 (the detached uv frame) get none. The reduction to
// per-gaussian gradients is autograd's, through the gathers that made the
// pair-space inputs.
//
// What the TPU kernel does that is not carried over: its layout and its
// matmuls (texel fetch and chart gradient against hat weights, the record
// gradients assembled with one-hot lane masks). What is: the chunk of 16,
// the suffix scans in the order of _sufprod_incl and _sufsum_excl (strides
// 1, 2, 4, 8), T_k by division, and the carries from chunk to chunk.
//
// What bounds it on the H100: operations (~300 fp32 operations per applied
// (pixel, slot), ~60 per evaluated one with the scans). Bytes: a record
// read and a record gradient written per slot, a slot's chart read and its
// gradient written once per slot.
//
// The design:
// - One block per tile (32 x 32 pixels), 256 threads as 16 half-warps;
//   lane k of a half-warp holds slot base + k: its record in registers,
//   its response, fetch and chain rule at the half-warp's current pixel,
//   and its record gradient summed in registers over the pixels the
//   half-warp walks.
// - The scans are __shfl_down_sync with width 16. The tile's 12 cotangent
//   planes, its alpha and m1 maps, and each pixel's carries (t_end, Bs, E,
//   D) and ncontrib sit in shared memory (76 KB).
// - Record gradients: the two half-warps of a warp are added by a shuffle,
//   the 8 warps in a fixed order through shared memory, and each slot's
//   fields are stored once. Chart gradients: where the chunk's 16 fit
//   beside the planes (16 * Ch * Cw * 12 bytes; 74 KB at (16, 24)) they
//   are summed in shared memory with shared atomics and stored once; above
//   that they are added into each slot's own region of d_charts_g. Every
//   slot belongs to one tile, so no global memory is written by two blocks.
// - The fetch is the forward's 2 x 2 bilinear form with a two-sided
//   derivative where a sample sits exactly on a texel: the TPU kernel's
//   hat-function form.
//
// Precision: no --use_fast_math and --fmad=false. The plain version
// (ops/rasterize_v3.py:rasterize_v3_bwd_reference) runs the same scans and
// divisions; it writes the fetch in its 3 x 3 hat-function form and sums
// over pixels in another order, so the two agree to rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // slots a chunk: one per lane of a half-warp
constexpr int kGroups = kThreads / kChunk;
constexpr int kRec = 32;
constexpr int kUsed = 28;
constexpr int kCam = 18;
// per-pixel shared planes: 12 cotangents, alpha, m1, t_end, Bs, E, D;
// then ncontrib
constexpr int kPlanes = 18;
constexpr int kFields = 20;  // record fields with a gradient
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemMax = 227 * 1024;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kExtent2 = 9.0f;
constexpr float kAaSigma2 = 0.5f;
constexpr float kRegNear = 0.2f;
constexpr float kInvRegNear = 5.0f;
constexpr float kKfac = static_cast<float>(100.0 / (100.0 - 0.2));
constexpr float kKfacNear = static_cast<float>(100.0 / (100.0 - 0.2) * 0.2);

// record field of each of the kFields gradient slots
__constant__ int kFieldOf[kFields] = {0,  1,  2,  3,  4,  5,  6,
                                      7,  8,  9,  10, 11, 15, 19,
                                      20, 21, 22, 23, 24, 25};

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = kChunk / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off, kChunk);
  return x;
}

// inclusive suffix product over the half-warp, strides 1, 2, 4, 8
// (rasterize_pallas3._sufprod_incl)
__device__ __forceinline__ float sufprod_incl(float q, int k) {
#pragma unroll
  for (int s = 1; s < kChunk; s <<= 1) {
    const float dn = __shfl_down_sync(kFull, q, s, kChunk);
    if (k < kChunk - s) q = q * dn;
  }
  return q;
}

// exclusive suffix sum over the half-warp: a shift by one, then strides
// 1, 2, 4, 8 (rasterize_pallas3._sufsum_excl)
__device__ __forceinline__ float sufsum_excl(float x, int k) {
  const float next = __shfl_down_sync(kFull, x, 1, kChunk);
  x = k < kChunk - 1 ? next : 0.0f;
#pragma unroll
  for (int s = 1; s < kChunk; s <<= 1) {
    const float dn = __shfl_down_sync(kFull, x, s, kChunk);
    if (k < kChunk - s) x = x + dn;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
rasterize_v3_bwd_kernel(const float* __restrict__ records_t,
                        const float* __restrict__ charts_g,
                        const int* __restrict__ counts,
                        const float* __restrict__ cam_info,
                        const float* __restrict__ maps,
                        const int* __restrict__ ncontrib,
                        const float* __restrict__ gmaps,
                        float* __restrict__ d_records_t,
                        float* __restrict__ d_charts_g, int ntx, int tile_h,
                        int tile_w, int height, int width, int ch, int cw,
                        int s_max, int lean, int stage) {
  // kPlanes * pix floats, pix ints, then (stage) the chunk's chart grads
  extern __shared__ float s_pl[];
  __shared__ float s_part[kWarps][kChunk][kFields];
  __shared__ float cam[kCam];
  __shared__ int s_top;
  const int pix = tile_h * tile_w;
  int* s_ncon = reinterpret_cast<int*>(s_pl + kPlanes * pix);
  float* s_dch = s_pl + (kPlanes + 1) * pix;
  const long long chw3 = static_cast<long long>(ch) * cw * 3;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k = tid & (kChunk - 1);  // this lane's slot in a chunk
  const int group = tid / kChunk;
  const int tx0 = (tile % ntx) * tile_w;
  const int ty0 = (tile / ntx) * tile_h;
  const long long plane = static_cast<long long>(height) * width;
  if (tid < kCam) cam[tid] = cam_info[tid];
  if (tid == 0) s_top = -1;
  __syncthreads();

  int top = -1;
  for (int p = tid; p < pix; p += kThreads) {
    const int ix = tx0 + p % tile_w;
    const int iy = ty0 + p / tile_w;
    const bool inside = ix < width && iy < height;
    const long long o = static_cast<long long>(iy) * width + ix;
#pragma unroll
    for (int c = 0; c < 12; ++c)
      s_pl[c * pix + p] = inside ? gmaps[c * plane + o] : 0.0f;
    s_pl[12 * pix + p] = inside ? maps[7 * plane + o] : 0.0f;
    s_pl[13 * pix + p] = inside ? maps[13 * plane + o] : 0.0f;
    s_pl[14 * pix + p] = inside ? maps[12 * plane + o] : 1.0f;  // t_end
    s_pl[15 * pix + p] = 0.0f;  // Bs
    s_pl[16 * pix + p] = 0.0f;  // E
    s_pl[17 * pix + p] = 0.0f;  // D
    s_ncon[p] = inside ? ncontrib[o] : 0;
    if (inside) top = max(top, s_ncon[p]);
  }
  if (top >= 0) atomicMax(&s_top, top);
  __syncthreads();

  const long long slot0 = static_cast<long long>(tile) * s_max;
  const int walk = min(min(counts[tile], s_max), s_top + 1);
  for (int base = ((walk - 1) / kChunk) * kChunk; base >= 0 && walk > 0;
       base -= kChunk) {
    const int n = min(kChunk, walk - base);
    const int slot = base + k;
    const bool valid = slot < walk;
    const long long row = slot0 + min(slot, s_max - 1);
    float r[kUsed];
#pragma unroll
    for (int f = 0; f < kUsed; ++f) r[f] = __ldg(records_t + row * kRec + f);
    const float* chart = charts_g + row * chw3;
    // the slot's chart gradient: staged, or in its own region of d_charts_g
    float* dch = stage ? s_dch + k * chw3 : d_charts_g + row * chw3;
    if (stage)
      for (long long i = tid; i < n * chw3; i += kThreads) s_dch[i] = 0.0f;
    __syncthreads();

    float v[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f) v[f] = 0.0f;
    for (int p = group; p < pix; p += kGroups) {
      const int ix = tx0 + p % tile_w;
      const int iy = ty0 + p / tile_w;
      const int ncon = s_ncon[p];
      // no slot of this chunk is applied at a pixel that broke before it
      const bool live = ix < width && iy < height && base < ncon;
      if (!__any_sync(kFull, live)) continue;

      const float gx = static_cast<float>(ix) + cam[4];
      const float gy = static_cast<float>(iy) + cam[5];
      const float dx = (gx + 0.5f - cam[2]) / cam[0];
      const float dy = (gy + 0.5f - cam[3]) / cam[1];
      const float d0 = cam[9] * dx + cam[10] * dy + cam[11];
      const float d1 = cam[12] * dx + cam[13] * dy + cam[14];
      const float d2 = cam[15] * dx + cam[16] * dy + cam[17];
      const float nd = r[0] * d0 + r[1] * d1 + r[2] * d2;
      const float safe_nd =
          fabsf(nd) < 1e-9f ? (nd < 0.0f ? -1e-9f : 1e-9f) : nd;
      const float t = r[3] / safe_nd;
      const float b1d = r[4] * d0 + r[5] * d1 + r[6] * d2;
      const float b2d = r[8] * d0 + r[9] * d1 + r[10] * d2;
      const float u = r[7] + t * b1d;
      const float v_ = r[11] + t * b2d;
      const float r2 = u * u + v_ * v_;
      const float arg_s = r2 <= kExtent2 ? -0.5f * r2 : -1e30f;
      const float dpx = gx - r[24];
      const float dpy = gy - r[25];
      const float arg_c = (-0.5f / kAaSigma2) * (dpx * dpx + dpy * dpy);
      const float g = expf(fmaxf(arg_s, arg_c));
      const float opg = r[20] * g;
      float alpha = fminf(opg, kAlphaClamp);
      if (alpha < kAlphaCutoff || !(t > 1e-6f) || !valid) alpha = 0.0f;
      const bool applied = live && alpha > 0.0f && slot < ncon;

      // T before each slot, from the chunk's end: suffix product scan
      const float one_minus = 1.0f - alpha;
      const float s_incl = sufprod_incl(applied ? one_minus : 1.0f, k);
      const float* gp = s_pl + p;  // plane c at gp[c * pix]
      const float t_end = gp[14 * pix];
      const float t_k = t_end / s_incl;
      const float w = applied ? alpha * t_k : 0.0f;
      const float g_reg = gp[11 * pix];
      float m = 0.0f, invtc = 0.0f, wm = 0.0f, e_k = 0.0f, d_k = 0.0f,
            big_a = 0.0f, big_c = 0.0f, d_m = 0.0f;
      if (!lean) {
        const float inv_t = safe_nd * (1.0f / r[3]);
        invtc = t >= kRegNear ? inv_t : kInvRegNear;
        m = kKfac * (1.0f - kRegNear * invtc);
        wm = w * m;
        e_k = gp[16 * pix] + sufsum_excl(w, k);
        d_k = gp[17 * pix] + sufsum_excl(wm, k);
        big_a = gp[12 * pix] - w - e_k;
        big_c = gp[13 * pix] - wm - d_k;
        d_m = 2.0f * g_reg * w * (big_a - e_k);
      }

      float s_k = 0.0f, d_x = 0.0f, d_y = 0.0f, uvu_raw = 0.0f,
            uvv_raw = 0.0f, b1ud = 0.0f, b2ud = 0.0f, hf = 0.0f, wf = 0.0f;
      const float fl = nd > 0.0f ? -1.0f : 1.0f;
      if (applied) {
        // texels: the forward's four, and the fetch's derivatives
        b1ud = r[12] * d0 + r[13] * d1 + r[14] * d2;
        b2ud = r[16] * d0 + r[17] * d1 + r[18] * d2;
        uvu_raw = 0.5f + r[15] + t * b1ud;
        uvv_raw = 0.5f + r[19] + t * b2ud;
        hf = r[26];
        wf = r[27];
        const float x_raw = fminf(fmaxf(uvu_raw, 0.0f), 1.0f) * hf;
        const float y_raw = fminf(fmaxf(uvv_raw, 0.0f), 1.0f) * wf;
        const float xg = fminf(fmaxf(x_raw, 0.0f), hf - 1.0f);
        const float yg = fminf(fmaxf(y_raw, 0.0f), wf - 1.0f);
        const float x0 = floorf(xg);
        const float y0 = floorf(yg);
        const float fx = xg - x0;
        const float fy = yg - y0;
        const int x0i = static_cast<int>(x0);
        const int y0i = static_cast<int>(y0);
        const int x1i = min(x0i + 1, static_cast<int>(hf) - 1);
        const int y1i = min(y0i + 1, static_cast<int>(wf) - 1);
        const int o00 = (x0i * cw + y0i) * 3, o01 = (x0i * cw + y1i) * 3;
        const int o10 = (x1i * cw + y0i) * 3, o11 = (x1i * cw + y1i) * 3;
        const float gt[3] = {gp[3 * pix], gp[4 * pix], gp[5 * pix]};
        float texk[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float c00 = __ldg(chart + o00 + c), c01 = __ldg(chart + o01 + c);
          const float c10 = __ldg(chart + o10 + c), c11 = __ldg(chart + o11 + c);
          const float row0 = (1.0f - fy) * c00 + fy * c01;
          const float row1 = (1.0f - fy) * c10 + fy * c11;
          texk[c] = (1.0f - fx) * row0 + fx * row1;
          d_x = d_x + gt[c] * (row1 - row0);
          d_y = d_y + gt[c] * ((1.0f - fx) * (c01 - c00) + fx * (c11 - c10));
          const float wg = w * gt[c];
          const float v00 = wg * ((1.0f - fx) * (1.0f - fy));
          const float v01 = wg * ((1.0f - fx) * fy);
          const float v10 = wg * (fx * (1.0f - fy));
          const float v11 = wg * (fx * fy);
          if (v00 != 0.0f) atomicAdd(dch + o00 + c, v00);
          if (v01 != 0.0f) atomicAdd(dch + o01 + c, v01);
          if (v10 != 0.0f) atomicAdd(dch + o10 + c, v10);
          if (v11 != 0.0f) atomicAdd(dch + o11 + c, v11);
        }
        // a sample exactly on a texel row or column: the hat weights'
        // derivative is two-sided there, one texel each way, and texels
        // outside the padded chart read as zero
        if (fx == 0.0f || fy == 0.0f) {
          const auto texel = [&](int rw, int cl, int c) {
            return (rw >= 0 && rw < ch && cl >= 0 && cl < cw)
                       ? __ldg(chart + (rw * cw + cl) * 3 + c)
                       : 0.0f;
          };
          if (fx == 0.0f) {
            d_x = 0.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float up = (1.0f - fy) * texel(x0i + 1, y0i, c) +
                               fy * texel(x0i + 1, y0i + 1, c);
              const float down = (1.0f - fy) * texel(x0i - 1, y0i, c) +
                                 fy * texel(x0i - 1, y0i + 1, c);
              d_x = d_x + gt[c] * (up - down);
            }
          }
          if (fy == 0.0f) {
            d_y = 0.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float right = (1.0f - fx) * texel(x0i, y0i + 1, c) +
                                  fx * texel(x0i + 1, y0i + 1, c);
              const float left = (1.0f - fx) * texel(x0i, y0i - 1, c) +
                                 fx * texel(x0i + 1, y0i - 1, c);
              d_y = d_y + gt[c] * (right - left);
            }
          }
        }
        d_x = w * d_x;
        d_y = w * d_y;
        if (!(x_raw >= 0.0f && x_raw <= hf - 1.0f)) d_x = 0.0f;
        if (!(y_raw >= 0.0f && y_raw <= wf - 1.0f)) d_y = 0.0f;

        s_k = r[21] * gp[0] + r[22] * gp[pix] + r[23] * gp[2 * pix] +
              texk[0] * gt[0] + texk[1] * gt[1] + texk[2] * gt[2] +
              t * gp[6 * pix] + gp[7 * pix];
        if (!lean) {
          s_k = s_k + fl * (r[0] * gp[8 * pix] + r[1] * gp[9 * pix] +
                            r[2] * gp[10 * pix]);
          s_k = s_k + 2.0f * g_reg * ((m * big_a - big_c) + (d_k - m * e_k));
        }
      }
      const float sw = s_k * w;
      const float bs_k = gp[15 * pix] + sufsum_excl(sw, k);

      if (applied) {
        const float d_alpha = t_k * s_k - bs_k / one_minus;
        const bool interior =
            opg <= kAlphaClamp && opg >= kAlphaCutoff && t > 1e-6f;
        const float dag = interior ? d_alpha : 0.0f;
        const float d_op = g * dag;
        const float d_g = r[20] * d_op;
        const bool surf = arg_s >= arg_c;
        const float dgs = surf ? d_g : 0.0f;
        const float d_u = -u * dgs;
        const float d_v = -v_ * dgs;
        const float dgc = surf ? 0.0f : d_g;
        const float d_xy0 = ((1.0f / kAaSigma2) * dpx) * dgc;
        const float d_xy1 = ((1.0f / kAaSigma2) * dpy) * dgc;
        const float d_uvu =
            (uvu_raw >= 0.0f && uvu_raw <= 1.0f) ? d_x * hf : 0.0f;
        const float d_uvv =
            (uvv_raw >= 0.0f && uvv_raw <= 1.0f) ? d_y * wf : 0.0f;
        float d_t = w * gp[6 * pix];
        if (!lean)
          d_t = d_t + (t >= kRegNear ? d_m * kKfacNear * invtc * invtc : 0.0f);
        d_t = d_t + d_u * b1d + d_v * b2d;
        d_t = d_t + d_uvu * b1ud + d_uvv * b2ud;
        const float d_an = d_t * (1.0f / safe_nd);
        const float d_nd = fabsf(nd) >= 1e-9f ? -t * d_an : 0.0f;

        float n0 = d_nd * d0, n1 = d_nd * d1, n2 = d_nd * d2;
        if (!lean) {
          const float wfl = w * fl;
          n0 = n0 + wfl * gp[8 * pix];
          n1 = n1 + wfl * gp[9 * pix];
          n2 = n2 + wfl * gp[10 * pix];
        }
        v[0] += n0;
        v[1] += n1;
        v[2] += n2;
        v[3] += d_an;
        v[4] += d_u * (t * d0);
        v[5] += d_u * (t * d1);
        v[6] += d_u * (t * d2);
        v[7] += d_u;
        v[8] += d_v * (t * d0);
        v[9] += d_v * (t * d1);
        v[10] += d_v * (t * d2);
        v[11] += d_v;
        v[12] += d_uvu;
        v[13] += d_uvv;
        v[14] += d_op;
        v[15] += w * gp[0];
        v[16] += w * gp[pix];
        v[17] += w * gp[2 * pix];
        v[18] += d_xy0;
        v[19] += d_xy1;
      }

      // the carries into the chunk before this one
      const float s_first = __shfl_sync(kFull, s_incl, 0, kChunk);
      const float sum_sw = half_sum(sw);
      float sum_w = 0.0f, sum_wm = 0.0f;
      if (!lean) {
        sum_w = half_sum(w);
        sum_wm = half_sum(wm);
      }
      if (k == 0 && live) {
        s_pl[14 * pix + p] = t_end / s_first;
        s_pl[15 * pix + p] = s_pl[15 * pix + p] + sum_sw;
        if (!lean) {
          s_pl[16 * pix + p] = s_pl[16 * pix + p] + sum_w;
          s_pl[17 * pix + p] = s_pl[17 * pix + p] + sum_wm;
        }
      }
    }

    // record gradients: the two half-warps of a warp, then the warps in
    // order, one plain store per slot and field
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      v[f] += __shfl_xor_sync(kFull, v[f], kChunk);
      if (lane < kChunk) s_part[tid / 32][k][f] = v[f];
    }
    __syncthreads();
    for (int i = tid; i < n * kFields; i += kThreads) {
      const int s = i / kFields;
      const int f = i - s * kFields;
      float x = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) x += s_part[wp][s][f];
      d_records_t[(slot0 + base + s) * kRec + kFieldOf[f]] = x;
    }
    if (stage)
      for (long long i = tid; i < n * chw3; i += kThreads)
        d_charts_g[(slot0 + base) * chw3 + i] = s_dch[i];
    __syncthreads();
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; d_records_t and
// d_charts_g must be zeroed; `stream` is a cudaStream_t. Tiles must hold a
// multiple of 16 pixels (the wrapper takes 32 x 32). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_v3_bwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, const void* maps, const void* ncontrib,
    const void* gmaps, void* d_records_t, void* d_charts_g, int num_tiles,
    int ntx, int tile_h, int tile_w, int height, int width, int ch, int cw,
    int s_max, int lean, void* stream) {
  const size_t planes =
      static_cast<size_t>(kPlanes + 1) * tile_h * tile_w * sizeof(float);
  const size_t staged =
      static_cast<size_t>(kChunk) * ch * cw * 3 * sizeof(float);
  const size_t fixed = sizeof(float) * (kWarps * kChunk * kFields + kCam) + 64;
  const int stage = planes + staged + fixed <= kSmemMax;
  const size_t smem = planes + (stage ? staged : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_v3_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_v3_bwd_kernel<<<num_tiles, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records_t),
      static_cast<const float*>(charts_g), static_cast<const int*>(counts),
      static_cast<const float*>(cam_info), static_cast<const float*>(maps),
      static_cast<const int*>(ncontrib), static_cast<const float*>(gmaps),
      static_cast<float*>(d_records_t), static_cast<float*>(d_charts_g), ntx,
      tile_h, tile_w, height, width, ch, cw, s_max, lean, stage);
  return static_cast<int>(cudaGetLastError());
}
