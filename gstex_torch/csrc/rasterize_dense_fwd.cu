// Training forward of the textured-surfel blend over the dense per-tile
// lists: ids (num_tiles, s_max) with per-tile counts.
//
// Replaces: gstex_tpu/ops/rasterize_pallas4.py, _fwd_kernel4 (launched by
// rasterize_pallas4_fwd). Computes what csrc/rasterize_fwd.cu computes for
// the flat list: img, tex, depth, alpha, the camera-facing normal, the 2DGS
// distortion reg, the backward's residuals t_final and m1 as fourteen
// (H, W) planes in CH_NAMES order, and ncontrib (H, W): the rank of the
// splat at which T would fall to T_EPS (not blended), else s_max. lean != 0
// skips the normal and reg chains; their planes are zero.
//
// The TPU kernel reads a pair-space record gather and a lane-packed chart
// table through an id window; none of that is carried over. This kernel
// reads TileBins.ids, the (N, 32) records and the (N, Ch, Cw, 3) charts as
// they are.
//
// What bounds it on the H100: operations, as for the flat kernel: ~40 fp32
// operations per (pixel, pair) response and ~90 per blend, against one
// 128 B record per pair per tile and four texels per blend.
//
// What the design does about it, and where it departs from the flat kernel:
// - One block per tile, 256 threads with 4 pixels each; a pixel's ray, T
//   and sums stay in registers; the tile leaves its walk once no in-image
//   pixel has T > T_EPS.
// - Only the records are staged in shared memory, 32 splats a chunk (4 KB,
//   whatever the chart pad). The flat kernel stages each splat's whole pad,
//   which is what fails for large charts and leaves one splat a chunk at
//   pads like (40, 80). Here a blend fetches its four texels from device
//   memory: the active texels of a scene sit in the 50 MB L2, and
//   neighbouring pixels fetch neighbouring texels.
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize.py:forward_scan) does, in the same
// per-pixel order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kRec = 32;
constexpr int kCam = 18;
constexpr int kChunk = 32;
constexpr float kTEps = 1e-4f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kExtent2 = 9.0f;
constexpr float kAaSigma2 = 0.5f;
constexpr float kRegNear = 0.2f;
constexpr float kInvRegNear = 5.0f;
constexpr float kKfac = static_cast<float>(100.0 / (100.0 - 0.2));

__global__ void __launch_bounds__(kThreads)
rasterize_dense_fwd_kernel(const float* __restrict__ records,
                           const int* __restrict__ ids,
                           const int* __restrict__ counts,
                           const float* __restrict__ charts,
                           const float* __restrict__ cam_info,
                           float* __restrict__ out,
                           int* __restrict__ ncontrib, int ntx, int tile_h,
                           int tile_w, int height, int width, int ch, int cw,
                           int s_max, int lean) {
  __shared__ float s_rec[kChunk * kRec];
  __shared__ int s_id[kChunk];
  __shared__ float cam[kCam];
  const long long chw3 = static_cast<long long>(ch) * cw * 3;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kCam) cam[tid] = cam_info[tid];
  __syncthreads();

  const int* tile_ids = ids + static_cast<long long>(tile) * s_max;
  const int count = min(counts[tile], s_max);
  const int pix = tile_h * tile_w;
  const int tx = tile % ntx;
  const int ty = tile / ntx;

  float gx[kPixPerThread], gy[kPixPerThread];
  float d0[kPixPerThread], d1[kPixPerThread], d2[kPixPerThread];
  float T[kPixPerThread], t_fin[kPixPerThread];
  // img(3) tex(3) depth alpha normal(3) reg m1
  float acc[13][kPixPerThread];
  int ncon[kPixPerThread];
  bool inside[kPixPerThread];
  bool alive = false;
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int p = tid + j * kThreads;
    const int ix = tx * tile_w + p % tile_w;
    const int iy = ty * tile_h + p / tile_w;
    inside[j] = p < pix && ix < width && iy < height;
    gx[j] = static_cast<float>(ix) + cam[4];
    gy[j] = static_cast<float>(iy) + cam[5];
    const float dx = (gx[j] + 0.5f - cam[2]) / cam[0];
    const float dy = (gy[j] + 0.5f - cam[3]) / cam[1];
    d0[j] = cam[9] * dx + cam[10] * dy + cam[11];
    d1[j] = cam[12] * dx + cam[13] * dy + cam[14];
    d2[j] = cam[15] * dx + cam[16] * dy + cam[17];
    T[j] = 1.0f;
    t_fin[j] = 1.0f;
    ncon[j] = s_max;
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c][j] = 0.0f;
    alive = alive || inside[j];
  }

  for (int base = 0; base < count; base += kChunk) {
    // also keeps the previous chunk's readers ahead of this chunk's writes
    if (!__syncthreads_or(alive)) break;
    const int n = min(kChunk, count - base);
    if (tid < n) s_id[tid] = tile_ids[base + tid];
    __syncthreads();
    for (int i = tid; i < n * kRec; i += kThreads) {
      const int s = i / kRec;
      s_rec[i] = records[static_cast<long long>(s_id[s]) * kRec + (i - s * kRec)];
    }
    __syncthreads();

    for (int s = 0; s < n; ++s) {
      const float* r = s_rec + s * kRec;
      const float* chart = charts + static_cast<long long>(s_id[s]) * chw3;
#pragma unroll
      for (int j = 0; j < kPixPerThread; ++j) {
        if (!inside[j] || !(T[j] > kTEps)) continue;
        const float nd = r[0] * d0[j] + r[1] * d1[j] + r[2] * d2[j];
        const float safe_nd =
            fabsf(nd) < 1e-9f ? (nd < 0.0f ? -1e-9f : 1e-9f) : nd;
        const float t = r[3] / safe_nd;
        const float b1d = r[4] * d0[j] + r[5] * d1[j] + r[6] * d2[j];
        const float b2d = r[8] * d0[j] + r[9] * d1[j] + r[10] * d2[j];
        const float u = r[7] + t * b1d;
        const float v = r[11] + t * b2d;
        const float r2 = u * u + v * v;
        const float arg_s = r2 <= kExtent2 ? -0.5f * r2 : -1e30f;
        const float dpx = gx[j] - r[24];
        const float dpy = gy[j] - r[25];
        const float arg_c = (-0.5f / kAaSigma2) * (dpx * dpx + dpy * dpy);
        const float g = expf(fmaxf(arg_s, arg_c));
        float alpha = fminf(r[20] * g, kAlphaClamp);
        if (alpha < kAlphaCutoff || !(t > 1e-6f)) alpha = 0.0f;
        if (!(alpha > 0.0f)) continue;  // T * (1 - 0) == T, weight 0

        const float t_new = T[j] * (1.0f - alpha);
        if (t_new > kTEps) {
          const float w = alpha * T[j];
          const float b1ud = r[12] * d0[j] + r[13] * d1[j] + r[14] * d2[j];
          const float b2ud = r[16] * d0[j] + r[17] * d1[j] + r[18] * d2[j];
          const float uvu = fminf(fmaxf(0.5f + r[15] + t * b1ud, 0.0f), 1.0f);
          const float uvv = fminf(fmaxf(0.5f + r[19] + t * b2ud, 0.0f), 1.0f);
          const float hf = r[26];
          const float wf = r[27];
          const float xf = fminf(fmaxf(uvu * hf, 0.0f), hf - 1.0f);
          const float yf = fminf(fmaxf(uvv * wf, 0.0f), wf - 1.0f);
          const float x0 = floorf(xf);
          const float y0 = floorf(yf);
          const float fx = xf - x0;
          const float fy = yf - y0;
          const int x0i = static_cast<int>(x0);
          const int y0i = static_cast<int>(y0);
          const int x1i = min(x0i + 1, static_cast<int>(hf) - 1);
          const int y1i = min(y0i + 1, static_cast<int>(wf) - 1);
          const float* c00 = chart + (x0i * cw + y0i) * 3;
          const float* c01 = chart + (x0i * cw + y1i) * 3;
          const float* c10 = chart + (x1i * cw + y0i) * 3;
          const float* c11 = chart + (x1i * cw + y1i) * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float tex =
                (1.0f - fx) * ((1.0f - fy) * __ldg(c00 + c) + fy * __ldg(c01 + c))
                + fx * ((1.0f - fy) * __ldg(c10 + c) + fy * __ldg(c11 + c));
            acc[c][j] = acc[c][j] + w * r[21 + c];
            acc[3 + c][j] = acc[3 + c][j] + w * tex;
          }
          acc[6][j] = acc[6][j] + w * t;
          if (!lean) {
            const float inv_t = safe_nd * (1.0f / r[3]);
            const float invtc = t >= kRegNear ? inv_t : kInvRegNear;
            const float m = kKfac * (1.0f - kRegNear * invtc);
            const float wfl = w * (nd > 0.0f ? -1.0f : 1.0f);
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[8 + c][j] = acc[8 + c][j] + r[c] * wfl;
            acc[11][j] = acc[11][j] + 2.0f * w * (m * acc[7][j] - acc[12][j]);
            acc[12][j] = acc[12][j] + w * m;
          }
          acc[7][j] = acc[7][j] + w;
          t_fin[j] = t_new;
        } else {
          ncon[j] = base + s;  // the break splat: not blended
        }
        T[j] = t_new;
      }
    }
    alive = false;
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j)
      alive = alive || (inside[j] && T[j] > kTEps);
  }

  const long long plane = static_cast<long long>(height) * width;
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    if (!inside[j]) continue;
    const int p = tid + j * kThreads;
    const long long o = static_cast<long long>(ty * tile_h + p / tile_w) * width
                        + tx * tile_w + p % tile_w;
#pragma unroll
    for (int c = 0; c < 12; ++c) out[c * plane + o] = acc[c][j];
    out[12 * plane + o] = t_fin[j];
    out[13 * plane + o] = acc[12][j];
    ncontrib[o] = ncon[j];
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_dense_fwd(
    const void* records, const void* ids, const void* counts,
    const void* charts, const void* cam_info, void* out, void* ncontrib,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  if (num_tiles == 0) return 0;
  rasterize_dense_fwd_kernel<<<num_tiles, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(ids),
      static_cast<const int*>(counts), static_cast<const float*>(charts),
      static_cast<const float*>(cam_info), static_cast<float*>(out),
      static_cast<int*>(ncontrib), ntx, tile_h, tile_w, height, width, ch, cw,
      s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
