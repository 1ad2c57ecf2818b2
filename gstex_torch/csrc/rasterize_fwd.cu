// Training forward of the textured-surfel blend over the flat (tile, depth,
// id) pair list.
//
// Replaces: gstex_tpu/ops/rasterize_pallas5.py, _fwd_kernel5 (launched by
// rasterize_pallas5_fwd). Computes the eval blend of csrc/rasterize_eval.cu
// (img, tex, depth, alpha) plus the camera-facing normal n * flip, the 2DGS
// distortion reg = sum_k 2 w_k (m_k A_k - M_k) (A_k, M_k: the sums of w and
// w m over the splats in front), and the backward's residuals: t_final (T
// after the last applied splat), m1 = sum w m, and ncontrib, the rank of
// the splat at which T would fall to T_EPS (not blended), else s_cap.
// Writes fourteen (H, W) planes in CH_NAMES order and ncontrib (H, W).
// lean != 0 skips the normal and reg chains; their planes are zero.
//
// What bounds it on the H100: operations, as for the eval kernel. Each
// (pixel, pair) response costs ~40 fp32 operations and each blend ~90 (the
// eval blend plus normal, m and reg), against one record and one chart read
// per pair per tile, shared by the tile's 1024 pixels.
//
// The design is the eval kernel's: one block per tile, 256 threads with 4
// pixels each, chunks of records and charts staged in shared memory (only
// each chart's active h x w texels: scene-sized pads are mostly padding),
// and the tile leaves its walk once no in-image pixel has T > T_EPS. That
// leaves ncontrib equal to the TPU kernel's in every in-image pixel (a
// pixel's break rank does not depend on the walk's length); out-of-image
// pixels are not walked and not written.
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize_fwd.py) does, in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kRec = 32;
constexpr int kCam = 18;
constexpr float kTEps = 1e-4f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kExtent2 = 9.0f;
constexpr float kAaSigma2 = 0.5f;
constexpr float kRegNear = 0.2f;
constexpr float kInvRegNear = 5.0f;
constexpr float kKfac = static_cast<float>(100.0 / (100.0 - 0.2));

__global__ void __launch_bounds__(kThreads)
rasterize_fwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ gids,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const float* __restrict__ charts,
                     const float* __restrict__ cam_info,
                     float* __restrict__ out, int* __restrict__ ncontrib,
                     int ntx, int tile_h, int tile_w, int height, int width,
                     int ch, int cw, int s_cap, int chunk, int lean) {
  extern __shared__ float smem[];
  __shared__ float cam[kCam];
  float* s_rec = smem;
  float* s_chart = smem + chunk * kRec;
  const int chw3 = ch * cw * 3;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kCam) cam[tid] = cam_info[tid];
  __syncthreads();

  const int start = starts[tile];
  const int count = min(counts[tile], s_cap);
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
    ncon[j] = s_cap;
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c][j] = 0.0f;
    alive = alive || inside[j];
  }

  for (int base = 0; base < count; base += chunk) {
    if (!__syncthreads_or(alive)) break;
    const int n = min(chunk, count - base);
    const int* ids = gids + start + base;
    for (int i = tid; i < n * kRec; i += kThreads) {
      const int s = i / kRec;
      s_rec[i] = records[static_cast<long long>(ids[s]) * kRec + (i - s * kRec)];
    }
    __syncthreads();
    // only the active h x w texels of each chart are read
    for (int i = tid; i < n * chw3; i += kThreads) {
      const int s = i / chw3;
      const int e = i - s * chw3;
      if (e / (cw * 3) < s_rec[s * kRec + 26] && (e / 3) % cw < s_rec[s * kRec + 27])
        s_chart[i] = charts[static_cast<long long>(ids[s]) * chw3 + e];
    }
    __syncthreads();

    for (int s = 0; s < n; ++s) {
      const float* r = s_rec + s * kRec;
      const float* chart = s_chart + s * chw3;
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
            const float tex = (1.0f - fx) * ((1.0f - fy) * c00[c] + fy * c01[c])
                              + fx * ((1.0f - fy) * c10[c] + fy * c11[c]);
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
extern "C" int gstex_rasterize_fwd(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info, void* out,
    void* ncontrib, int num_tiles, int ntx, int tile_h, int tile_w,
    int height, int width, int ch, int cw, int s_cap, int chunk, int lean,
    void* stream) {
  const size_t smem =
      static_cast<size_t>(chunk) * (kRec + ch * cw * 3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_fwd_kernel<<<num_tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(gids),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(charts), static_cast<const float*>(cam_info),
      static_cast<float*>(out), static_cast<int*>(ncontrib), ntx, tile_h,
      tile_w, height, width, ch, cw, s_cap, chunk, lean);
  return static_cast<int>(cudaGetLastError());
}
