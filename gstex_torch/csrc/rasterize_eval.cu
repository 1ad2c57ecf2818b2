// Forward-only textured-surfel blend over the flat (tile, depth, id) pair
// list: the eval/serving render of GStex.
//
// Replaces: gstex_tpu/ops/rasterize_pallas5.py, _eval_kernel5 (launched by
// rasterize_pallas5_eval). Computes the same function: for each pixel, walk
// the tile's splats front to back; ray–surfel-plane hit, Gaussian falloff
// max'd with the 2DGS screen low-pass (sigma^2 = 0.5), alpha = min(o*G,
// 0.999) with the 1/255 cutoff and t > 1e-6, a 4-texel bilinear fetch from
// the splat's chart, and the transmittance break at T_EPS. Writes img(3),
// tex(3), depth and alpha as eight (H, W) planes.
//
// What bounds it on the H100: operations. Each (pixel, pair) costs ~100
// fp32 operations (5 three-term dots, a true division, an expf, the blend
// and a 12-value bilinear fetch) against 896 bytes per pair (a 128 B record
// and a 768 B (8,8) chart) shared by the tile's 1024 pixels, so the tile
// does ~100 K operations per 896 B read: far above the card's ~20 fp32
// operations per byte. Time goes into the CUDA cores, not memory.
//
// What the design does about it:
// - One block per tile, 256 threads with 4 pixels each (1024 threads would
//   leave at most 64 registers a thread). Pixels keep their ray, T and the
//   eight sums in registers for the whole walk.
// - The tile's splats are staged in chunks: the block loads the chunk's
//   records and charts into shared memory once, and every pixel then reads
//   them from there, so each pair's bytes leave device memory once per tile.
// - Per-pixel work is skipped where it cannot contribute: pixels already at
//   T <= T_EPS, and splats with alpha == 0 skip the texel fetch.
// - The tile leaves its walk as soon as no pixel has T > T_EPS
//   (__syncthreads_or), the GPU form of the TPU kernel's tile-wide max(T)
//   loop condition. The result is the same: once T <= T_EPS a pixel's
//   weights are all zero.
//
// Precision: built without --use_fast_math and with --fmad=false. t_hit is
// a true division and the exponent is expf: a one-ulp change in t moves the
// chart fetch by up to h ulps, and the alpha cutoffs are discontinuities.
// Without contraction each operation rounds as the plain PyTorch version's
// separate elementwise ops do, in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;  // tiles of up to 1024 pixels
constexpr int kRec = 32;          // F_REC
constexpr int kCam = 18;
constexpr float kTEps = 1e-4f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kExtent2 = 9.0f;  // EXTENT_SIGMA^2
constexpr float kAaSigma2 = 0.5f;

__global__ void __launch_bounds__(kThreads)
rasterize_eval_kernel(const float* __restrict__ records,
                      const int* __restrict__ gids,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const float* __restrict__ charts,
                      const float* __restrict__ cam_info,
                      float* __restrict__ out, int ntx, int tile_h,
                      int tile_w, int height, int width, int ch, int cw,
                      int s_cap, int chunk) {
  extern __shared__ float smem[];
  __shared__ float cam[kCam];
  float* s_rec = smem;                    // chunk * kRec
  float* s_chart = smem + chunk * kRec;   // chunk * ch * cw * 3
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
  float T[kPixPerThread], acc[8][kPixPerThread];
  bool inside[kPixPerThread];
  bool alive = false;
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int p = tid + j * kThreads;
    const int lx = p % tile_w;
    const int ly = p / tile_w;
    const int ix = tx * tile_w + lx;
    const int iy = ty * tile_h + ly;
    inside[j] = p < pix && ix < width && iy < height;
    gx[j] = static_cast<float>(ix) + cam[4];
    gy[j] = static_cast<float>(iy) + cam[5];
    const float dx = (gx[j] + 0.5f - cam[2]) / cam[0];
    const float dy = (gy[j] + 0.5f - cam[3]) / cam[1];
    d0[j] = cam[9] * dx + cam[10] * dy + cam[11];
    d1[j] = cam[12] * dx + cam[13] * dy + cam[14];
    d2[j] = cam[15] * dx + cam[16] * dy + cam[17];
    T[j] = 1.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c][j] = 0.0f;
    alive = alive || inside[j];
  }

  for (int base = 0; base < count; base += chunk) {
    // barrier: every thread is done with the previous chunk's staging
    if (!__syncthreads_or(alive)) break;
    const int n = min(chunk, count - base);
    const int* ids = gids + start + base;
    for (int i = tid; i < n * kRec; i += kThreads) {
      const int s = i / kRec;
      s_rec[i] = records[static_cast<long long>(ids[s]) * kRec + (i - s * kRec)];
    }
    for (int i = tid; i < n * chw3; i += kThreads) {
      const int s = i / chw3;
      s_chart[i] = charts[static_cast<long long>(ids[s]) * chw3 + (i - s * chw3)];
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
          // bilinear fetch clamped into the active h x w region
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
          acc[7][j] = acc[7][j] + w;
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
    for (int c = 0; c < 8; ++c) out[c * plane + o] = acc[c][j];
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_eval(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info, void* out,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_cap, int chunk, void* stream) {
  const size_t smem =
      static_cast<size_t>(chunk) * (kRec + ch * cw * 3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_eval_kernel<<<num_tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(gids),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(charts), static_cast<const float*>(cam_info),
      static_cast<float*>(out), ntx, tile_h, tile_w, height, width, ch, cw,
      s_cap, chunk);
  return static_cast<int>(cudaGetLastError());
}
