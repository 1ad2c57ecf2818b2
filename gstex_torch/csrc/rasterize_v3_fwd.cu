// Training forward of the textured-surfel blend over the pair-space
// inputs, by the chunk scan: the transmittance of a chunk of 16 slots comes
// from a log-step product scan across the chunk, not from the serial
// per-splat recurrence.
//
// Replaces: gstex_tpu/ops/rasterize_pallas3.py, _fwd_kernel3 (launched by
// rasterize_pallas3_fwd). Inputs and outputs are csrc/rasterize_v2_fwd.cu's:
// records_t (T, S, 32), charts_g (T, S, Ch, Cw, 3), counts; fourteen (H, W)
// planes in CH_NAMES order and ncontrib (H, W). Per pixel and chunk, with
// T_in the transmittance entering the chunk:
//   incl_k = T_in * prod_{j<=k} (1 - alpha_j), excl_k = incl_{k-1} (T_in)
//   applied_k = alpha_k > 0 && incl_k > T_EPS, w_k = alpha_k * excl_k
// ncontrib is the k with alpha_k > 0 and incl_k <= T_EPS < excl_k, t_final
// the least incl_k > T_EPS, and the reg term takes the exclusive prefix
// sums of w and w*m over the chunk.
//
// What the TPU kernel does that is not carried over: its layout (splats on
// sublanes, pixels on lanes, charts packed c-major on 128 lanes, the texel
// fetch as a matmul against hat weights, the per-splat-constant channels
// on the MXU). What is: the chunk of 16 and the scans, in the order of its
// helpers _cumprod_incl and _cumsum_excl (strides 1, 2, 4, 8).
//
// What bounds it on the H100: operations (~40 fp32 operations per (pixel,
// slot) response, ~90 per blend), the same as the other tiers' per pair;
// but it evaluates all 16 slots of a chunk for every pixel still alive,
// where the serial walk stops at the pixel's break, and it pays the scans
// and the shuffle sums. Bytes: each tile reads its own copy of a chart.
//
// The design:
// - One block per tile (32 x 32 pixels), 256 threads as 16 half-warps. In
//   a half-warp, lane k holds slot base + k of the chunk: its record in
//   registers for the whole chunk, its chart pointer, its response and its
//   texel fetch at the half-warp's current pixel.
// - The scans are __shfl_up_sync with width 16; a pixel's sums over the
//   chunk are xor-shuffle reductions over the 16 lanes.
// - A half-warp walks 64 pixels a chunk; each pixel's T, t_final, ncontrib
//   and thirteen sums stay in shared memory across chunks (64 KB). A warp
//   skips a pixel pair where neither pixel is alive; the tile stops once no
//   in-image pixel has T > T_EPS.
//
// Precision: no --use_fast_math and --fmad=false. The response, the scans
// and the per-lane terms round as the plain version's
// (ops/rasterize_v3.py:rasterize_v3_fwd_reference) do, so T, the
// transmittance gates and ncontrib are the same bit for bit; its sums over
// a chunk's 16 slots are taken in another order (a shuffle tree).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // slots a chunk: one per lane of a half-warp
constexpr int kGroups = kThreads / kChunk;
constexpr int kRec = 32;
constexpr int kUsed = 28;   // record fields the forward reads
constexpr int kCam = 18;
constexpr int kSums = 13;   // img(3) tex(3) depth alpha normal(3) reg m1
constexpr int kPlanes = 2 + kSums;  // T, t_final, the sums; then ncontrib
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTEps = 1e-4f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kExtent2 = 9.0f;
constexpr float kAaSigma2 = 0.5f;
constexpr float kRegNear = 0.2f;
constexpr float kInvRegNear = 5.0f;
constexpr float kKfac = static_cast<float>(100.0 / (100.0 - 0.2));

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = kChunk / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off, kChunk);
  return x;
}

__device__ __forceinline__ float half_min(float x) {
#pragma unroll
  for (int off = kChunk / 2; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off, kChunk));
  return x;
}

__device__ __forceinline__ int half_min(int x) {
#pragma unroll
  for (int off = kChunk / 2; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(kFull, x, off, kChunk));
  return x;
}

// exclusive prefix sum over the half-warp: a shift by one, then strides
// 1, 2, 4, 8 (rasterize_pallas3._cumsum_excl)
__device__ __forceinline__ float cumsum_excl(float x, int k) {
  const float prev = __shfl_up_sync(kFull, x, 1, kChunk);
  x = k >= 1 ? prev : 0.0f;
#pragma unroll
  for (int s = 1; s < kChunk; s <<= 1) {
    const float up = __shfl_up_sync(kFull, x, s, kChunk);
    if (k >= s) x = x + up;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
rasterize_v3_fwd_kernel(const float* __restrict__ records_t,
                        const float* __restrict__ charts_g,
                        const int* __restrict__ counts,
                        const float* __restrict__ cam_info,
                        float* __restrict__ out, int* __restrict__ ncontrib,
                        int ntx, int tile_h, int tile_w, int height,
                        int width, int ch, int cw, int s_max, int lean) {
  extern __shared__ float s_st[];  // kPlanes * pix floats, then pix ints
  __shared__ float cam[kCam];
  const int pix = tile_h * tile_w;
  int* s_ncon = reinterpret_cast<int*>(s_st + kPlanes * pix);
  const long long chw3 = static_cast<long long>(ch) * cw * 3;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int k = tid & (kChunk - 1);  // this lane's slot in a chunk
  const int group = tid / kChunk;
  if (tid < kCam) cam[tid] = cam_info[tid];
  for (int p = tid; p < pix; p += kThreads) {
    s_st[p] = 1.0f;        // T
    s_st[pix + p] = 1.0f;  // t_final
#pragma unroll
    for (int c = 0; c < kSums; ++c) s_st[(2 + c) * pix + p] = 0.0f;
    s_ncon[p] = s_max;
  }
  __syncthreads();

  const long long slot0 = static_cast<long long>(tile) * s_max;
  const int count = min(counts[tile], s_max);
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  float* const sums = s_st + 2 * pix;

  bool alive = true;
  for (int base = 0; base < count; base += kChunk) {
    // also keeps the previous chunk's state writes ahead of this chunk
    if (!__syncthreads_or(alive)) break;
    alive = false;
    const int slot = base + k;
    const bool valid = slot < count;
    const long long row = slot0 + min(slot, s_max - 1);
    float r[kUsed];
#pragma unroll
    for (int f = 0; f < kUsed; ++f) r[f] = __ldg(records_t + row * kRec + f);
    const float* chart = charts_g + row * chw3;

    // pixels p = group, group + 16, ...: the two half-warps of a warp walk
    // the same number of them, so the shuffles stay warp-uniform
    for (int p = group; p < pix; p += kGroups) {
      const int ix = tx * tile_w + p % tile_w;
      const int iy = ty * tile_h + p / tile_w;
      const float tp = s_st[p];
      const bool live = ix < width && iy < height && tp > kTEps;
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
      const float v = r[11] + t * b2d;
      const float r2 = u * u + v * v;
      const float arg_s = r2 <= kExtent2 ? -0.5f * r2 : -1e30f;
      const float dpx = gx - r[24];
      const float dpy = gy - r[25];
      const float arg_c = (-0.5f / kAaSigma2) * (dpx * dpx + dpy * dpy);
      const float g = expf(fmaxf(arg_s, arg_c));
      float alpha = fminf(r[20] * g, kAlphaClamp);
      if (alpha < kAlphaCutoff || !(t > 1e-6f)) alpha = 0.0f;
      if (!valid || !live) alpha = 0.0f;

      // the transmittance after each slot: inclusive product scan
      float q = 1.0f - alpha;
#pragma unroll
      for (int s = 1; s < kChunk; s <<= 1) {
        const float up = __shfl_up_sync(kFull, q, s, kChunk);
        if (k >= s) q = q * up;
      }
      const float incl = q * tp;
      const float prev = __shfl_up_sync(kFull, incl, 1, kChunk);
      const float excl = k == 0 ? tp : prev;
      const bool applied = alpha > 0.0f && incl > kTEps;
      const float w = applied ? alpha * excl : 0.0f;
      const bool brk = alpha > 0.0f && incl <= kTEps && excl > kTEps;
      const int brk_slot = half_min(brk ? slot : s_max);
      const float t_min = half_min(incl > kTEps ? incl : 2.0f);
      const float t_out = __shfl_sync(kFull, incl, kChunk - 1, kChunk);

      float c[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) c[i] = 0.0f;
      float m = 0.0f;
      if (applied) {
        const float b1ud = r[12] * d0 + r[13] * d1 + r[14] * d2;
        const float b2ud = r[16] * d0 + r[17] * d1 + r[18] * d2;
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
        for (int i = 0; i < 3; ++i) {
          const float tex =
              (1.0f - fx) * ((1.0f - fy) * __ldg(c00 + i) + fy * __ldg(c01 + i))
              + fx * ((1.0f - fy) * __ldg(c10 + i) + fy * __ldg(c11 + i));
          c[i] = w * r[21 + i];
          c[3 + i] = w * tex;
        }
        c[6] = w * t;
        c[7] = w;
        if (!lean) {
          const float inv_t = safe_nd * (1.0f / r[3]);
          const float invtc = t >= kRegNear ? inv_t : kInvRegNear;
          m = kKfac * (1.0f - kRegNear * invtc);
          const float wfl = w * (nd > 0.0f ? -1.0f : 1.0f);
#pragma unroll
          for (int i = 0; i < 3; ++i) c[8 + i] = r[i] * wfl;
          c[12] = w * m;
        }
      }
      if (!lean) {
        // the distortion pairs within the chunk: exclusive prefix sums
        const float pw = cumsum_excl(w, k);
        const float pwm = cumsum_excl(c[12], k);
        if (applied)
          c[11] = 2.0f * w * (m * (sums[7 * pix + p] + pw)
                              - (sums[12 * pix + p] + pwm));
      }
#pragma unroll
      for (int i = 0; i < kSums; ++i)
        if (!lean || i < 8) c[i] = half_sum(c[i]);
      if (k == 0 && live) {
#pragma unroll
        for (int i = 0; i < kSums; ++i)
          sums[i * pix + p] = sums[i * pix + p] + c[i];
        s_st[p] = t_out;
        s_st[pix + p] = fminf(s_st[pix + p], t_min);
        s_ncon[p] = min(s_ncon[p], brk_slot);
        alive = alive || t_out > kTEps;
      }
    }
  }
  __syncthreads();

  const int tx0 = tx * tile_w;
  const int ty0 = ty * tile_h;
  const long long plane = static_cast<long long>(height) * width;
  for (int p = tid; p < pix; p += kThreads) {
    const int ix = tx0 + p % tile_w;
    const int iy = ty0 + p / tile_w;
    if (ix >= width || iy >= height) continue;
    const long long o = static_cast<long long>(iy) * width + ix;
#pragma unroll
    for (int c = 0; c < 12; ++c) out[c * plane + o] = sums[c * pix + p];
    out[12 * plane + o] = s_st[pix + p];
    out[13 * plane + o] = sums[12 * pix + p];
    ncontrib[o] = s_ncon[p];
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Tiles must hold a multiple of 16 pixels (the wrapper takes
// 32 x 32). Returns the cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_v3_fwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, void* out, void* ncontrib, int num_tiles, int ntx,
    int tile_h, int tile_w, int height, int width, int ch, int cw, int s_max,
    int lean, void* stream) {
  const size_t smem =
      static_cast<size_t>(kPlanes + 1) * tile_h * tile_w * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_v3_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_v3_fwd_kernel<<<num_tiles, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records_t),
      static_cast<const float*>(charts_g), static_cast<const int*>(counts),
      static_cast<const float*>(cam_info), static_cast<float*>(out),
      static_cast<int*>(ncontrib), ntx, tile_h, tile_w, height, width, ch, cw,
      s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
