// Backward of the training forward (csrc/rasterize_fwd.cu): the
// back-to-front gradient walk over the flat (tile, depth, id) pair list,
// with the per-gaussian reduction fused in.
//
// Replaces: gstex_tpu/ops/rasterize_pallas5.py, _bwd_kernel5 (launched by
// rasterize_pallas5_bwd), and the segment_sum of its per-pair rows in
// rasterize_pallas_api.py:_core5_bwd. For each pixel it walks the tile's
// splats from min(count, max ncontrib + 1) down to 0, recovers T before
// each applied splat as T_{k+1} / (1 - alpha_k) from t_final, keeps the
// suffix sums of s*w (and of w and w*m for the reg chain), and emits the
// gradients of record fields 0-11, 15, 19-25 and of the 3 x 3 texels
// around the sample (the TPU kernel's hat-function form of the bilinear
// fetch). Fields 12-14, 16-18 (the detached uv frame) get none.
//
// What bounds it on the H100: operations. Each applied (pixel, pair) costs
// ~300 fp32 operations (the response, the texel fetch and its gradient,
// the chain rule to 20 record fields), and every walked (pixel, pair) the
// ~40 of the response; the bytes are one record and chart read and one
// record and chart gradient added per pair per tile.
//
// What the design does about it:
// - One block per tile, 256 threads with 4 pixels each, as the forward.
//   The tile's 12 cotangent planes and its alpha and m1 maps sit in shared
//   memory, so a thread keeps only its pixels' walk state in registers.
// - Splats are staged in chunks (records and charts in shared memory), and
//   each chunk's gradients are summed in shared memory first: record
//   fields by a warp shuffle reduction and one shared atomic per warp and
//   field, chart texels by shared atomics. At the end of a chunk one
//   global atomicAdd per non-zero field and texel carries the tile's sum
//   into d_records[gid] and d_charts[gid]: the segment_sum of the TPU path
//   happens here, and no per-pair rows reach device memory.
// - A pixel skips a splat at once where it has no weight (rank >=
//   ncontrib, or alpha == 0): every gradient term of such a pair is zero.
//
// Precision: no --use_fast_math and --fmad=false, and each pixel's values
// are computed as the plain version (ops/rasterize_bwd.py) computes them.
// The order of the sums over pixels and tiles differs (shuffles, atomics),
// so the result is held to the plain version with a relative tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kRec = 32;
constexpr int kCam = 18;
constexpr int kPlanes = 14;  // 12 cotangents, alpha, m1
constexpr int kFields = 20;  // record fields with a gradient
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

__device__ __forceinline__ float neg_sign(float x) {
  return x > 0.0f ? -1.0f : (x < 0.0f ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
rasterize_bwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ gids,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const float* __restrict__ charts,
                     const float* __restrict__ cam_info,
                     const float* __restrict__ maps,
                     const int* __restrict__ ncontrib,
                     const float* __restrict__ gmaps,
                     float* __restrict__ d_records,
                     float* __restrict__ d_charts, int ntx, int tile_h,
                     int tile_w, int height, int width, int ch, int cw,
                     int s_cap, int chunk, int lean) {
  extern __shared__ float smem[];
  __shared__ float cam[kCam];
  __shared__ int s_top;
  const int pix = tile_h * tile_w;
  const int chw3 = ch * cw * 3;
  float* s_pl = smem;                         // kPlanes * pix
  float* s_rec = s_pl + kPlanes * pix;        // chunk * kRec
  float* s_chart = s_rec + chunk * kRec;      // chunk * chw3
  float* s_drec = s_chart + chunk * chw3;     // chunk * kRec
  float* s_dch = s_drec + chunk * kRec;       // chunk * chw3
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kCam) cam[tid] = cam_info[tid];
  if (tid == 0) s_top = -1;
  __syncthreads();

  const int start = starts[tile];
  const int count = min(counts[tile], s_cap);
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  const long long plane = static_cast<long long>(height) * width;

  float gx[kPixPerThread], gy[kPixPerThread];
  float d0[kPixPerThread], d1[kPixPerThread], d2[kPixPerThread];
  float T[kPixPerThread], BS[kPixPerThread], E[kPixPerThread],
      D[kPixPerThread];
  int ncon[kPixPerThread];
  bool inside[kPixPerThread];
  int top = -1;
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
    BS[j] = 0.0f;
    E[j] = 0.0f;
    D[j] = 0.0f;
    T[j] = 1.0f;
    ncon[j] = 0;
    if (inside[j]) {
      const long long o = static_cast<long long>(iy) * width + ix;
      T[j] = maps[12 * plane + o];
      ncon[j] = ncontrib[o];
      top = max(top, ncon[j]);
#pragma unroll
      for (int c = 0; c < 12; ++c) s_pl[c * pix + p] = gmaps[c * plane + o];
      s_pl[12 * pix + p] = maps[7 * plane + o];
      s_pl[13 * pix + p] = maps[13 * plane + o];
    }
  }
  if (top >= 0) atomicMax(&s_top, top);
  __syncthreads();
  const int walk = min(count, s_top + 1);

  for (int base = ((walk - 1) / chunk) * chunk; base >= 0 && walk > 0;
       base -= chunk) {
    const int n = min(chunk, walk - base);
    const int* ids = gids + start + base;
    for (int i = tid; i < n * kRec; i += kThreads) {
      const int s = i / kRec;
      s_rec[i] = records[static_cast<long long>(ids[s]) * kRec + (i - s * kRec)];
      s_drec[i] = 0.0f;
    }
    __syncthreads();
    // a chart's texel gradients land in its active h x w texels; the
    // fetch's hat weights read one row and column beyond them
    for (int i = tid; i < n * chw3; i += kThreads) {
      const int s = i / chw3;
      const int e = i - s * chw3;
      const float a = static_cast<float>(e / (cw * 3));
      const float b = static_cast<float>((e / 3) % cw);
      const float h = s_rec[s * kRec + 26];
      const float w = s_rec[s * kRec + 27];
      if (a < h + 1.0f && b < w + 1.0f)
        s_chart[i] = charts[static_cast<long long>(ids[s]) * chw3 + e];
      if (a < h && b < w) s_dch[i] = 0.0f;
    }
    __syncthreads();

    for (int s = n - 1; s >= 0; --s) {
      const int k = base + s;
      const float* r = s_rec + s * kRec;
      const float* chart = s_chart + s * chw3;
      float* dch = s_dch + s * chw3;
      float v[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[f] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPixPerThread; ++j) {
        if (!inside[j] || k >= ncon[j]) continue;
        const int p = tid + j * kThreads;
        const float nd = r[0] * d0[j] + r[1] * d1[j] + r[2] * d2[j];
        const float safe_nd =
            fabsf(nd) < 1e-9f ? (nd < 0.0f ? -1e-9f : 1e-9f) : nd;
        const float t = r[3] / safe_nd;
        const float b1d = r[4] * d0[j] + r[5] * d1[j] + r[6] * d2[j];
        const float b2d = r[8] * d0[j] + r[9] * d1[j] + r[10] * d2[j];
        const float u = r[7] + t * b1d;
        const float v_ = r[11] + t * b2d;
        const float r2 = u * u + v_ * v_;
        const float arg_s = r2 <= kExtent2 ? -0.5f * r2 : -1e30f;
        const float dpx = gx[j] - r[24];
        const float dpy = gy[j] - r[25];
        const float arg_c = (-0.5f / kAaSigma2) * (dpx * dpx + dpy * dpy);
        const float g = expf(fmaxf(arg_s, arg_c));
        const float opg = r[20] * g;
        float alpha = fminf(opg, kAlphaClamp);
        if (alpha < kAlphaCutoff || !(t > 1e-6f)) alpha = 0.0f;
        if (!(alpha > 0.0f)) continue;  // no weight: every term is zero
        any = true;

        const float inv_q = 1.0f / (1.0f - alpha);
        const float t_k = T[j] * inv_q;
        const float w = alpha * t_k;
        const float* gp = s_pl + p;  // plane c at gp[c * pix]
        const float g_reg = gp[11 * pix];
        float m = 0.0f, invtc = 0.0f, wm = 0.0f, big_a = 0.0f, big_c = 0.0f,
              d_m = 0.0f;
        if (!lean) {
          const float inv_t = safe_nd * (1.0f / r[3]);
          invtc = t >= kRegNear ? inv_t : kInvRegNear;
          m = kKfac * (1.0f - kRegNear * invtc);
          wm = w * m;
          big_a = gp[12 * pix] - w - E[j];
          big_c = gp[13 * pix] - wm - D[j];
          d_m = 2.0f * g_reg * w * (big_a - E[j]);
        }

        // texels: the 3 x 3 neighbourhood of the sample, hat weights
        const float b1ud = r[12] * d0[j] + r[13] * d1[j] + r[14] * d2[j];
        const float b2ud = r[16] * d0[j] + r[17] * d1[j] + r[18] * d2[j];
        const float uvu_raw = 0.5f + r[15] + t * b1ud;
        const float uvv_raw = 0.5f + r[19] + t * b2ud;
        const float hf = r[26];
        const float wf = r[27];
        const float x_raw = fminf(fmaxf(uvu_raw, 0.0f), 1.0f) * hf;
        const float y_raw = fminf(fmaxf(uvv_raw, 0.0f), 1.0f) * wf;
        const float xg = fminf(fmaxf(x_raw, 0.0f), hf - 1.0f);
        const float yg = fminf(fmaxf(y_raw, 0.0f), wf - 1.0f);
        const float x0 = floorf(xg);
        const float y0 = floorf(yg);
        float wx[3], dwx[3], wy[3], dwy[3];
        int row[3], col[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float ai = x0 + (static_cast<float>(i) - 1.0f);
          const float dfx = xg - ai;
          row[i] = static_cast<int>(ai);
          wx[i] = fmaxf(1.0f - fabsf(dfx), 0.0f);
          dwx[i] = fabsf(dfx) <= 1.0f ? neg_sign(dfx) : 0.0f;
          const float bi = y0 + (static_cast<float>(i) - 1.0f);
          const float dfy = yg - bi;
          col[i] = static_cast<int>(bi);
          wy[i] = fmaxf(1.0f - fabsf(dfy), 0.0f);
          dwy[i] = fabsf(dfy) <= 1.0f ? neg_sign(dfy) : 0.0f;
        }
        float texel[3][3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            const bool ok = row[i] >= 0 && row[i] < ch && col[jj] >= 0 &&
                            col[jj] < cw;
#pragma unroll
            for (int c = 0; c < 3; ++c)
              texel[i][jj][c] =
                  ok ? chart[(row[i] * cw + col[jj]) * 3 + c] : 0.0f;
          }
        float tmp[3][3], texk[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            tmp[c][i] = texel[i][0][c] * wy[0] + texel[i][1][c] * wy[1] +
                        texel[i][2][c] * wy[2];
          texk[c] = wx[0] * tmp[c][0] + wx[1] * tmp[c][1] + wx[2] * tmp[c][2];
        }
        const float gt0 = gp[3 * pix], gt1 = gp[4 * pix], gt2 = gp[5 * pix];
        float coeff[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          coeff[i] = gt0 * tmp[0][i] + gt1 * tmp[1][i] + gt2 * tmp[2][i];
        const float coeff_dx =
            coeff[0] * dwx[0] + coeff[1] * dwx[1] + coeff[2] * dwx[2];
        float m2[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float wxw = wx[i] * w;
          m2[0][i] = wxw * gt0;
          m2[1][i] = wxw * gt1;
          m2[2][i] = wxw * gt2;
        }
        float d_wy[3];
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          float acc = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int i = 0; i < 3; ++i) acc = acc + texel[i][jj][c] * m2[c][i];
          d_wy[jj] = acc;
        }
        float d_x = w * coeff_dx;
        float d_y = d_wy[0] * dwy[0] + d_wy[1] * dwy[1] + d_wy[2] * dwy[2];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (wx[i] == 0.0f || row[i] < 0 || row[i] >= ch) continue;
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            if (wy[jj] == 0.0f || col[jj] < 0 || col[jj] >= cw) continue;
            float* dst = dch + (row[i] * cw + col[jj]) * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float val = wy[jj] * m2[c][i];
              if (val != 0.0f) atomicAdd(dst + c, val);
            }
          }
        }

        float s_k = r[21] * gp[0] + r[22] * gp[pix] + r[23] * gp[2 * pix] +
                    texk[0] * gt0 + texk[1] * gt1 + texk[2] * gt2 +
                    t * gp[6 * pix] + gp[7 * pix];
        const float fl = nd > 0.0f ? -1.0f : 1.0f;
        if (!lean) {
          s_k = s_k + fl * (r[0] * gp[8 * pix] + r[1] * gp[9 * pix] +
                            r[2] * gp[10 * pix]);
          s_k = s_k + 2.0f * g_reg * ((m * big_a - big_c) + (D[j] - m * E[j]));
        }
        const float sw = s_k * w;
        const float d_alpha = t_k * s_k - BS[j] * inv_q;

        if (!(x_raw >= 0.0f && x_raw <= hf - 1.0f)) d_x = 0.0f;
        if (!(y_raw >= 0.0f && y_raw <= wf - 1.0f)) d_y = 0.0f;
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

        float n0 = d_nd * d0[j], n1 = d_nd * d1[j], n2 = d_nd * d2[j];
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
        v[4] += d_u * (t * d0[j]);
        v[5] += d_u * (t * d1[j]);
        v[6] += d_u * (t * d2[j]);
        v[7] += d_u;
        v[8] += d_v * (t * d0[j]);
        v[9] += d_v * (t * d1[j]);
        v[10] += d_v * (t * d2[j]);
        v[11] += d_v;
        v[12] += d_uvu;
        v[13] += d_uvv;
        v[14] += d_op;
        v[15] += w * gp[0];
        v[16] += w * gp[pix];
        v[17] += w * gp[2 * pix];
        v[18] += d_xy0;
        v[19] += d_xy1;

        BS[j] = BS[j] + sw;
        if (!lean) {
          E[j] = E[j] + w;
          D[j] = D[j] + wm;
        }
        T[j] = t_k;
      }
      // record grads: warp sums, then one shared atomic per warp and field
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          float x = v[f];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, off);
          if (lane == 0 && x != 0.0f)
            atomicAdd(s_drec + s * kRec + kFieldOf[f], x);
        }
      }
    }
    __syncthreads();
    // the chunk's per-tile sums into the per-gaussian gradients
    for (int i = tid; i < n * kRec; i += kThreads) {
      const float x = s_drec[i];
      const int s = i / kRec;
      if (x != 0.0f)
        atomicAdd(d_records + static_cast<long long>(ids[s]) * kRec +
                      (i - s * kRec), x);
    }
    for (int i = tid; i < n * chw3; i += kThreads) {
      const int s = i / chw3;
      const int e = i - s * chw3;
      if (!(e / (cw * 3) < s_rec[s * kRec + 26] &&
            (e / 3) % cw < s_rec[s * kRec + 27]))
        continue;
      const float x = s_dch[i];
      if (x != 0.0f)
        atomicAdd(d_charts + static_cast<long long>(ids[s]) * chw3 + e, x);
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; d_records and
// d_charts must be zeroed; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_bwd(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info,
    const void* maps, const void* ncontrib, const void* gmaps,
    void* d_records, void* d_charts, int num_tiles, int ntx, int tile_h,
    int tile_w, int height, int width, int ch, int cw, int s_cap, int chunk,
    int lean, void* stream) {
  const size_t smem =
      (static_cast<size_t>(kPlanes) * tile_h * tile_w +
       static_cast<size_t>(chunk) * 2 * (kRec + ch * cw * 3)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_bwd_kernel<<<num_tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(gids),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(charts), static_cast<const float*>(cam_info),
      static_cast<const float*>(maps), static_cast<const int*>(ncontrib),
      static_cast<const float*>(gmaps), static_cast<float*>(d_records),
      static_cast<float*>(d_charts), ntx, tile_h, tile_w, height, width, ch,
      cw, s_cap, chunk, lean);
  return static_cast<int>(cudaGetLastError());
}
