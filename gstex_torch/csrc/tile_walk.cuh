// The per-pixel blend walk of one tile and its back-to-front chain rule,
// shared by the flat kernels (rasterize_eval.cu, rasterize_fwd.cu,
// rasterize_bwd.cu), the dense-list kernels (rasterize_dense_eval.cu,
// rasterize_dense_fwd.cu, rasterize_dense_bwd.cu) and the pair-space
// kernels (rasterize_v3_fwd.cu, rasterize_v3_bwd.cu, rasterize_v2_fwd.cu,
// rasterize_v2_bwd.cu, rasterize_v1_fwd.cu, rasterize_v1_bwd.cu). The
// tiers compute the same function and differ only in how a tile's slot
// finds its record and chart
// (through the flat list's gids or TileBins.ids: IdSlots below; or the
// slot's own copy) and where its gradients go (added per gaussian with
// atomics, or stored per slot). Each kernel file names its `Slots` type and
// instantiates `forward_tile` or `backward_tile` from its own __global__
// function, for the tile it chooses.
//
// kV1 selects the v1 kernels' arithmetic (gstex_tpu/ops/rasterize_pallas.py
// and rasterize_pallas_bwd.py), which differs from the others' in rounding
// only: the falloff as the larger of two exps (the surfel's, zero outside
// the 3-sigma ellipse, and the screen low-pass's) where the others take
// one exp of the larger argument; the distortion depth
// m = KFAC * (1 - NEAR / max(t, NEAR)) by a divide where the others
// multiply by 1/t = n.d / a_n; and in the backward the m chain
// d_m * KFAC * NEAR / (tc * tc) and d_a_n = d_t / n.d by divides. With
// kV1 false every operation is the one the dense and v2 kernels always
// ran.
//
// In backward_tile, kV3 selects the v3 backward's recovery of T
// (gstex_tpu/ops/rasterize_pallas3.py, _bwd_kernel3): from the end of
// each chunk of 16 slots (t_final for the last), T before an applied slot
// k is t_end / prod_{j >= k in its chunk} (1 - alpha_j), and
// dL/dalpha = T_k * s_k - Bs / (1 - alpha_k), both by divides, where the
// others divide T after slot k by (1 - alpha_k) and multiply by that
// reciprocal.
//
// In forward_tile, kV3 selects the v3 forward's transmittance
// (rasterize_pallas3.py, _fwd_kernel3): per chunk of kScan = 16 slots
// from slot 0, with T_in the transmittance entering it and
// q_j = 1 - alpha_j, incl_k = T_in * (q_0 ... q_k) by the TPU kernel's
// log-step scan (strides 1, 2, 4, 8) and excl_k = incl_{k-1} (T_in for
// k = 0); slot k blends with w = alpha_k * excl_k where alpha_k > 0 and
// incl_k > T_EPS, breaks (ncontrib) where alpha_k > 0 and
// incl_k <= T_EPS < excl_k, and t_final is the least incl_k > T_EPS of
// every slot walked; T = incl_15 after the chunk. A pixel alive at a
// chunk's start walks all 16 of its slots (those past count with
// alpha = 0, reading no record), so that the scan's association, and with
// it every bit of T, t_final and ncontrib, is the plain version's. The
// scan streams through the slots:
//   p2_k = q_k q_{k-1}, p4_k = p2_k p2_{k-2}, p8_k = p4_k p4_{k-4},
//   incl_k = (p8_k p8_{k-8}) T_in,
// a factor of negative index being 1 (exact), which are the scan's
// products to the bit; a pixel keeps the window of the last q, two p2,
// four p4 and eight p8.
//
// In forward_tile, kEdit selects the texture-edit output policy
// (csrc/texture_edit.cu; gstex_tpu/ops/texture_edit.py): the eval walk
// (kEval: the same break at T_EPS, the same weights w = alpha * T), but
// where the eval kernel sums w into eight planes, each applied pair whose
// depth t lies in its pixel's window [lo, hi] adds w * (canvas rgb,
// canvas alpha, 1) to the texels of its bilinear tent, as REDs into the
// splat's (Ch, Cw, 5) accumulator at slots.dchart (edit_texels below).
// The pixel's six inputs (canvas rgb, alpha, lo, hi) come from
// `edit_planes`, six (H, W) planes; nothing is written to `out`.
//
// forward_tile's Slots:
//   void stage(int base, int n, float* s_rec, int tid): the records of
//     slots base..base+n-1 into s_rec (n * kRec floats); the caller
//     synchronises after it.
//   const TChart* chart(int s, int k): the chart of chunk entry s, slot k,
//     TChart float or __nv_bfloat16; each texel is read by load_texel,
//     which widens a bf16 texel to float, so every sum stays float.
// backward_tile's Slots adds:
//   void begin(int base, int n, float* s_rec, float* s_drec, int tid):
//     stage, zero s_drec and whatever the slots accumulate per chunk.
//   float* dchart(int s, int k): where slot k's texel gradients are added
//     (float whatever the charts' type).
//   void end(int base, int n, const float* s_drec, int tid): the chunk's
//     summed record gradients (and staged chart gradients) out, reading
//     s_drec[i] for i = tid, tid + kBlock, ... < n * kRec (kBlock: the
//     block's threads).
// With kRing (the flat, the dense and the pair-space kernels) the records of a tile's chunks go through a ring of two buffers: chunk
// c + 1's copy is in flight while chunk c is walked, one barrier pair a
// chunk. Its Slots replace stage and begin by
//   void prefetch(int base, int n, float* s_rec, int tid): start the
//     asynchronous copy (cp_async16) of the records of slots
//     base..base+n-1 into s_rec; the walk commits and waits.
// and chart, dchart and end must not rely on what an earlier chunk's
// prefetch left in shared memory two chunks ago.
//
// backward_tile's kShflT (the record gradients' transposed warp reduction)
// and kBlock (threads a block, 1024 / kBlock pixels each, rounded up; the
// Slots must stride by the same count) are the dense and the pair-space
// backwards' options; the flat backward keeps the lane-0 reduction and
// 256 threads.
//
// Precision: no --use_fast_math and --fmad=false; see the kernel files for
// the plain versions each is held to.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kRec = 32;
constexpr int kCam = 18;
constexpr int kPlanes = 14;  // backward: 12 cotangents, alpha, m1
constexpr int kFields = 20;  // record fields with a gradient
constexpr float kTEps = 1e-4f;
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

// The falloff g from the surfel's argument arg_s (-r2 / 2 inside the
// 3-sigma ellipse, -1e30 outside) and the screen low-pass's arg_c: one exp
// of the larger argument, or (v1) the larger of the two exps. `surf` says
// whether the surfel's term is the max (v1: compared after the exps).
template <bool kV1>
__device__ __forceinline__ float falloff(float r2, float arg_s, float arg_c,
                                         bool& surf) {
  if constexpr (kV1) {
    const float g_surf = r2 <= kExtent2 ? expf(-0.5f * r2) : 0.0f;
    const float g_scr = expf(arg_c);
    surf = g_surf >= g_scr;
    return surf ? g_surf : g_scr;
  } else {
    surf = arg_s >= arg_c;
    return expf(fmaxf(arg_s, arg_c));
  }
}

// The distortion depth m(t) = KFAC * (1 - NEAR / max(t, NEAR)): by a
// divide (v1), or with 1/t = n.d / a_n by a reciprocal and a multiply,
// leaving 1 / max(t, NEAR) in invtc for the backward's m chain (v1's chain
// divides instead and leaves invtc as it was).
template <bool kV1>
__device__ __forceinline__ float depth_map(float t, float safe_nd, float a_n,
                                           float& invtc) {
  if constexpr (kV1) {
    return kKfac * (1.0f - kRegNear / fmaxf(t, kRegNear));
  } else {
    const float inv_t = safe_nd * (1.0f / a_n);
    invtc = t >= kRegNear ? inv_t : kInvRegNear;
    return kKfac * (1.0f - kRegNear * invtc);
  }
}

// One texel channel through the read-only path, widened to float: a bf16
// texel's 16 bits are the upper half of the float it stands for, so the
// widening is exact and every operation after it is the f32 kernel's.
__device__ __forceinline__ float load_texel(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_texel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// 16 bytes from global to shared memory, asynchronously (cp.async.cg: L2
// only, the records are read once per tile); completion by the commit and
// wait below.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One round of a transposed warp reduction of 2 * kHalf values a lane:
// each lane keeps the half of its values that its lane bit kHalf selects
// (the upper half where it is set) and receives that half from the lane
// that differs in that bit, which keeps the other; x[0..kHalf) ends as the
// pair's sums of the kept half. After the rounds 16, 8, 4, 2 and 1, lane
// l holds the warp's sum of value l.
template <int kHalf>
__device__ __forceinline__ void warp_fold(const float* in, float* x,
                                          int lane) {
  const bool hi = (lane & kHalf) != 0;
#pragma unroll
  for (int f = 0; f < kHalf; ++f) {
    const float keep = hi ? in[f + kHalf] : in[f];
    const float give = hi ? in[f] : in[f + kHalf];
    x[f] = keep + __shfl_xor_sync(0xffffffffu, give, kHalf);
  }
}

// Slots found through a list of gaussian ids: slot k of a tile is gaussian
// tile_ids[k] (a row of TileBins.ids, or the tile's segment of the flat
// list); its record and chart are read through the id, and its gradients
// are added into the gaussian's rows of d_records and d_charts, which
// other tiles add to as well (the forward leaves those null). s_id holds
// kIdBufs chunks of ids in shared memory: one for stage/begin, three for
// the ring's prefetch, where chunk c + 1's ids arrive while chunk c is
// walked and chunk c - 1's end() may still read its own. TChart is the
// charts' element type (float, or __nv_bfloat16 for the flat kernels' bf16
// entries); their gradients are float either way.
template <int kChunk, int kIdBufs = 1, int kBlock = kThreads,
          class TChart = float>
struct IdSlots {
  const float* records;
  const int* tile_ids;
  const TChart* charts;
  float* d_records;
  float* d_charts;
  long long chw3;
  int* s_id;

  __device__ int* ids(int base) const {
    return s_id + ((base / kChunk) % kIdBufs) * kChunk;
  }
  __device__ void stage(int base, int n, float* s_rec, int tid) const {
    int* id = ids(base);
    if (tid < n) id[tid] = tile_ids[base + tid];
    __syncthreads();
    for (int i = tid; i < n * kRec; i += kBlock) {
      const int s = i / kRec;
      s_rec[i] = records[static_cast<long long>(id[s]) * kRec + (i - s * kRec)];
    }
  }
  __device__ void begin(int base, int n, float* s_rec, float* s_drec,
                        int tid) const {
    int* id = ids(base);
    if (tid < n) id[tid] = tile_ids[base + tid];
    __syncthreads();
    for (int i = tid; i < n * kRec; i += kBlock) {
      const int s = i / kRec;
      s_rec[i] = records[static_cast<long long>(id[s]) * kRec + (i - s * kRec)];
      s_drec[i] = 0.0f;
    }
  }
  // a record is 8 copies of 16 B; the thread that copies a record's first
  // 16 B also keeps its id
  __device__ void prefetch(int base, int n, float* s_rec, int tid) const {
    int* id = ids(base);
    for (int i = tid; i < n * (kRec / 4); i += kBlock) {
      const int s = i / (kRec / 4);
      const int q = i - s * (kRec / 4);
      const int g = tile_ids[base + s];
      if (q == 0) id[s] = g;
      cp_async16(s_rec + s * kRec + 4 * q,
                 records + static_cast<long long>(g) * kRec + 4 * q);
    }
  }
  __device__ const TChart* chart(int s, int k) const {
    return charts + static_cast<long long>(ids(k)[s]) * chw3;
  }
  __device__ float* dchart(int s, int k) const {
    return d_charts + static_cast<long long>(ids(k)[s]) * chw3;
  }
  // the chunk's per-tile record sums into the per-gaussian gradients
  __device__ void end(int base, int n, const float* s_drec, int tid) const {
    const int* id = ids(base);
    for (int i = tid; i < n * kRec; i += kBlock) {
      const float x = s_drec[i];
      const int s = i / kRec;
      if (x != 0.0f)
        atomicAdd(d_records + static_cast<long long>(id[s]) * kRec +
                      (i - s * kRec), x);
    }
  }
};

// kEdit's output for one applied pair inside its pixel's window: w *
// (rgb, alpha, 1) of pixel j's canvas (ev[0..3][j]) into the texels of
// the tent at the forward's clamped sample x, as REDs into `acc`, the
// splat's (Ch, Cw, 5) accumulator. The weights are texture_edit.py's,
// max(0, 1 - |x - a|) at a = x0 and x0 + 1 (the forward's 1 - fx, and fx
// to the rounding of x - (x0 + 1)), each term w_b * (w_a * (w * value))
// in its order. A weight of zero adds nothing; the texel of every
// non-zero weight lies in the splat's active h x w chart.
template <int kPix>
__device__ __forceinline__ void edit_texels(float* acc, const float* r,
                                            float d0, float d1, float d2,
                                            float t, float w,
                                            const float (&ev)[6][kPix],
                                            int j, int cw) {
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
  const float wx[2] = {1.0f - (xf - x0), 1.0f - fabsf(xf - (x0 + 1.0f))};
  const float wy[2] = {1.0f - (yf - y0), 1.0f - fabsf(yf - (y0 + 1.0f))};
  const float wv[5] = {w * ev[0][j], w * ev[1][j], w * ev[2][j],
                       w * ev[3][j], w};
  const int x0i = static_cast<int>(x0);
  const int y0i = static_cast<int>(y0);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!(wx[a] > 0.0f)) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!(wy[b] > 0.0f)) continue;
      float* texel = acc + ((x0i + a) * cw + y0i + b) * 5;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float v = wy[b] * (wx[a] * wv[c]);
        if (v != 0.0f) atomicAdd(texel + c, v);
      }
    }
  }
}

// v3's chunk of slots, and the slots of it unrolled in the walk: the
// scan's windows are indexed by the slot's place in an unrolled run
constexpr int kScan = 16;
constexpr int kScanUnroll = 8;

// a[0] <- a[1] <- ... <- a[kN - 1] <- a[0]
template <int kN, class X>
__device__ __forceinline__ void rotate_left(X (&a)[kN]) {
  const X first = a[0];
#pragma unroll
  for (int i = 0; i + 1 < kN; ++i) a[i] = a[i + 1];
  a[kN - 1] = first;
}

// One block per tile, 256 threads with 4 pixels each (kBlock threads:
// 1024 / kBlock each, rounded up; the Slots must stride by the same count);
// a pixel's ray, T and sums stay in registers; the tile leaves its walk
// once no in-image pixel has T > T_EPS. Writes the fourteen planes and
// ncontrib; with kEval (the eval kernel's output policy) the first eight
// planes only, blended lean, and neither t_final, m1 nor ncontrib
// (ncontrib may be null). Each slot is walked for every pixel in turn,
// the record read once for them all; with kV3 each pixel walks a chunk of
// 16 slots in turn, its ray recomputed at the chunk's start, and one copy
// of that walk serves every pixel (their state is rotated through index
// 0), so that the scan's window fits in registers beside the pixels'
// state. With kEdit (the texture-edit policy, above) the walk is kEval's
// and its output the texel REDs.
template <int kChunk, class Slots, bool kV1 = false, bool kRing = false,
          bool kEval = false, int kBlock = kThreads, bool kV3 = false,
          bool kEdit = false>
__device__ __forceinline__ void forward_tile(
    const Slots& slots, int tile, const int* __restrict__ counts,
    const float* __restrict__ cam_info, float* __restrict__ out,
    int* __restrict__ ncontrib, int ntx, int tile_h, int tile_w, int height,
    int width, int cw, int s_max, int lean,
    const float* __restrict__ edit_planes = nullptr) {
  static_assert(!kV3 || (!kV1 && !kEval && kChunk % kScan == 0),
                "v3 walks whole chunks of 16 slots, in v2's arithmetic");
  static_assert(!kEdit || (kEval && !kV1 && !kV3),
                "the texture edit walks as the eval kernel does");
  // kBlock threads share the tile's 1024 pixel slots
  constexpr int kPix = (kThreads * kPixPerThread + kBlock - 1) / kBlock;
  // kRing: two buffers, 16-byte aligned for cp.async
  __shared__ __align__(kRing ? 16 : 4)
      float s_ring[(kRing ? 2 : 1) * kChunk * kRec];
  __shared__ float cam[kCam];
  const int tid = threadIdx.x;
  if (tid < kCam) cam[tid] = cam_info[tid];
  __syncthreads();

  const int count = min(counts[tile], s_max);
  if constexpr (kRing) {
    if (count > 0) slots.prefetch(0, min(kChunk, count), s_ring, tid);
    cp_async_commit();
  }
  const int pix = tile_h * tile_w;
  const int tx = tile % ntx;
  const int ty = tile / ntx;

  float gx[kPix], gy[kPix];
  float d0[kPix], d1[kPix], d2[kPix];
  float T[kPix], t_fin[kPix];
  // img(3) tex(3) depth alpha normal(3) reg m1
  float acc[kEval ? 8 : 13][kPix];
  int ncon[kPix];
  bool inside[kPix];
  // kEdit: the pixel's canvas rgb, canvas alpha and depth window
  float ev[kEdit ? 6 : 1][kPix];
  bool alive = false;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = tid + j * kBlock;
    const int ix = tx * tile_w + p % tile_w;
    const int iy = ty * tile_h + p / tile_w;
    inside[j] = p < pix && ix < width && iy < height;
    if constexpr (kEdit) {
      const long long o = static_cast<long long>(iy) * width + ix;
      const long long plane = static_cast<long long>(height) * width;
#pragma unroll
      for (int c = 0; c < 6; ++c)
        ev[c][j] = inside[j] ? edit_planes[c * plane + o] : 0.0f;
    }
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
    for (int c = 0; c < (kEval ? 8 : 13); ++c) acc[c][j] = 0.0f;
    alive = alive || inside[j];
  }

  for (int base = 0; base < count; base += kChunk) {
    // also keeps the previous chunk's readers ahead of this chunk's writes
    if (!__syncthreads_or(alive)) break;
    const int n = min(kChunk, count - base);
    const float* s_rec = s_ring;
    if constexpr (kRing) {
      s_rec = s_ring + ((base / kChunk) & 1) * kChunk * kRec;
      const int next = base + kChunk;
      if (next < count)
        slots.prefetch(next, min(kChunk, count - next),
                       s_ring + ((next / kChunk) & 1) * kChunk * kRec, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's copies, not the next one's
    } else {
      slots.stage(base, n, s_ring, tid);
    }
    __syncthreads();

    if constexpr (kV3) {
      // the ring's chunk holds whole chunks of 16; a pixel's state is at
      // index 0 on its turn
      for (int c0 = 0; c0 < n; c0 += kScan) {
#pragma unroll 1
        for (int j = 0; j < kPix; ++j) {
          if (inside[0] && T[0] > kTEps) {
            const int p = tid + j * kBlock;
            const float px =
                static_cast<float>(tx * tile_w + p % tile_w) + cam[4];
            const float py =
                static_cast<float>(ty * tile_h + p / tile_w) + cam[5];
            const float dx = (px + 0.5f - cam[2]) / cam[0];
            const float dy = (py + 0.5f - cam[3]) / cam[1];
            const float e0 = cam[9] * dx + cam[10] * dy + cam[11];
            const float e1 = cam[12] * dx + cam[13] * dy + cam[14];
            const float e2 = cam[15] * dx + cam[16] * dy + cam[17];
            const float t_in = T[0];
            float excl = t_in;
            // the scan's windows: qN[i] the product of q over the N slots
            // that end at slot i of the run; 1 before the chunk
            float q1[kScanUnroll], q2[kScanUnroll], q4[kScanUnroll],
                q8[kScanUnroll];
#pragma unroll
            for (int i = 0; i < kScanUnroll; ++i)
              q1[i] = q2[i] = q4[i] = q8[i] = 1.0f;
            for (int h = 0; h < kScan; h += kScanUnroll) {
#pragma unroll
              for (int i = 0; i < kScanUnroll; ++i) {
                const int s = c0 + h + i;
                const float* r = s_rec + s * kRec;
                float alpha = 0.0f, nd = 0.0f, safe_nd = 1.0f, t = 0.0f;
                if (s < n) {  // past count: alpha = 0, no record
                  nd = r[0] * e0 + r[1] * e1 + r[2] * e2;
                  safe_nd =
                      fabsf(nd) < 1e-9f ? (nd < 0.0f ? -1e-9f : 1e-9f) : nd;
                  t = r[3] / safe_nd;
                  const float b1d = r[4] * e0 + r[5] * e1 + r[6] * e2;
                  const float b2d = r[8] * e0 + r[9] * e1 + r[10] * e2;
                  const float u = r[7] + t * b1d;
                  const float v = r[11] + t * b2d;
                  const float r2 = u * u + v * v;
                  const float arg_s = r2 <= kExtent2 ? -0.5f * r2 : -1e30f;
                  const float dpx = px - r[24];
                  const float dpy = py - r[25];
                  const float arg_c =
                      (-0.5f / kAaSigma2) * (dpx * dpx + dpy * dpy);
                  bool surf;
                  const float g = falloff<kV1>(r2, arg_s, arg_c, surf);
                  alpha = fminf(r[20] * g, kAlphaClamp);
                  if (alpha < kAlphaCutoff || !(t > 1e-6f)) alpha = 0.0f;
                }
                const float q = 1.0f - alpha;
                const float p2 = q * q1[(i + kScanUnroll - 1) % kScanUnroll];
                const float p4 = p2 * q2[(i + kScanUnroll - 2) % kScanUnroll];
                const float p8 = p4 * q4[(i + kScanUnroll - 4) % kScanUnroll];
                const float incl =
                    (p8 * q8[(i + kScanUnroll - 8) % kScanUnroll]) * t_in;
                q1[i] = q;
                q2[i] = p2;
                q4[i] = p4;
                q8[i] = p8;
                if (incl > kTEps) t_fin[0] = fminf(t_fin[0], incl);
                if (alpha > 0.0f && incl > kTEps) {
                  const auto* chart = slots.chart(s, base + s);
                  const float w = alpha * excl;
                  const float b1ud = r[12] * e0 + r[13] * e1 + r[14] * e2;
                  const float b2ud = r[16] * e0 + r[17] * e1 + r[18] * e2;
                  const float uvu =
                      fminf(fmaxf(0.5f + r[15] + t * b1ud, 0.0f), 1.0f);
                  const float uvv =
                      fminf(fmaxf(0.5f + r[19] + t * b2ud, 0.0f), 1.0f);
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
                  const auto* c00 = chart + (x0i * cw + y0i) * 3;
                  const auto* c01 = chart + (x0i * cw + y1i) * 3;
                  const auto* c10 = chart + (x1i * cw + y0i) * 3;
                  const auto* c11 = chart + (x1i * cw + y1i) * 3;
#pragma unroll
                  for (int c = 0; c < 3; ++c) {
                    const float tex =
                        (1.0f - fx) * ((1.0f - fy) * load_texel(c00 + c) +
                                       fy * load_texel(c01 + c)) +
                        fx * ((1.0f - fy) * load_texel(c10 + c) +
                              fy * load_texel(c11 + c));
                    acc[c][0] = acc[c][0] + w * r[21 + c];
                    acc[3 + c][0] = acc[3 + c][0] + w * tex;
                  }
                  acc[6][0] = acc[6][0] + w * t;
                  if (!lean) {
                    float invtc;
                    const float m = depth_map<kV1>(t, safe_nd, r[3], invtc);
                    const float wfl = w * (nd > 0.0f ? -1.0f : 1.0f);
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                      acc[8 + c][0] = acc[8 + c][0] + r[c] * wfl;
                    acc[11][0] =
                        acc[11][0] + 2.0f * w * (m * acc[7][0] - acc[12][0]);
                    acc[12][0] = acc[12][0] + w * m;
                  }
                  acc[7][0] = acc[7][0] + w;
                } else if (alpha > 0.0f && excl > kTEps) {
                  ncon[0] = min(ncon[0], base + s);  // the break: not blended
                }
                excl = incl;
              }
            }
            T[0] = excl;
          }
          rotate_left(T);
          rotate_left(t_fin);
          rotate_left(ncon);
          rotate_left(inside);
#pragma unroll
          for (int c = 0; c < 13; ++c) rotate_left(acc[c]);
        }
      }
    } else {
      for (int s = 0; s < n; ++s) {
        const float* r = s_rec + s * kRec;
        const auto* chart = kEdit ? nullptr : slots.chart(s, base + s);
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
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
          bool surf;
          const float g = falloff<kV1>(r2, arg_s, arg_c, surf);
          float alpha = fminf(r[20] * g, kAlphaClamp);
          if (alpha < kAlphaCutoff || !(t > 1e-6f)) alpha = 0.0f;
          if (!(alpha > 0.0f)) continue;  // T * (1 - 0) == T, weight 0

          const float t_new = T[j] * (1.0f - alpha);
          if constexpr (kEdit) {
            if (t_new > kTEps && t >= ev[4][j] && t <= ev[5][j])
              edit_texels(slots.dchart(s, base + s), r, d0[j], d1[j], d2[j],
                          t, alpha * T[j], ev, j, cw);
            T[j] = t_new;
            continue;
          }
          if (t_new > kTEps) {
            const float w = alpha * T[j];
            const float b1ud = r[12] * d0[j] + r[13] * d1[j] + r[14] * d2[j];
            const float b2ud = r[16] * d0[j] + r[17] * d1[j] + r[18] * d2[j];
            const float uvu =
                fminf(fmaxf(0.5f + r[15] + t * b1ud, 0.0f), 1.0f);
            const float uvv =
                fminf(fmaxf(0.5f + r[19] + t * b2ud, 0.0f), 1.0f);
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
            const auto* c00 = chart + (x0i * cw + y0i) * 3;
            const auto* c01 = chart + (x0i * cw + y1i) * 3;
            const auto* c10 = chart + (x1i * cw + y0i) * 3;
            const auto* c11 = chart + (x1i * cw + y1i) * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float tex =
                  (1.0f - fx) * ((1.0f - fy) * load_texel(c00 + c) +
                                 fy * load_texel(c01 + c)) +
                  fx * ((1.0f - fy) * load_texel(c10 + c) +
                        fy * load_texel(c11 + c));
              acc[c][j] = acc[c][j] + w * r[21 + c];
              acc[3 + c][j] = acc[3 + c][j] + w * tex;
            }
            acc[6][j] = acc[6][j] + w * t;
            if constexpr (!kEval) {
              if (!lean) {
                float invtc;
                const float m = depth_map<kV1>(t, safe_nd, r[3], invtc);
                const float wfl = w * (nd > 0.0f ? -1.0f : 1.0f);
#pragma unroll
                for (int c = 0; c < 3; ++c)
                  acc[8 + c][j] = acc[8 + c][j] + r[c] * wfl;
                acc[11][j] =
                    acc[11][j] + 2.0f * w * (m * acc[7][j] - acc[12][j]);
                acc[12][j] = acc[12][j] + w * m;
              }
            }
            acc[7][j] = acc[7][j] + w;
            t_fin[j] = t_new;
          } else {
            ncon[j] = base + s;  // the break splat: not blended
          }
          T[j] = t_new;
        }
      }
    }
    alive = false;
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      alive = alive || (inside[j] && T[j] > kTEps);
  }
  if constexpr (kRing) cp_async_wait<0>();  // a copy the walk left unread

  const long long plane = static_cast<long long>(height) * width;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!inside[j]) continue;
    const int p = tid + j * kBlock;
    const long long o = static_cast<long long>(ty * tile_h + p / tile_w) * width
                        + tx * tile_w + p % tile_w;
    if constexpr (kEdit) {
      // the output is the texel REDs
    } else if constexpr (kEval) {
#pragma unroll
      for (int c = 0; c < 8; ++c) out[c * plane + o] = acc[c][j];
    } else {
#pragma unroll
      for (int c = 0; c < 12; ++c) out[c * plane + o] = acc[c][j];
      out[12 * plane + o] = t_fin[j];
      out[13 * plane + o] = acc[12][j];
      ncontrib[o] = ncon[j];
    }
  }
}

// One block per tile, 256 threads with 4 pixels each (kBlock threads:
// 1024 / kBlock each, rounded up); the tile's 12 cotangent planes and its
// alpha and m1 maps sit in the first kPlanes * pix floats of dynamic
// shared memory. Each pixel
// walks the tile's slots from min(count, max ncontrib + 1) down to 0 and
// skips a splat at once where it has no weight (rank >= ncontrib, or
// alpha == 0): every gradient term of such a pair is zero. Record
// gradients are summed per chunk in s_drec (a warp shuffle reduction, one
// shared atomic per warp and field; with kShflT transposed, so that lane f
// makes field f's) and handed to slots.end; texel gradients are added at
// slots.dchart.
//
// The fetch is the forward's 2 x 2 bilinear form, so its weights are the
// forward's to the last bit; its derivative in x is row1 - row0 (and
// likewise in y). That is the TPU kernels' hat-function form everywhere but
// where a sample sits exactly on a texel, which is handled apart: there the
// derivative is two-sided, as theirs.
template <int kChunk, class Slots, bool kV1 = false, bool kRing = false,
          bool kShflT = false, int kBlock = kThreads, bool kV3 = false>
__device__ __forceinline__ void backward_tile(
    const Slots& slots, int tile, const int* __restrict__ counts,
    const float* __restrict__ cam_info, const float* __restrict__ maps,
    const int* __restrict__ ncontrib, const float* __restrict__ gmaps,
    int ntx, int tile_h, int tile_w, int height, int width, int ch, int cw,
    int s_max, int lean) {
  // kBlock threads share the tile's 1024 pixel slots
  constexpr int kPix = (kThreads * kPixPerThread + kBlock - 1) / kBlock;
  extern __shared__ float s_pl[];  // kPlanes * pix, then what Slots keeps
  // kRing: two buffers, 16-byte aligned for cp.async
  __shared__ __align__(kRing ? 16 : 4)
      float s_ring[(kRing ? 2 : 1) * kChunk * kRec];
  __shared__ float s_drec[kChunk * kRec];
  __shared__ float cam[kCam];
  __shared__ int s_top;
  const int pix = tile_h * tile_w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kCam) cam[tid] = cam_info[tid];
  if (tid == 0) s_top = -1;
  __syncthreads();

  const int count = min(counts[tile], s_max);
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  const long long plane = static_cast<long long>(height) * width;

  float gx[kPix], gy[kPix];
  float d0[kPix], d1[kPix], d2[kPix];
  // T: after the slot walked last; kV3: after the chunk (t_end), and P
  // the product of 1 - alpha over the chunk's slots walked since
  float T[kPix], BS[kPix], E[kPix], D[kPix];
  float P[kV3 ? kPix : 1];
  int ncon[kPix];
  bool inside[kPix];
  int top = -1;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = tid + j * kBlock;
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
    if constexpr (kV3) P[j] = 1.0f;
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
  if constexpr (kRing)
    for (int i = tid; i < kChunk * kRec; i += kBlock) s_drec[i] = 0.0f;
  __syncthreads();
  const int walk = min(count, s_top + 1);
  const int last = ((walk - 1) / kChunk) * kChunk;
  if constexpr (kRing) {
    if (walk > 0)
      slots.prefetch(last, walk - last,
                     s_ring + ((last / kChunk) & 1) * kChunk * kRec, tid);
    cp_async_commit();
  }

  for (int base = last; base >= 0 && walk > 0; base -= kChunk) {
    const int n = min(kChunk, walk - base);
    const float* s_rec = s_ring;
    if constexpr (kRing) {
      // the next buffer was last read by the walk of the chunk above,
      // which the barrier before its end() closed
      s_rec = s_ring + ((base / kChunk) & 1) * kChunk * kRec;
      const int next = base - kChunk;
      if (next >= 0)
        slots.prefetch(next, kChunk,
                       s_ring + ((next / kChunk) & 1) * kChunk * kRec, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's copies, not the next one's
    } else {
      slots.begin(base, n, s_ring, s_drec, tid);
    }
    __syncthreads();

    for (int s = n - 1; s >= 0; --s) {
      const int k = base + s;
      const float* r = s_rec + s * kRec;
      const auto* chart = slots.chart(s, k);
      float* dch = slots.dchart(s, k);
      // kShflT pads the fields to a warp's 32 lanes
      float v[kShflT ? 32 : kFields];
#pragma unroll
      for (int f = 0; f < (kShflT ? 32 : kFields); ++f) v[f] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!inside[j] || k >= ncon[j]) continue;
        const int p = tid + j * kBlock;
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
        bool surf;
        const float g = falloff<kV1>(r2, arg_s, arg_c, surf);
        const float opg = r[20] * g;
        float alpha = fminf(opg, kAlphaClamp);
        if (alpha < kAlphaCutoff || !(t > 1e-6f)) alpha = 0.0f;
        if (!(alpha > 0.0f)) continue;  // no weight: every term is zero
        any = true;

        float inv_q, one_minus, t_k;
        if constexpr (kV3) {
          one_minus = 1.0f - alpha;
          P[j] = one_minus * P[j];
          t_k = T[j] / P[j];
        } else {
          inv_q = 1.0f / (1.0f - alpha);
          t_k = T[j] * inv_q;
        }
        const float w = alpha * t_k;
        const float* gp = s_pl + p;  // plane c at gp[c * pix]
        const float g_reg = gp[11 * pix];
        float m = 0.0f, invtc = 0.0f, wm = 0.0f, big_a = 0.0f, big_c = 0.0f,
              d_m = 0.0f;
        if (!lean) {
          m = depth_map<kV1>(t, safe_nd, r[3], invtc);
          wm = w * m;
          big_a = gp[12 * pix] - w - E[j];
          big_c = gp[13 * pix] - wm - D[j];
          d_m = 2.0f * g_reg * w * (big_a - E[j]);
        }

        // texels: the forward's four, and the fetch's derivatives
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
        float d_x = 0.0f, d_y = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float c00 = load_texel(chart + o00 + c);
          const float c01 = load_texel(chart + o01 + c);
          const float c10 = load_texel(chart + o10 + c);
          const float c11 = load_texel(chart + o11 + c);
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
        // A sample exactly on a texel row or column (float32 charts of 8
        // or 16 texels meet one a few times a frame): the hat weights'
        // derivative is two-sided there, one texel each way, and texels
        // outside the padded chart read as zero.
        if (fx == 0.0f || fy == 0.0f) {
          const auto texel = [&](int row, int col, int c) {
            return (row >= 0 && row < ch && col >= 0 && col < cw)
                       ? load_texel(chart + (row * cw + col) * 3 + c)
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

        float s_k = r[21] * gp[0] + r[22] * gp[pix] + r[23] * gp[2 * pix] +
                    texk[0] * gt[0] + texk[1] * gt[1] + texk[2] * gt[2] +
                    t * gp[6 * pix] + gp[7 * pix];
        const float fl = nd > 0.0f ? -1.0f : 1.0f;
        if (!lean) {
          s_k = s_k + fl * (r[0] * gp[8 * pix] + r[1] * gp[9 * pix] +
                            r[2] * gp[10 * pix]);
          s_k = s_k + 2.0f * g_reg * ((m * big_a - big_c) + (D[j] - m * E[j]));
        }
        const float sw = s_k * w;
        float d_alpha;
        if constexpr (kV3)
          d_alpha = t_k * s_k - BS[j] / one_minus;
        else
          d_alpha = t_k * s_k - BS[j] * inv_q;

        if (!(x_raw >= 0.0f && x_raw <= hf - 1.0f)) d_x = 0.0f;
        if (!(y_raw >= 0.0f && y_raw <= wf - 1.0f)) d_y = 0.0f;
        const bool interior =
            opg <= kAlphaClamp && opg >= kAlphaCutoff && t > 1e-6f;
        const float dag = interior ? d_alpha : 0.0f;
        const float d_op = g * dag;
        const float d_g = r[20] * d_op;
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
        if (!lean) {
          if constexpr (kV1) {
            const float tc = fmaxf(t, kRegNear);
            d_t = d_t + (t >= kRegNear ? d_m * kKfac * kRegNear / (tc * tc)
                                       : 0.0f);
          } else {
            d_t = d_t +
                  (t >= kRegNear ? d_m * kKfacNear * invtc * invtc : 0.0f);
          }
        }
        d_t = d_t + d_u * b1d + d_v * b2d;
        d_t = d_t + d_uvu * b1ud + d_uvv * b2ud;
        float d_an, d_nd;
        if constexpr (kV1) {
          d_an = d_t / safe_nd;
          d_nd = fabsf(nd) >= 1e-9f ? -t / safe_nd * d_t : 0.0f;
        } else {
          d_an = d_t * (1.0f / safe_nd);
          d_nd = fabsf(nd) >= 1e-9f ? -t * d_an : 0.0f;
        }

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
        if constexpr (!kV3) T[j] = t_k;
      }
      // kV3: slot k begins a chunk of 16, so T after the chunk before it
      // is this chunk's t_end over its product, at every pixel, whichever
      // slots it skipped
      if constexpr (kV3) {
        if ((k & 15) == 0) {
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            T[j] = T[j] / P[j];
            P[j] = 1.0f;
          }
        }
      }
      // record grads: warp sums, then one shared atomic per warp and field
      if (__any_sync(0xffffffffu, any)) {
        if constexpr (kShflT) {
          // transposed: the 20 fields padded to 32, folded 32 -> 16 -> 8
          // -> 4 -> 2 -> 1 (31 shuffles); lane f ends with field f's sum
          warp_fold<16>(v, v, lane);
          warp_fold<8>(v, v, lane);
          warp_fold<4>(v, v, lane);
          warp_fold<2>(v, v, lane);
          warp_fold<1>(v, v, lane);
          // kFieldOf[lane], without a divergent constant-memory read
          const int field = lane < 12   ? lane
                            : lane < 14 ? 15 + 4 * (lane - 12)
                                        : lane + 6;
          if (lane < kFields && v[0] != 0.0f)
            atomicAdd(s_drec + s * kRec + field, v[0]);
        } else {
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
    }
    __syncthreads();
    slots.end(base, n, s_drec, tid);
    if constexpr (kRing) {
      // each thread zeroes what its end() read: no barrier before the
      // next chunk's prefetch, the one after it covers the next walk
      for (int i = tid; i < n * kRec; i += kBlock) s_drec[i] = 0.0f;
    } else {
      __syncthreads();
    }
  }
  if constexpr (kRing) cp_async_wait<0>();
}

}  // namespace
