// Backward of the v1 pair-space training forward (csrc/rasterize_v1_fwd.cu):
// the back-to-front gradient walk over each tile's own slots, writing
// pair-space gradients, in the v1 kernels' arithmetic.
//
// Replaces: gstex_tpu/ops/rasterize_pallas_bwd.py, _bwd_kernel (launched by
// rasterize_pallas_bwd). For each pixel it walks the tile's slots from
// min(count, max ncontrib + 1) down to 0, recovers T before each applied
// splat as T_{k+1} / (1 - alpha_k) from t_final, keeps the suffix sums of
// s*w (and of w and w*m for the reg chain), and writes the gradients of
// record fields 0-11, 15, 19-25 of slot (t, s) into d_records_t (T, S, 32)
// and of the texels of its bilinear fetch into d_charts_g (T, S, Ch, Cw, 3).
// Fields 12-14, 16-18 (the detached uv frame) get none. The reduction to
// per-gaussian gradients is autograd's, through the gathers that made the
// pair-space inputs.
//
// v1 is the v2 backward (csrc/rasterize_v2_bwd.cu) with v1's rounding: the
// falloff as the larger of two exps, and the surfel-or-screen branch of
// its gradient chosen by comparing them; m by a divide; the m chain
// d_m * KFAC * NEAR / (tc * tc), d_a_n = d_t / n.d and d_n.d =
// -t / n.d * d_t by divides, where v2 multiplies by reciprocals.
//
// What bounds it on the H100: operations (~300 fp32 operations per applied
// (pixel, pair), ~40 per walked one). Bytes: one record read and one
// record gradient written per slot, four texels read and four texel
// gradients added per applied (pixel, pair).
//
// The design, for Hopper: the v2 backward's, under v1's arithmetic
// (backward_tile in tile_walk.cuh with kV1 set, on pair_slots.cuh's
// PairRingSlots): one block per tile, the tile's 12 cotangent planes and
// its alpha and m1 maps in dynamic shared memory and nothing else of the
// chart pad's size; 384 threads with 3 pixels each; records staged 64 a
// chunk in a cp.async ring of two buffers; tiles longest first (`order`,
// one a training step from _RasterizePairs); the record gradients of a
// (warp, slot) reduced transposed (kShflT); texel gradients added into
// the slot's own region of d_charts_g as REDs. The first port was the v2
// backward as it stood before that redesign (16 a chunk, chart gradients
// staged where they fit, block order, lane-0 reduction, 256 threads).
// Each option was measured (PERF.md §6).
//
// Precision: no --use_fast_math, --fmad=false and true IEEE divides. The
// plain version (ops/rasterize_v1.py: ops/rasterize.py:backward_walk with
// v1's arithmetic on the pair-space view) pulls the local math back with
// autograd and sums in scan order; this kernel writes the chain rule out
// and sums by shuffles and atomics, so the two agree to rounding, not
// bitwise.

#include "pair_slots.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kBlock = 384;    // threads a block; 3 pixels each
constexpr bool kShflT = true;  // the transposed record-gradient reduction
using Slots = PairRingSlots<kChunk, kBlock>;

// dynamic shared memory of a launch: the tile's kPlanes per-pixel planes
size_t dynamic_smem(int tile_h, int tile_w) {
  return static_cast<size_t>(kPlanes) * tile_h * tile_w * sizeof(float);
}

// Block b walks tile order[b].
__global__ void __launch_bounds__(kBlock, 1)
rasterize_v1_bwd_kernel(const float* __restrict__ records_t,
                        const float* __restrict__ charts_g,
                        const int* __restrict__ counts,
                        const float* __restrict__ cam_info,
                        const float* __restrict__ maps,
                        const int* __restrict__ ncontrib,
                        const float* __restrict__ gmaps,
                        float* __restrict__ d_records_t,
                        float* __restrict__ d_charts_g,
                        const int* __restrict__ order, int ntx, int tile_h,
                        int tile_w, int height, int width, int ch, int cw,
                        int s_max, int lean) {
  const int tile = order[blockIdx.x];
  const Slots slots(records_t, charts_g, d_records_t, d_charts_g, ch, cw,
                    s_max, tile, nullptr);
  backward_tile<kChunk, Slots, true, true, kShflT, kBlock>(
      slots, tile, counts, cam_info, maps, ncontrib, gmaps, ntx, tile_h,
      tile_w, height, width, ch, cw, s_max, lean);
}

}  // namespace

// Shared memory of a launch at tile_h x tile_w tiles, in bytes: the
// kernel's static arrays and its dynamic part (no chart pad enters).
extern "C" int gstex_rasterize_v1_bwd_smem(int tile_h, int tile_w) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, rasterize_v1_bwd_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>(a.sharedSizeBytes + dynamic_smem(tile_h, tile_w));
}

// Plain C entry for ctypes. Pointers are device pointers; records_t must be
// 16-byte aligned (cp.async); d_records_t and d_charts_g must be zeroed;
// `order` holds the num_tiles tiles in the order blocks take them;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int gstex_rasterize_v1_bwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, const void* maps, const void* ncontrib,
    const void* gmaps, void* d_records_t, void* d_charts_g, const void* order,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  const size_t smem = dynamic_smem(tile_h, tile_w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_v1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_v1_bwd_kernel<<<num_tiles, kBlock, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records_t),
      static_cast<const float*>(charts_g), static_cast<const int*>(counts),
      static_cast<const float*>(cam_info), static_cast<const float*>(maps),
      static_cast<const int*>(ncontrib), static_cast<const float*>(gmaps),
      static_cast<float*>(d_records_t), static_cast<float*>(d_charts_g),
      static_cast<const int*>(order), ntx, tile_h, tile_w, height, width, ch,
      cw, s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
