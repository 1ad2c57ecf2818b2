// Forward-only textured-surfel blend over the dense per-tile lists: ids
// (num_tiles, s_max) with per-tile counts. The serving render of scenes
// whose charts the dispatch sends past the flat tier, of renderer="pallas4",
// and the eval renders of the pair-space tiers (pallas3, pallas2, pallas1).
//
// Replaces: gstex_tpu/ops/rasterize_pallas4.py, _eval_kernel4 (launched by
// rasterize_pallas4_eval). Computes what csrc/rasterize_eval.cu computes
// for the flat list: per pixel, the tile's splats front to back (ray-plane
// hit, falloff max'd with the sigma^2 = 0.5 screen low-pass, alpha =
// min(o*G, 0.999) with the 1/255 cutoff and t > 1e-6, a 4-texel bilinear
// fetch, the break at T_EPS), written as eight (H, W) planes: img(3),
// tex(3), depth, alpha. It reads TileBins.ids, the (N, 32) records and the
// (N, Ch, Cw, 3) charts as they are.
//
// What bounds it on the H100: operations (~34 fp32 operations per (pixel,
// pair) response, ~75 per blend) against one 128 B record per pair per tile
// and four texels per blend. The walk has no matrix product, so the tensor
// cores have nothing to do.
//
// The design, for Hopper: the flat eval kernel's (csrc/rasterize_eval.cu)
// on the dense ids, which is the dense training forward's
// (csrc/rasterize_dense_fwd.cu) under the eval output policy.
// - The walk is forward_tile in tile_walk.cuh with kEval: one block per
//   tile, 256 threads with 4 pixels each, a pixel's ray, T and eight sums
//   in registers; no t_final, m1 or ncontrib, the normal and reg chains
//   compiled out. The tile leaves its walk once no in-image pixel has
//   T > T_EPS. Slot k of a tile is gaussian ids[tile, k] (IdSlots).
// - Only the records are staged in shared memory, kChunk a chunk in a ring
//   of two buffers filled by cp.async (chunk c + 1's records are in flight
//   while chunk c is walked), whatever the chart pad. A blend reads its
//   four texels from device memory (the active texels sit in the 50 MB
//   L2). The first port staged 32 records a chunk by plain loads, with a
//   barrier pair a chunk.
// - Tiles start longest first (`order`: the tiles by count capped at
//   s_max, descending), so the long tiles do not trail the grid.
// - __launch_bounds__ at 2 blocks an SM (at most 128 registers).
// Each choice was measured against its alternatives (PERF.md §6).
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize.py:forward_scan, lean) does, in the
// same per-pixel order, so the eight planes are bit-equal to it under any
// tile order.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;  // the ring's ids (IdSlots)
using Slots = IdSlots<kChunk, kIdBufs>;

// Block b walks tile order[b].
__global__ void __launch_bounds__(kThreads, 2)
rasterize_dense_eval_kernel(const float* __restrict__ records,
                            const int* __restrict__ ids,
                            const int* __restrict__ counts,
                            const float* __restrict__ charts,
                            const float* __restrict__ cam_info,
                            float* __restrict__ out,
                            const int* __restrict__ order, int ntx,
                            int tile_h, int tile_w, int height, int width,
                            int ch, int cw, int s_max) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  // slot k of the tile is gaussian ids[tile, k]
  const Slots slots{records, ids + static_cast<long long>(tile) * s_max,
                    charts, nullptr, nullptr,
                    static_cast<long long>(ch) * cw * 3, s_id};
  forward_tile<kChunk, Slots, false, true, true>(
      slots, tile, counts, cam_info, out, nullptr, ntx, tile_h, tile_w,
      height, width, cw, s_max, 1);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; records must be
// 16-byte aligned (cp.async); `order` holds the num_tiles tiles in the
// order blocks take them; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_dense_eval(
    const void* records, const void* ids, const void* counts,
    const void* charts, const void* cam_info, void* out, const void* order,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, void* stream) {
  if (num_tiles == 0) return 0;
  rasterize_dense_eval_kernel<<<num_tiles, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(ids),
      static_cast<const int*>(counts), static_cast<const float*>(charts),
      static_cast<const float*>(cam_info), static_cast<float*>(out),
      static_cast<const int*>(order), ntx, tile_h, tile_w, height, width, ch,
      cw, s_max);
  return static_cast<int>(cudaGetLastError());
}
