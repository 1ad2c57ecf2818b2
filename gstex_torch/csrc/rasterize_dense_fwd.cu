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
// What bounds it on the H100: operations, as for the flat kernel: ~34 fp32
// operations per (pixel, pair) response and ~75 per blend, against one
// 128 B record per pair per tile and four texels per blend.
//
// The design, for Hopper: the flat forward's (csrc/rasterize_fwd.cu) on
// the dense lists.
// - The walk is forward_tile in tile_walk.cuh: one block per tile, 256
//   threads with 4 pixels each; a pixel's ray, T and sums stay in
//   registers; the tile leaves its walk once no in-image pixel has
//   T > T_EPS. Slot k of a tile is gaussian ids[tile, k] (IdSlots).
// - Only the records are staged in shared memory, kChunk a chunk in a ring
//   of two buffers filled by cp.async (chunk c + 1's records are in flight
//   while chunk c is walked), whatever the chart pad. A blend fetches its
//   four texels from device memory: the active texels of a scene sit in
//   the 50 MB L2, and neighbouring pixels fetch neighbouring texels.
// - 128 registers (__launch_bounds__ minimum 2 blocks an SM): 16 warps an
//   SM.
// - Tiles start longest first (`order`: the tiles by count capped at
//   s_max, descending), so the long tiles do not trail the grid.
// Each choice was measured against its alternatives (PERF.md §6).
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize.py:forward_scan) does, in the same
// per-pixel order, so the maps and ncontrib are bit-equal to it under any
// tile order.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;  // the ring's ids (IdSlots)
using Slots = IdSlots<kChunk, kIdBufs>;

// Block b walks tile order[b].
__global__ void __launch_bounds__(kThreads, 2)
rasterize_dense_fwd_kernel(const float* __restrict__ records,
                           const int* __restrict__ ids,
                           const int* __restrict__ counts,
                           const float* __restrict__ charts,
                           const float* __restrict__ cam_info,
                           float* __restrict__ out,
                           int* __restrict__ ncontrib,
                           const int* __restrict__ order, int ntx, int tile_h,
                           int tile_w, int height, int width, int ch, int cw,
                           int s_max, int lean) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  // slot k of the tile is gaussian ids[tile, k]
  const Slots slots{records, ids + static_cast<long long>(tile) * s_max,
                    charts, nullptr, nullptr,
                    static_cast<long long>(ch) * cw * 3, s_id};
  forward_tile<kChunk, Slots, false, true>(
      slots, tile, counts, cam_info, out, ncontrib, ntx, tile_h, tile_w,
      height, width, cw, s_max, lean);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; records must be
// 16-byte aligned (cp.async); `order` holds the num_tiles tiles in the
// order blocks take them; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_dense_fwd(
    const void* records, const void* ids, const void* counts,
    const void* charts, const void* cam_info, void* out, void* ncontrib,
    const void* order, int num_tiles, int ntx, int tile_h, int tile_w,
    int height, int width, int ch, int cw, int s_max, int lean,
    void* stream) {
  if (num_tiles == 0) return 0;
  rasterize_dense_fwd_kernel<<<num_tiles, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(ids),
      static_cast<const int*>(counts), static_cast<const float*>(charts),
      static_cast<const float*>(cam_info), static_cast<float*>(out),
      static_cast<int*>(ncontrib), static_cast<const int*>(order), ntx,
      tile_h, tile_w, height, width, ch, cw, s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
