// Training forward of the textured-surfel blend over the pair-space
// inputs: per (tile, slot) copies of the records, records_t (T, S, 32), and
// of the charts, charts_g (T, S, Ch, Cw, 3), with per-tile counts.
//
// Replaces: gstex_tpu/ops/rasterize_pallas2.py, _fwd_kernel2 (launched by
// rasterize_pallas2_fwd). Computes what csrc/rasterize_dense_fwd.cu
// computes: img, tex, depth, alpha, the camera-facing normal, the 2DGS
// distortion reg, the backward's residuals t_final and m1 as fourteen
// (H, W) planes in CH_NAMES order, and ncontrib (H, W): the slot at which T
// would fall to T_EPS (not blended), else S. lean != 0 skips the normal and
// reg chains; their planes are zero.
//
// The TPU kernel packs each slot's chart a-major onto 128 lanes and fetches
// texels by a matmul against hat weights; none of that layout is carried
// over. This kernel reads each slot's own record and chart where the dense
// kernel reads them through TileBins.ids.
//
// What bounds it on the H100: operations, as for the dense kernel (~40
// fp32 operations per (pixel, pair) response, ~90 per blend). Its bytes
// differ: every tile reads its own copy of a chart, so the texels of a
// splat that covers many tiles are fetched once per tile (no sharing in
// L2), and the copies themselves were written by the gather before it.
//
// The design, for Hopper: the v3 and v1 forwards' (forward_tile in
// tile_walk.cuh, the dense forward's walk on pair_slots.cuh's PairFwdSlots).
// - One block per tile, 512 threads with 2 pixels each, one block an SM
//   (16 warps, 128 registers); a pixel's ray, T and sums stay in
//   registers; the tile leaves its walk once no in-image pixel has
//   T > T_EPS. A pixel's walk is serial in its thread and the kernel ends
//   with its heaviest tile, so twice the threads a tile shorten that
//   tile's time.
// - Records are staged 64 a chunk in a ring of two buffers filled by
//   cp.async (a chunk's records are contiguous), chunk c + 1's in flight
//   while chunk c is walked. A blend fetches its four texels from the
//   slot's own chart in device memory.
// - Tiles start longest first (`order`, one a training step from
//   _RasterizePairs, which hands it to the v2 backward too).
// The first port staged 16 records a chunk by plain loads behind a barrier
// pair, in block order, with 256 threads and no minimum of blocks an SM.
// Each choice was measured against its alternatives (PERF.md §6).
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize_v2.py: the serial walk of
// ops/rasterize.py:forward_scan on the pair-space view) does, in the same
// per-pixel order, so the maps and ncontrib are bit-equal to it under any
// tile order.

#include "pair_slots.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kBlock = 512;  // threads a block; 1024 / kBlock pixels each
using Slots = PairFwdSlots<kBlock>;

// Block b walks tile order[b].
__global__ void __launch_bounds__(kBlock, 1)
rasterize_v2_fwd_kernel(const float* __restrict__ records_t,
                        const float* __restrict__ charts_g,
                        const int* __restrict__ counts,
                        const float* __restrict__ cam_info,
                        float* __restrict__ out, int* __restrict__ ncontrib,
                        const int* __restrict__ order, int ntx, int tile_h,
                        int tile_w, int height, int width, int ch, int cw,
                        int s_max, int lean) {
  const int tile = order[blockIdx.x];
  const Slots slots(records_t, charts_g, ch, cw, s_max, tile);
  forward_tile<kChunk, Slots, false, true, false, kBlock>(
      slots, tile, counts, cam_info, out, ncontrib, ntx, tile_h, tile_w,
      height, width, cw, s_max, lean);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; records_t must be
// 16-byte aligned (cp.async); `order` holds the num_tiles tiles in the
// order blocks take them; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_v2_fwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, void* out, void* ncontrib, const void* order,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  if (num_tiles == 0) return 0;
  rasterize_v2_fwd_kernel<<<num_tiles, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records_t),
      static_cast<const float*>(charts_g), static_cast<const int*>(counts),
      static_cast<const float*>(cam_info), static_cast<float*>(out),
      static_cast<int*>(ncontrib), static_cast<const int*>(order), ntx,
      tile_h, tile_w, height, width, ch, cw, s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
