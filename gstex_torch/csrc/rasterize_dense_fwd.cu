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
// What the design does about it:
// - One block per tile, 256 threads with 4 pixels each; a pixel's ray, T
//   and sums stay in registers; the tile leaves its walk once no in-image
//   pixel has T > T_EPS.
// - Only the records are staged in shared memory, 32 splats a chunk (4 KB,
//   whatever the chart pad). A blend fetches its four texels from device
//   memory: the active texels of a scene sit in the 50 MB L2, and
//   neighbouring pixels fetch neighbouring texels.
// - The walk is forward_tile in tile_walk.cuh, shared with the flat, v2 and
//   v1 kernels; here a slot finds its record and chart through ids
//   (IdSlots). The flat kernel adds a cp.async ring of records and a
//   longest-first tile order on the same walk.
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize.py:forward_scan) does, in the same
// per-pixel order.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 32;

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
  __shared__ int s_id[kChunk];
  // slot k of the tile is gaussian ids[tile, k]
  const IdSlots<kChunk> slots{records,
                              ids + static_cast<long long>(blockIdx.x) * s_max,
                              charts, nullptr, nullptr,
                              static_cast<long long>(ch) * cw * 3, s_id};
  forward_tile<kChunk>(slots, blockIdx.x, counts, cam_info, out, ncontrib,
                       ntx, tile_h, tile_w, height, width, cw, s_max, lean);
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
