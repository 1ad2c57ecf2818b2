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
// What bounds it on the H100: operations. Each (pixel, pair) response costs
// ~34 fp32 operations and each blend ~75 (~96 with the normal and reg),
// against one 128 B record per pair per tile and four texels per blend.
// The walk has no matrix product, so the tensor cores have nothing to do.
//
// The design, for Hopper:
// - The walk is forward_tile in tile_walk.cuh, the dense-list kernel's: one
//   block per tile, 256 threads with 4 pixels each, a pixel's ray, T and
//   sums in registers, and the tile leaves its walk once no in-image pixel
//   has T > T_EPS (ncontrib of an in-image pixel does not depend on where
//   the walk stops; out-of-image pixels are not walked and not written).
//   Slot k of a tile is gids[starts[tile] + k] (IdSlots).
// - Nothing in shared memory depends on the chart pad: only records are
//   staged, kChunk a chunk, in a ring of two buffers filled by cp.async, so
//   that chunk c + 1's records are in flight while chunk c is walked. A
//   blend reads its four texels from device memory through the read-only
//   path: a scene's active texels (~12 B per texel of pixel_num) sit in the
//   50 MB L2, and neighbouring pixels read neighbouring texels.
// - 128 registers (__launch_bounds__ minimum 2 blocks an SM, no spills):
//   16 warps an SM where the compiler alone picks ~150 and 8.
// - Tiles start longest first (`order`, the tiles by count, descending), so
//   the long tiles do not trail the grid.
// Each choice was measured against its alternatives (PERF.md §6): a
// persistent grid taking tiles from a counter, 3 blocks an SM and 32
// records a chunk were slower, and staging without the ring too.
//
// Precision: no --use_fast_math and --fmad=false; every operation rounds
// as the plain version's (ops/rasterize_fwd.py) does, in the same order.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;  // the ring's ids (IdSlots)
using Slots = IdSlots<kChunk, kIdBufs>;

// Block b walks tile order[b].
__global__ void __launch_bounds__(kThreads, 2)
rasterize_fwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ gids,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const float* __restrict__ charts,
                     const float* __restrict__ cam_info,
                     float* __restrict__ out, int* __restrict__ ncontrib,
                     const int* __restrict__ order, int ntx, int tile_h,
                     int tile_w, int height, int width, int ch, int cw,
                     int s_cap, int lean) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  const Slots slots{records, gids + starts[tile], charts, nullptr, nullptr,
                    static_cast<long long>(ch) * cw * 3, s_id};
  forward_tile<kChunk, Slots, false, true>(
      slots, tile, counts, cam_info, out, ncontrib, ntx, tile_h, tile_w,
      height, width, cw, s_cap, lean);
}

}  // namespace

// Shared memory of a launch, in bytes: the kernel's static arrays. There
// is no dynamic part, so it is the same for every tile size and chart pad.
extern "C" int gstex_rasterize_fwd_smem() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, rasterize_fwd_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>(a.sharedSizeBytes);
}

// Plain C entry for ctypes. Pointers are device pointers; records must be
// 16-byte aligned (cp.async); `order` holds the num_tiles tiles in the
// order blocks take them; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_fwd(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info, void* out,
    void* ncontrib, const void* order, int num_tiles, int ntx, int tile_h,
    int tile_w, int height, int width, int ch, int cw, int s_cap, int lean,
    void* stream) {
  if (num_tiles == 0) return 0;
  rasterize_fwd_kernel<<<num_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(gids),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(charts), static_cast<const float*>(cam_info),
      static_cast<float*>(out), static_cast<int*>(ncontrib),
      static_cast<const int*>(order), ntx, tile_h, tile_w, height, width, ch,
      cw, s_cap, lean);
  return static_cast<int>(cudaGetLastError());
}
