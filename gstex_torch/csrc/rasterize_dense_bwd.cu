// Backward of the dense-list training forward (csrc/rasterize_dense_fwd.cu):
// the back-to-front gradient walk over ids (num_tiles, s_max), with the
// per-gaussian reduction fused in.
//
// Replaces: gstex_tpu/ops/rasterize_pallas4.py, _bwd_kernel4 (launched by
// rasterize_pallas4_bwd), and what follows it in
// rasterize_pallas_api.py:_core4_bwd: the segment sum of its pair-space
// record and chart gradients (_reduce_d_charts) and the tile batching that
// bounds that buffer. For each pixel it walks the tile's splats from
// min(count, max ncontrib + 1) down to 0, recovers T before each applied
// splat as T_{k+1} / (1 - alpha_k) from t_final, keeps the suffix sums of
// s*w (and of w and w*m for the reg chain), and adds the gradients of
// record fields 0-11, 15, 19-25 into d_records (N, 32) and of the four
// texels of the bilinear fetch into d_charts (N, Ch, Cw, 3). Fields 12-14,
// 16-18 (the detached uv frame) get none.
//
// What bounds it on the H100: operations (~350 fp32 operations per applied
// (pixel, pair), ~390 with the normal and reg; ~34 per walked one); the
// bytes are one record read and one record gradient added per pair per
// tile, four texels read and four texel gradients added per applied
// (pixel, pair). The walk has no matrix product, so the tensor cores have
// nothing to do.
//
// The design, for Hopper:
// - The walk and chain rule are backward_tile in tile_walk.cuh, shared
//   with the flat, v2 and v1 kernels: one block per tile; the tile's 12
//   cotangent planes and its alpha and m1 maps in shared memory (57 KB at
//   32 x 32 tiles). Slot k of a tile is ids[tile, k] (IdSlots); its
//   gradients are added per gaussian.
// - 384 threads a block with 3 pixels each (kBlock; the other backwards
//   take 256 with 4): 160 registers, no spills, 12 warps an SM where 256
//   threads need 184 registers and leave 8. 512 threads with 2 pixels
//   each (16 warps at 128 registers) spill.
// - Nothing in shared memory depends on the chart pad. Records are staged
//   kChunk a chunk in a ring of two buffers filled by cp.async (chunk
//   c - 1's records fly while chunk c is walked), as in the flat backward.
//   Texels are read from device memory (the active ones sit in L2), and
//   each texel gradient goes straight to d_charts with a global atomicAdd
//   whose result is unused (a RED): no pair-space gradient buffer exists,
//   so there is nothing to batch over tiles.
// - Tiles start longest first (`order`: the tiles by count capped at
//   s_max, descending), so the long tiles do not trail the grid.
// - The record gradients of a (warp, splat) are reduced transposed
//   (kShflT): the 20 fields, padded to 32, are folded in five rounds of
//   __shfl_xor_sync, each lane handing half of its remaining fields to its
//   partner, 31 shuffles in all; lane f ends with field f's warp sum and
//   adds it to the chunk's sums in shared memory. The lane-0 reduction it
//   replaces took 5 shuffles for each of the 20 fields (100) and 20 shared
//   atomics from one lane, whatever few lanes had applied the splat.
//   Summed per chunk, the record gradients leave with one global atomicAdd
//   per non-zero field.
// - The fetch is the forward's 2 x 2 bilinear form, so its weights are the
//   forward's to the last bit; its derivative in x is row1 - row0 (and
//   likewise in y). That is the hat-function form of the TPU kernel and of
//   the plain versions everywhere but where a sample sits exactly on a
//   texel, which is handled apart: there the derivative is two-sided, as
//   theirs.
// - A pixel skips a splat at once where it has no weight (rank >=
//   ncontrib, or alpha == 0): every gradient term of such a pair is zero.
// Each choice was measured against its alternatives (PERF.md §6), in
// turn at (64, 128): the ring alone gains ~1 %, the tile order ~14 %, the
// transposed reduction ~24 %, 384 threads ~7 % more; 512 threads are as
// fast but spill; 32 records a chunk is slower.
//
// Precision: no --use_fast_math and --fmad=false. The plain version
// (ops/rasterize.py:backward_walk) pulls the local math back with autograd
// and sums in scan order; this kernel writes the chain rule out and sums by
// shuffles and atomics, so the two agree to rounding (a relative
// tolerance), not bitwise.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;       // the ring's ids (IdSlots)
constexpr int kBlock = 384;      // threads a block; 3 pixels each
constexpr bool kShflT = true;    // the transposed record-gradient reduction
using Slots = IdSlots<kChunk, kIdBufs, kBlock>;

// dynamic shared memory of a launch: the tile's kPlanes per-pixel planes
size_t dynamic_smem(int tile_h, int tile_w) {
  return static_cast<size_t>(kPlanes) * tile_h * tile_w * sizeof(float);
}

// Block b walks tile order[b].
__global__ void __launch_bounds__(kBlock, 1)
rasterize_dense_bwd_kernel(const float* __restrict__ records,
                           const int* __restrict__ ids,
                           const int* __restrict__ counts,
                           const float* __restrict__ charts,
                           const float* __restrict__ cam_info,
                           const float* __restrict__ maps,
                           const int* __restrict__ ncontrib,
                           const float* __restrict__ gmaps,
                           float* __restrict__ d_records,
                           float* __restrict__ d_charts,
                           const int* __restrict__ order, int ntx, int tile_h,
                           int tile_w, int height, int width, int ch, int cw,
                           int s_max, int lean) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  // slot k of the tile is gaussian ids[tile, k]
  const Slots slots{records, ids + static_cast<long long>(tile) * s_max,
                    charts, d_records, d_charts,
                    static_cast<long long>(ch) * cw * 3, s_id};
  backward_tile<kChunk, Slots, false, true, kShflT, kBlock>(
      slots, tile, counts, cam_info, maps, ncontrib, gmaps, ntx, tile_h,
      tile_w, height, width, ch, cw, s_max, lean);
}

}  // namespace

// Shared memory of a launch at tile_h x tile_w tiles, in bytes: the
// kernel's static arrays and the per-pixel planes. The chart pad does not
// enter it.
extern "C" int gstex_rasterize_dense_bwd_smem(int tile_h, int tile_w) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, rasterize_dense_bwd_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>(a.sharedSizeBytes + dynamic_smem(tile_h, tile_w));
}

// Plain C entry for ctypes. Pointers are device pointers; records must be
// 16-byte aligned (cp.async); d_records and d_charts must be zeroed;
// `order` holds the num_tiles tiles in the order blocks take them;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int gstex_rasterize_dense_bwd(
    const void* records, const void* ids, const void* counts,
    const void* charts, const void* cam_info, const void* maps,
    const void* ncontrib, const void* gmaps, void* d_records, void* d_charts,
    const void* order, int num_tiles, int ntx, int tile_h, int tile_w,
    int height, int width, int ch, int cw, int s_max, int lean,
    void* stream) {
  const size_t smem = dynamic_smem(tile_h, tile_w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_dense_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_dense_bwd_kernel<<<num_tiles, kBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(ids),
      static_cast<const int*>(counts), static_cast<const float*>(charts),
      static_cast<const float*>(cam_info), static_cast<const float*>(maps),
      static_cast<const int*>(ncontrib), static_cast<const float*>(gmaps),
      static_cast<float*>(d_records), static_cast<float*>(d_charts),
      static_cast<const int*>(order), ntx, tile_h, tile_w, height, width, ch,
      cw, s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
