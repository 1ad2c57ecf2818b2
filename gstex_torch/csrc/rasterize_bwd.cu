// Backward of the training forward (csrc/rasterize_fwd.cu): the
// back-to-front gradient walk over the flat (tile, depth, id) pair list,
// with the per-gaussian reduction fused in.
//
// Replaces: gstex_tpu/ops/rasterize_pallas5.py, _bwd_kernel5 (launched by
// rasterize_pallas5_bwd), and the segment_sum of its per-pair rows in
// rasterize_pallas_api.py:_core5_bwd. For each pixel it walks the tile's
// splats from min(count, max ncontrib + 1) down to 0, recovers T before
// each applied splat as T_{k+1} / (1 - alpha_k) from t_final, keeps the
// suffix sums of s*w (and of w and w*m for the reg chain), and adds the
// gradients of record fields 0-11, 15, 19-25 into d_records (N, 32) and of
// the texels of the bilinear fetch into d_charts (N, Ch, Cw, 3). Fields
// 12-14, 16-18 (the detached uv frame) get none.
//
// What bounds it on the H100: operations (~350 fp32 operations per applied
// (pixel, pair), ~390 with the normal and reg; ~34 per walked one); the
// bytes are one record read and one record gradient added per pair per
// tile, four texels read and four texel gradients added per applied
// (pixel, pair). The walk has no matrix product, so the tensor cores have
// nothing to do.
//
// The design, for Hopper:
// - The walk and chain rule are backward_tile in tile_walk.cuh, the
//   dense-list kernel's: one block per tile, 256 threads with 4 pixels
//   each; the tile's 12 cotangent planes and its alpha and m1 maps in
//   shared memory (57 KB at 32 x 32 tiles). Slot k of a tile is
//   gids[starts[tile] + k] (IdSlots).
// - Nothing in shared memory depends on the chart pad. Records are staged
//   kChunk a chunk in a ring of two buffers filled by cp.async (chunk
//   c - 1's records fly while chunk c is walked); their gradients are
//   summed per chunk in shared memory (a warp shuffle reduction, one shared
//   atomic per warp and field) and leave with one global atomicAdd per
//   non-zero field. Texels are read from device memory (the active ones
//   sit in L2), and each texel gradient goes straight to d_charts with a
//   global atomicAdd whose result is unused (a RED).
// - The fetch is the forward's 2 x 2 bilinear form, so its weights are the
//   forward's to the last bit; its derivative in x is row1 - row0 (and
//   likewise in y). That is the TPU kernel's hat-function form (the plain
//   version's) everywhere but where a sample sits exactly on a texel,
//   which is handled apart: there the derivative is two-sided, as theirs.
// - A pixel skips a splat at once where it has no weight (rank >=
//   ncontrib, or alpha == 0): every gradient term of such a pair is zero.
// - Tiles start longest first (`order`), so the long tiles do not trail
//   the grid. That, not the ring, is most of the gain over the dense
//   kernel. The block keeps the compiler's ~186 registers (one block, 8
//   warps, an SM).
// Each choice was measured against its alternatives (PERF.md §6): capped
// at 128 registers for two blocks an SM the walk spills and is slower, and
// so are summing a warp's texel gradients (__match_any_sync) before the
// atomics, a persistent grid taking tiles from a counter, 32 records a
// chunk, and staging without the ring.
//
// The chart type: float32, or bfloat16 (the bf16 chart stream,
// gstex_rasterize_bwd_bf16): a bf16 texel is widened to float as it is
// read (load_texel); the texel gradients are float32 either way, and do not
// depend on the texels' values.
//
// Precision: no --use_fast_math and --fmad=false, and each pixel's values
// are computed as the plain version (ops/rasterize_bwd.py) computes them.
// The order of the sums over pixels and tiles differs (shuffles, atomics),
// so the result is held to the plain version with a relative tolerance.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;  // the ring's ids (IdSlots)
using Slots = IdSlots<kChunk, kIdBufs>;
using SlotsBf16 = IdSlots<kChunk, kIdBufs, kThreads, __nv_bfloat16>;

// dynamic shared memory of a launch: the tile's kPlanes per-pixel planes
size_t dynamic_smem(int tile_h, int tile_w) {
  return static_cast<size_t>(kPlanes) * tile_h * tile_w * sizeof(float);
}

// Block b walks tile order[b].
__global__ void __launch_bounds__(kThreads, 1)
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
                     float* __restrict__ d_charts,
                     const int* __restrict__ order, int ntx, int tile_h,
                     int tile_w, int height, int width, int ch, int cw,
                     int s_cap, int lean) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  const Slots slots{records, gids + starts[tile], charts, d_records,
                    d_charts, static_cast<long long>(ch) * cw * 3, s_id};
  backward_tile<kChunk, Slots, false, true>(
      slots, tile, counts, cam_info, maps, ncontrib, gmaps, ntx, tile_h,
      tile_w, height, width, ch, cw, s_cap, lean);
}

// The same walk on bf16 charts: each texel is widened to float as it is
// read (load_texel), the rest is the float kernel's; d_charts is float.
// (A second kernel, not a template of the first, keeps the float kernel's
// machine code as it was.)
__global__ void __launch_bounds__(kThreads, 1)
rasterize_bwd_bf16_kernel(const float* __restrict__ records,
                          const int* __restrict__ gids,
                          const int* __restrict__ starts,
                          const int* __restrict__ counts,
                          const __nv_bfloat16* __restrict__ charts,
                          const float* __restrict__ cam_info,
                          const float* __restrict__ maps,
                          const int* __restrict__ ncontrib,
                          const float* __restrict__ gmaps,
                          float* __restrict__ d_records,
                          float* __restrict__ d_charts,
                          const int* __restrict__ order, int ntx, int tile_h,
                          int tile_w, int height, int width, int ch, int cw,
                          int s_cap, int lean) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  const SlotsBf16 slots{records, gids + starts[tile], charts, d_records,
                        d_charts, static_cast<long long>(ch) * cw * 3, s_id};
  backward_tile<kChunk, SlotsBf16, false, true>(
      slots, tile, counts, cam_info, maps, ncontrib, gmaps, ntx, tile_h,
      tile_w, height, width, ch, cw, s_cap, lean);
}

template <class Kernel>
int smem(Kernel kernel, int tile_h, int tile_w) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return -1;
  return static_cast<int>(a.sharedSizeBytes + dynamic_smem(tile_h, tile_w));
}

// TChart: the charts' element type of `kernel`
template <class TChart, class Kernel>
int launch(Kernel kernel, const void* records, const void* gids,
           const void* starts, const void* counts, const void* charts,
           const void* cam_info, const void* maps, const void* ncontrib,
           const void* gmaps, void* d_records, void* d_charts,
           const void* order, int num_tiles, int ntx, int tile_h, int tile_w,
           int height, int width, int ch, int cw, int s_cap, int lean,
           void* stream) {
  const size_t smem = dynamic_smem(tile_h, tile_w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  kernel<<<num_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(gids),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const TChart*>(charts), static_cast<const float*>(cam_info),
      static_cast<const float*>(maps), static_cast<const int*>(ncontrib),
      static_cast<const float*>(gmaps), static_cast<float*>(d_records),
      static_cast<float*>(d_charts), static_cast<const int*>(order), ntx,
      tile_h, tile_w, height, width, ch, cw, s_cap, lean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a launch at tile_h x tile_w tiles, in bytes: the
// kernel's static arrays and the per-pixel planes. The chart pad does not
// enter it.
extern "C" int gstex_rasterize_bwd_smem(int tile_h, int tile_w) {
  return smem(rasterize_bwd_kernel, tile_h, tile_w);
}
extern "C" int gstex_rasterize_bwd_bf16_smem(int tile_h, int tile_w) {
  return smem(rasterize_bwd_bf16_kernel, tile_h, tile_w);
}

// Plain C entries for ctypes, one a chart type: float32 charts, and
// bfloat16 charts (gstex_rasterize_bwd_bf16; d_charts float32 for both).
// Pointers are device pointers; records must be 16-byte aligned
// (cp.async); d_records and d_charts must be zeroed; `order` holds the
// num_tiles tiles in the order blocks take them; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_bwd(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info,
    const void* maps, const void* ncontrib, const void* gmaps,
    void* d_records, void* d_charts, const void* order, int num_tiles,
    int ntx, int tile_h, int tile_w, int height, int width, int ch, int cw,
    int s_cap, int lean, void* stream) {
  return launch<float>(rasterize_bwd_kernel, records, gids, starts, counts,
                       charts, cam_info, maps, ncontrib, gmaps, d_records,
                       d_charts, order, num_tiles, ntx, tile_h, tile_w,
                       height, width, ch, cw, s_cap, lean, stream);
}

extern "C" int gstex_rasterize_bwd_bf16(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info,
    const void* maps, const void* ncontrib, const void* gmaps,
    void* d_records, void* d_charts, const void* order, int num_tiles,
    int ntx, int tile_h, int tile_w, int height, int width, int ch, int cw,
    int s_cap, int lean, void* stream) {
  return launch<__nv_bfloat16>(rasterize_bwd_bf16_kernel, records, gids,
                               starts, counts, charts, cam_info, maps,
                               ncontrib, gmaps, d_records, d_charts, order,
                               num_tiles, ntx, tile_h, tile_w, height, width,
                               ch, cw, s_cap, lean, stream);
}
