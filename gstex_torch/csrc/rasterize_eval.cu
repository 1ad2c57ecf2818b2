// Forward-only textured-surfel blend over the flat (tile, depth, id) pair
// list: the eval/serving render of GStex.
//
// Replaces: gstex_tpu/ops/rasterize_pallas5.py, _eval_kernel5 (launched by
// rasterize_pallas5_eval). Computes the same function: for each pixel, walk
// the tile's splats front to back; ray–surfel-plane hit, Gaussian falloff
// max'd with the 2DGS screen low-pass (sigma^2 = 0.5), alpha = min(o*G,
// 0.999) with the 1/255 cutoff and t > 1e-6, a 4-texel bilinear fetch from
// the splat's chart, and the transmittance break at T_EPS. Writes img(3),
// tex(3), depth and alpha as eight (H, W) planes; out-of-image pixels are
// not written.
//
// What bounds it on the H100: operations. Each (pixel, pair) response costs
// ~34 fp32 operations and each blend ~75, against one 128 B record per pair
// per tile and four texels per blend. The walk has no matrix product, so
// the tensor cores have nothing to do.
//
// The design, for Hopper: the flat training forward's walk (csrc/
// rasterize_fwd.cu) without its training outputs.
// - The walk is forward_tile in tile_walk.cuh under the eval output policy
//   (kEval): one block per tile, 256 threads with 4 pixels each, a pixel's
//   ray, T and eight sums in registers; no t_final, m1 or ncontrib, and
//   the normal and reg chains compiled out. The tile leaves its walk once
//   no in-image pixel has T > T_EPS (__syncthreads_or), the GPU form of
//   the TPU kernel's tile-wide max(T) loop condition: once T <= T_EPS a
//   pixel's weights are all zero. Slot k of a tile is
//   gids[starts[tile] + k] (IdSlots).
// - Nothing in shared memory depends on the chart pad: only records are
//   staged, kChunk a chunk, in a ring of two buffers filled by cp.async.
//   A blend reads its four texels from device memory through the read-only
//   path (the active texels sit in the 50 MB L2). The first port staged
//   each chunk's whole charts, one splat a chunk at a (40, 80) pad, with
//   two barriers and 38.5 KB of copies per (tile, splat): 9.4 ms a frame
//   there against 0.92 at (8, 8).
// - Tiles start longest first (`order`, the tiles by capped count,
//   descending), so the long tiles do not trail the grid.
// - __launch_bounds__ at 2 blocks an SM (128 registers, no spills).
// Each choice was measured against its alternatives (PERF.md §6): 3
// blocks an SM and 32 records a chunk.
//
// The chart type: float32, or bfloat16 (GStexConfig.texel_dtype = "bf16",
// the JAX package's bf16 chart table; gstex_rasterize_eval_bf16). A bf16
// texel is widened to float as it is read, and every operation after that
// is the float kernel's, so the bf16 entry is bit-equal to the plain
// version on the widened charts as the float entry is on float charts.
// It halves the texel bytes; the records and the walk are unchanged.
//
// Precision: built without --use_fast_math and with --fmad=false. t_hit is
// a true division and the exponent is expf: a one-ulp change in t moves the
// chart fetch by up to h ulps, and the alpha cutoffs are discontinuities.
// Without contraction each operation rounds as the plain PyTorch version's
// separate elementwise ops do, in the same order, so the kernel's maps are
// bit-equal to it (ops/rasterize_eval.py).

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;  // the ring's ids (IdSlots)
using Slots = IdSlots<kChunk, kIdBufs>;
using SlotsBf16 = IdSlots<kChunk, kIdBufs, kThreads, __nv_bfloat16>;

// Block b walks tile order[b].
__global__ void __launch_bounds__(kThreads, 2)
rasterize_eval_kernel(const float* __restrict__ records,
                      const int* __restrict__ gids,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const float* __restrict__ charts,
                      const float* __restrict__ cam_info,
                      float* __restrict__ out, const int* __restrict__ order,
                      int ntx, int tile_h, int tile_w, int height, int width,
                      int ch, int cw, int s_cap) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  const Slots slots{records, gids + starts[tile], charts, nullptr, nullptr,
                    static_cast<long long>(ch) * cw * 3, s_id};
  forward_tile<kChunk, Slots, false, true, true>(
      slots, tile, counts, cam_info, out, nullptr, ntx, tile_h, tile_w,
      height, width, cw, s_cap, 1);
}

// The same walk on bf16 charts: each texel is widened to float as it is
// read (load_texel), the rest is the float kernel's. (A second kernel, not
// a template of the first, keeps the float kernel's machine code as it
// was.)
__global__ void __launch_bounds__(kThreads, 2)
rasterize_eval_bf16_kernel(const float* __restrict__ records,
                           const int* __restrict__ gids,
                           const int* __restrict__ starts,
                           const int* __restrict__ counts,
                           const __nv_bfloat16* __restrict__ charts,
                           const float* __restrict__ cam_info,
                           float* __restrict__ out,
                           const int* __restrict__ order, int ntx,
                           int tile_h, int tile_w, int height, int width,
                           int ch, int cw, int s_cap) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  const SlotsBf16 slots{records, gids + starts[tile], charts, nullptr,
                        nullptr, static_cast<long long>(ch) * cw * 3, s_id};
  forward_tile<kChunk, SlotsBf16, false, true, true>(
      slots, tile, counts, cam_info, out, nullptr, ntx, tile_h, tile_w,
      height, width, cw, s_cap, 1);
}

template <class Kernel>
int smem(Kernel kernel) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return -1;
  return static_cast<int>(a.sharedSizeBytes);
}

// TChart: the charts' element type of `kernel`
template <class TChart, class Kernel>
int launch(Kernel kernel, const void* records, const void* gids,
           const void* starts, const void* counts, const void* charts,
           const void* cam_info, void* out, const void* order,
           int num_tiles, int ntx, int tile_h, int tile_w, int height,
           int width, int ch, int cw, int s_cap, void* stream) {
  if (num_tiles == 0) return 0;
  kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(gids),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const TChart*>(charts), static_cast<const float*>(cam_info),
      static_cast<float*>(out), static_cast<const int*>(order), ntx, tile_h,
      tile_w, height, width, ch, cw, s_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a launch, in bytes: the kernel's static arrays. There
// is no dynamic part, so it is the same for every tile size and chart pad.
extern "C" int gstex_rasterize_eval_smem() {
  return smem(rasterize_eval_kernel);
}
extern "C" int gstex_rasterize_eval_bf16_smem() {
  return smem(rasterize_eval_bf16_kernel);
}

// Plain C entries for ctypes, one a chart type: float32 charts, and
// bfloat16 charts (gstex_rasterize_eval_bf16). Pointers are device
// pointers; records must be 16-byte aligned (cp.async); `order` holds the
// num_tiles tiles in the order blocks take them; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_eval(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info, void* out,
    const void* order, int num_tiles, int ntx, int tile_h, int tile_w,
    int height, int width, int ch, int cw, int s_cap, void* stream) {
  return launch<float>(rasterize_eval_kernel, records, gids, starts,
                       counts, charts, cam_info, out, order, num_tiles, ntx,
                       tile_h, tile_w, height, width, ch, cw, s_cap, stream);
}

extern "C" int gstex_rasterize_eval_bf16(
    const void* records, const void* gids, const void* starts,
    const void* counts, const void* charts, const void* cam_info, void* out,
    const void* order, int num_tiles, int ntx, int tile_h, int tile_w,
    int height, int width, int ch, int cw, int s_cap, void* stream) {
  return launch<__nv_bfloat16>(rasterize_eval_bf16_kernel, records, gids,
                               starts, counts, charts, cam_info, out, order,
                               num_tiles, ntx, tile_h, tile_w, height, width,
                               ch, cw, s_cap, stream);
}
