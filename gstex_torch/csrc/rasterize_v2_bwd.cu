// Backward of the v2 pair-space training forward (csrc/rasterize_v2_fwd.cu):
// the back-to-front gradient walk over each tile's own slots, writing
// pair-space gradients.
//
// Replaces: gstex_tpu/ops/rasterize_pallas2.py, _bwd_kernel2 (launched by
// rasterize_pallas2_bwd). For each pixel it walks the tile's slots from
// min(count, max ncontrib + 1) down to 0, recovers T before each applied
// splat as T_{k+1} / (1 - alpha_k) from t_final, keeps the suffix sums of
// s*w (and of w and w*m for the reg chain), and writes the gradients of
// record fields 0-11, 15, 19-25 of slot (t, s) into d_records_t (T, S, 32)
// and of the texels of its bilinear fetch into d_charts_g (T, S, Ch, Cw, 3).
// Fields 12-14, 16-18 (the detached uv frame) get none. The reduction to
// per-gaussian gradients is autograd's, through the gathers that made the
// pair-space inputs.
//
// What bounds it on the H100: operations (~350 fp32 operations per applied
// (pixel, pair), ~390 with the normal and reg; ~34 per walked one). Bytes:
// one record read and one record gradient written per slot, four texels
// read and four texel gradients added per applied (pixel, pair). The walk
// has no matrix product, so the tensor cores have nothing to do.
//
// The design, for Hopper: the dense backward's (csrc/rasterize_dense_bwd.cu)
// on the pair-space slots.
// - The walk and chain rule are backward_tile in tile_walk.cuh: one block
//   per tile; the tile's 12 cotangent planes and its alpha and m1 maps in
//   dynamic shared memory (57 KB at 32 x 32 tiles), and nothing else of
//   the chart pad's size. pair_slots.cuh's PairRingSlots says where a
//   slot's record and chart are (its own copies) and where its gradients
//   go (its own rows, which only this block writes: no atomics across
//   blocks).
// - 384 threads a block with 3 pixels each (kBlock), as the dense backward.
// - Records are staged kChunk a chunk in a ring of two buffers filled by
//   cp.async (chunk c - 1's records fly while chunk c is walked). Their
//   gradients are summed per chunk in shared memory and leave with one
//   plain store per slot and field; a walked slot that no pixel applies
//   stores its zeros.
// - Texel gradients go straight into the slot's own region of d_charts_g
//   with a global atomicAdd whose result is unused (a RED). The first port
//   summed each 16-slot chunk's chart gradients in shared memory where they
//   fit (74 KB at (16, 24)), zeroed and stored them whole every chunk, and
//   ran one 256-thread block an SM.
// - Tiles start longest first (`order`: the tiles by count capped at S,
//   descending), so the long tiles do not trail the grid.
// - The record gradients of a (warp, slot) are reduced transposed
//   (kShflT): 31 shuffles, lane f ending with field f's warp sum.
// - The fetch is the forward's 2 x 2 bilinear form with a two-sided
//   derivative where a sample sits exactly on a texel: the TPU kernel's
//   hat-function form.
// - A pixel skips a splat at once where it has no weight (rank >=
//   ncontrib, or alpha == 0): every gradient term of such a pair is zero.
// Each choice was measured against its alternatives (PERF.md §6); kStage
// keeps the staged chart gradients as an option.
//
// Precision: no --use_fast_math and --fmad=false. The plain version
// (ops/rasterize_v2.py: ops/rasterize.py:backward_walk on the pair-space
// view) pulls the local math back with autograd and sums in scan order;
// this kernel writes the chain rule out and sums by shuffles and atomics,
// so the two agree to rounding, not bitwise.

#include "pair_slots.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kBlock = 384;     // threads a block; 3 pixels each
constexpr bool kShflT = true;   // the transposed record-gradient reduction
constexpr bool kStage = false;  // texel gradients summed in shared memory
using Slots = PairRingSlots<kChunk, kBlock, kStage>;

// dynamic shared memory of a launch: the tile's kPlanes per-pixel planes,
// then (kStage) a chunk's chart gradients
size_t dynamic_smem(int tile_h, int tile_w, int ch, int cw) {
  return (static_cast<size_t>(kPlanes) * tile_h * tile_w +
          (kStage ? static_cast<size_t>(kChunk) * ch * cw * 3 : 0)) *
         sizeof(float);
}

// Block b walks tile order[b].
__global__ void __launch_bounds__(kBlock, 1)
rasterize_v2_bwd_kernel(const float* __restrict__ records_t,
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
  // kPlanes * pix floats (backward_tile's), then the staged gradients
  extern __shared__ float s_dyn[];
  const int tile = order[blockIdx.x];
  const Slots slots(records_t, charts_g, d_records_t, d_charts_g, ch, cw,
                    s_max, tile, s_dyn + kPlanes * tile_h * tile_w);
  backward_tile<kChunk, Slots, false, true, kShflT, kBlock>(
      slots, tile, counts, cam_info, maps, ncontrib, gmaps, ntx, tile_h,
      tile_w, height, width, ch, cw, s_max, lean);
}

}  // namespace

// Shared memory of a launch at tile_h x tile_w tiles and (ch, cw) charts,
// in bytes: the kernel's static arrays and its dynamic part.
extern "C" int gstex_rasterize_v2_bwd_smem(int tile_h, int tile_w, int ch,
                                           int cw) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, rasterize_v2_bwd_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>(a.sharedSizeBytes +
                          dynamic_smem(tile_h, tile_w, ch, cw));
}

// Plain C entry for ctypes. Pointers are device pointers; records_t must be
// 16-byte aligned (cp.async); d_records_t and d_charts_g must be zeroed;
// `order` holds the num_tiles tiles in the order blocks take them;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int gstex_rasterize_v2_bwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, const void* maps, const void* ncontrib,
    const void* gmaps, void* d_records_t, void* d_charts_g, const void* order,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  const size_t smem = dynamic_smem(tile_h, tile_w, ch, cw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_v2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_v2_bwd_kernel<<<num_tiles, kBlock, smem,
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
