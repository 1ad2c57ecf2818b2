// Backward of the chunk-scan training forward (csrc/rasterize_v3_fwd.cu):
// the back-to-front gradient walk over each tile's own slots, with T
// recovered per chunk of 16 slots from the chunk's end, writing pair-space
// gradients.
//
// Replaces: gstex_tpu/ops/rasterize_pallas3.py, _bwd_kernel3 (launched by
// rasterize_pallas3_bwd). Per pixel and chunk of 16 slots (from slot 0),
// with t_end the transmittance after the chunk (t_final for the last chunk
// walked) and q_j = 1 - alpha_j where slot j is applied (alpha_j > 0,
// j < ncontrib), else 1:
//   T_k = t_end / prod_{j>=k} q_j,  w_k = alpha_k * T_k
//   E_k, D_k, Bs_k = the sums of w, w*m, s*w over the applied slots after k
//   dL/dalpha_k = T_k * s_k - Bs_k / (1 - alpha_k)
// then the chain rule of the other tiers to record fields 0-11, 15, 19-25
// of slot (t, k), written into d_records_t (T, S, 32), and to the texels
// of its bilinear fetch, written into d_charts_g (T, S, Ch, Cw, 3). Fields
// 12-14, 16-18 (the detached uv frame) get none. The reduction to
// per-gaussian gradients is autograd's, through the gathers that made the
// pair-space inputs.
//
// What is carried over from the TPU kernel: its function, T_k by a divide
// from the chunk's end and the chunks of 16. What is not: its layout of a
// chunk's 16 slots across lanes, with the suffix product and sums as scans
// across them, and its matmuls (texel fetch and chart gradient against hat
// weights, the record gradients assembled with one-hot lane masks).
//
// What bounds it on the H100: operations (~350 fp32 operations per applied
// (pixel, pair), ~34 per walked one). Bytes: one record read and one
// record gradient written per slot, four texels read and four texel
// gradients added per applied (pixel, pair).
//
// The design, for Hopper: the v2 backward's (csrc/rasterize_v2_bwd.cu)
// with v3's recovery of T (backward_tile in tile_walk.cuh with kV3 set,
// on pair_slots.cuh's PairRingSlots). One block per tile, 384 threads
// with 3 pixels each; each pixel walks the slots back to front and keeps
// t_end and the running product P of the chunk's applied q in registers:
// at an applied slot P = q * P and T_k = t_end / P; after slot 16c,
// t_end = t_end / P and P = 1 at every pixel. E, D and Bs are the walk's
// running sums, which in exact arithmetic are the TPU kernel's carried
// sums plus its exclusive suffix scans. The tile's 12 cotangent planes and
// its alpha and m1 maps sit in dynamic shared memory, nothing of the chart
// pad's size; records are staged 64 a chunk in a cp.async ring of two
// buffers (the ring's chunks are not v3's chunks of 16); tiles run
// longest first (`order`, one a training step from _RasterizePairs); the
// record gradients of a (warp, slot) are reduced transposed (kShflT) and
// stored once per slot and field; texel gradients are added into the
// slot's own region of d_charts_g as REDs. The first port kept the TPU
// kernel's layout (a half-warp's 16 lanes on a chunk's 16 slots, walking
// pixels, with width-16 shuffle scans) and staged chart gradients in
// shared memory, one 256-thread block an SM. Each option was measured
// (PERF.md §6).
//
// Precision: no --use_fast_math, --fmad=false and true IEEE divides. The
// plain version (ops/rasterize_v3.py:rasterize_v3_bwd_reference) runs the
// TPU kernel's scans (strides 1, 2, 4, 8), this kernel the serial product
// and sums of the walk, and the two sum over pixels in another order, so
// they agree to rounding, not bitwise.

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
rasterize_v3_bwd_kernel(const float* __restrict__ records_t,
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
  backward_tile<kChunk, Slots, false, true, kShflT, kBlock, /*kV3*/ true>(
      slots, tile, counts, cam_info, maps, ncontrib, gmaps, ntx, tile_h,
      tile_w, height, width, ch, cw, s_max, lean);
}

}  // namespace

// Shared memory of a launch at tile_h x tile_w tiles, in bytes: the
// kernel's static arrays and its dynamic part (no chart pad enters).
extern "C" int gstex_rasterize_v3_bwd_smem(int tile_h, int tile_w) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, rasterize_v3_bwd_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>(a.sharedSizeBytes + dynamic_smem(tile_h, tile_w));
}

// Plain C entry for ctypes. Pointers are device pointers; records_t must be
// 16-byte aligned (cp.async); d_records_t and d_charts_g must be zeroed;
// `order` holds the num_tiles tiles in the order blocks take them;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int gstex_rasterize_v3_bwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, const void* maps, const void* ncontrib,
    const void* gmaps, void* d_records_t, void* d_charts_g, const void* order,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  const size_t smem = dynamic_smem(tile_h, tile_w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_v3_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_v3_bwd_kernel<<<num_tiles, kBlock, smem,
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
