// Training forward of the textured-surfel blend over the pair-space
// inputs, by the chunk scan: the transmittance of a chunk of 16 slots comes
// from a log-step product scan across the chunk, not from the serial
// per-splat recurrence.
//
// Replaces: gstex_tpu/ops/rasterize_pallas3.py, _fwd_kernel3 (launched by
// rasterize_pallas3_fwd). Inputs and outputs are csrc/rasterize_v2_fwd.cu's:
// records_t (T, S, 32), charts_g (T, S, Ch, Cw, 3), counts; fourteen (H, W)
// planes in CH_NAMES order and ncontrib (H, W). Per pixel and chunk, with
// T_in the transmittance entering the chunk:
//   incl_k = T_in * prod_{j<=k} (1 - alpha_j), excl_k = incl_{k-1} (T_in)
//   applied_k = alpha_k > 0 && incl_k > T_EPS, w_k = alpha_k * excl_k
// ncontrib is the k with alpha_k > 0 and incl_k <= T_EPS < excl_k, t_final
// the least incl_k > T_EPS, and the reg term takes the exclusive prefix
// sums of w and w*m over the chunk.
//
// What the TPU kernel does that is not carried over: its layout (splats on
// sublanes, pixels on lanes, charts packed c-major on 128 lanes, the texel
// fetch as a matmul against hat weights, the per-splat-constant channels
// on the MXU). What is: the chunk of 16 and the product scan's
// association (its helper _cumprod_incl: strides 1, 2, 4, 8).
//
// What bounds it on the H100: operations (~40 fp32 operations per (pixel,
// slot) response, ~90 per blend), the same as the other tiers' per pair;
// a pixel walks the rest of the chunk of 16 in which it breaks, and 4
// multiplies a slot for the scan. Bytes: each tile reads its own copy of a
// chart.
//
// The design, for Hopper: the v1 and dense forwards' walk (forward_tile in
// tile_walk.cuh) with v3's transmittance (kV3).
// - One block per tile, 512 threads with 2 pixels each, one block an SM
//   (16 warps, 128 registers); a pixel's T, t_final, ncontrib and sums
//   stay in registers. Each pixel alive at the start of a chunk of 16
//   walks all 16 of its slots, in turn with the thread's other pixel (one
//   copy of the walk, the pixels' state rotated through it), its ray
//   recomputed for the chunk; the scan streams through the slots with a
//   window of 15 products, which is the scan's association to the bit
//   (tile_walk.cuh). The tile stops once no in-image pixel has
//   T > T_EPS. A pixel's walk is serial in its thread, so twice the
//   threads a tile halve a tile's time: 256 threads with 4 pixels each,
//   two blocks an SM, took 1.7x as long (and spilled).
// - Records are staged 64 a chunk (four of v3's chunks) in a cp.async ring
//   of two buffers (pair_slots.cuh's PairFwdSlots); texels are fetched from
//   the slot's own chart in device memory.
// - Tiles start longest first (`order`, one a training step from
//   _RasterizePairs, which hands it to the v3 backward too).
// The first port kept the TPU kernel's layout: a chunk's 16 slots on a
// half-warp's lanes walking the pixels, width-16 shuffle scans and sums,
// and each pixel's state in 64 KB of shared memory. Each choice was
// measured against its alternatives (PERF.md §6).
//
// Precision: no --use_fast_math and --fmad=false. The response, the scan
// and the per-slot terms round as the plain version's
// (ops/rasterize_v3.py:rasterize_v3_fwd_reference) do, so T, t_final and
// ncontrib are the same bit for bit under any tile order; the sums over a
// chunk's slots are the walk's running sums, where the plain version sums
// each chunk apart (and takes the reg term's prefix sums by a scan).

#include "pair_slots.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kBlock = 512;  // threads a block; 1024 / kBlock pixels each
using Slots = PairFwdSlots<kBlock>;

// Block b walks tile order[b].
__global__ void __launch_bounds__(kBlock, 1)
rasterize_v3_fwd_kernel(const float* __restrict__ records_t,
                        const float* __restrict__ charts_g,
                        const int* __restrict__ counts,
                        const float* __restrict__ cam_info,
                        float* __restrict__ out, int* __restrict__ ncontrib,
                        const int* __restrict__ order, int ntx, int tile_h,
                        int tile_w, int height, int width, int ch, int cw,
                        int s_max, int lean) {
  const int tile = order[blockIdx.x];
  const Slots slots(records_t, charts_g, ch, cw, s_max, tile);
  forward_tile<kChunk, Slots, false, true, false, kBlock, /*kV3*/ true>(
      slots, tile, counts, cam_info, out, ncontrib, ntx, tile_h, tile_w,
      height, width, cw, s_max, lean);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; records_t must be
// 16-byte aligned (cp.async); `order` holds the num_tiles tiles in the
// order blocks take them; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_v3_fwd(
    const void* records_t, const void* charts_g, const void* counts,
    const void* cam_info, void* out, void* ncontrib, const void* order,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  if (num_tiles == 0) return 0;
  rasterize_v3_fwd_kernel<<<num_tiles, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records_t),
      static_cast<const float*>(charts_g), static_cast<const int*>(counts),
      static_cast<const float*>(cam_info), static_cast<float*>(out),
      static_cast<int*>(ncontrib), static_cast<const int*>(order), ntx,
      tile_h, tile_w, height, width, ch, cw, s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
