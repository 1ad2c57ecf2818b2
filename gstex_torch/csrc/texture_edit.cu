// Texture painting's inverse rasterisation over the dense per-tile lists:
// an RGBA canvas seen from one camera splatted back into the texel charts
// of the surfels visible inside a depth window, the (N, Ch, Cw, 5)
// accumulator of sum w * rgb, sum w * alpha and sum w per texel.
//
// Replaces no TPU kernel: gstex_tpu/ops/texture_edit.py:texture_edit is
// plain JAX, a lax.scan over the s_max slots of the dense lists that forms
// each slot's (tiles, pixels, Ch, 5) canvas contribution and reduces it by
// an einsum (texture_edit.py:74-106); the reference's texture painting is
// a CUDA kernel of its rasterizer (gstex_cuda.texture_edit). At 800x800,
// 32x32 tiles and a (40, 80) chart pad that scan moves ~0.5 GB and ~20
// GFLOP a slot, and the viewer replays every stroke's edit after each
// stroke, so the port writes the op as a kernel.
//
// What it computes, per pixel and slot front to back: the eval walk's
// alpha (the forward's response on the assembled records) and weight
// w = alpha * T, T falling until the break at T_EPS, which is not
// applied; each applied pair whose depth t lies in the pixel's window
// [lo, hi] adds w * (canvas rgb, canvas alpha, 1) to the texels of its
// bilinear tent, max(0, 1 - |x - a|) (texture_edit.py:88-103).
//
// What bounds it on the H100: operations (~34 fp32 operations a
// response, ~40 and up to 20 REDs an applied pair in the window) against
// one 128 B record a pair a tile; the REDs of neighbouring pixels meet on
// the same texels of a splat and serialise in L2.
//
// The design, for Hopper: the dense eval kernel's (csrc/rasterize_dense_
// eval.cu) under the kEdit output policy of forward_tile in tile_walk.cuh.
// One block a tile, 256 threads with 4 pixels each, a pixel's ray, T and
// six canvas inputs in registers; records through the cp.async ring of
// IdSlots, 64 a chunk; tiles longest first (`order`). In place of the
// eight sums, each pair's texels are REDs into the splat's accumulator in
// device memory (the backward kernels' pattern for texel gradients), so no
// shared memory depends on the chart pad and every pad runs. The
// accumulator is zeroed by the wrapper.
//
// Precision: no --use_fast_math and --fmad=false. Alpha, T and the window
// test round as the plain version's (ops/texture_edit.py), so the set of
// texels reached is the same; the sums differ from it in the order of
// their additions only.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kIdBufs = 3;  // the ring's ids (IdSlots)
constexpr int kAccum = 5;   // rgb, alpha, weight
using Slots = IdSlots<kChunk, kIdBufs>;

// Block b walks tile order[b]; `planes` holds the six (H, W) planes of
// canvas rgb, canvas alpha, depth lower and depth upper.
__global__ void __launch_bounds__(kThreads, 2)
texture_edit_kernel(const float* __restrict__ records,
                    const int* __restrict__ ids,
                    const int* __restrict__ counts,
                    const float* __restrict__ planes,
                    const float* __restrict__ cam_info,
                    float* __restrict__ accum,
                    const int* __restrict__ order, int ntx, int tile_h,
                    int tile_w, int height, int width, int ch, int cw,
                    int s_max) {
  __shared__ int s_id[kIdBufs * kChunk];
  const int tile = order[blockIdx.x];
  // slot k of the tile is gaussian ids[tile, k]; its accumulator is the
  // gaussian's (Ch, Cw, 5) block, reached through dchart
  const Slots slots{records, ids + static_cast<long long>(tile) * s_max,
                    nullptr, nullptr, accum,
                    static_cast<long long>(ch) * cw * kAccum, s_id};
  forward_tile<kChunk, Slots, /*kV1=*/false, /*kRing=*/true, /*kEval=*/true,
               kThreads, /*kV3=*/false, /*kEdit=*/true>(
      slots, tile, counts, cam_info, nullptr, nullptr, ntx, tile_h, tile_w,
      height, width, cw, s_max, 1, planes);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; records must be
// 16-byte aligned (cp.async); `accum` (N, Ch, Cw, 5) must be zeroed;
// `order` holds the num_tiles tiles in the order blocks take them;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int gstex_texture_edit(const void* records, const void* ids,
                                  const void* counts, const void* planes,
                                  const void* cam_info, void* accum,
                                  const void* order, int num_tiles, int ntx,
                                  int tile_h, int tile_w, int height,
                                  int width, int ch, int cw, int s_max,
                                  void* stream) {
  if (num_tiles == 0) return 0;
  texture_edit_kernel<<<num_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(ids),
      static_cast<const int*>(counts), static_cast<const float*>(planes),
      static_cast<const float*>(cam_info), static_cast<float*>(accum),
      static_cast<const int*>(order), ntx, tile_h, tile_w, height, width, ch,
      cw, s_max);
  return static_cast<int>(cudaGetLastError());
}
