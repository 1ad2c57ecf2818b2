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
// (pixel, pair), ~34 per walked one); the bytes are one record read and one
// record gradient added per pair per tile, four texels read and four texel
// gradients added per applied (pixel, pair).
//
// What the design does about it:
// - One block per tile, 256 threads with 4 pixels each; the tile's 12
//   cotangent planes and its alpha and m1 maps sit in shared memory.
// - Nothing in shared memory depends on the chart pad. Records are staged
//   32 splats a chunk; their gradients are summed per chunk in shared
//   memory (a warp shuffle reduction, one shared atomic per warp and field)
//   and leave with one global atomicAdd per non-zero field. Texels are read
//   from device memory (L2), and each texel gradient goes straight to
//   d_charts with a global atomicAdd: no pair-space gradient buffer exists,
//   so there is nothing to batch over tiles.
// - The fetch is the forward's 2 x 2 bilinear form, so its weights are the
//   forward's to the last bit; its derivative in x is row1 - row0 (and
//   likewise in y). That is the hat-function form of the TPU kernel and of
//   the plain versions everywhere but where a sample sits exactly on a texel,
//   which is handled apart: there the derivative is two-sided, as theirs.
// - A pixel skips a splat at once where it has no weight (rank >=
//   ncontrib, or alpha == 0): every gradient term of such a pair is zero.
// - The walk and chain rule are backward_tile in tile_walk.cuh, shared
//   with the flat, v2 and v1 kernels; here a slot's record and chart are
//   found through ids and its gradients added per gaussian (IdSlots).
//
// Precision: no --use_fast_math and --fmad=false. The plain version
// (ops/rasterize.py:backward_walk) pulls the local math back with autograd
// and sums in scan order; this kernel writes the chain rule out and sums by
// shuffles and atomics, so the two agree to rounding (a relative
// tolerance), not bitwise.

#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 32;

__global__ void __launch_bounds__(kThreads)
rasterize_dense_bwd_kernel(const float* __restrict__ records,
                           const int* __restrict__ ids,
                           const int* __restrict__ counts,
                           const float* __restrict__ charts,
                           const float* __restrict__ cam_info,
                           const float* __restrict__ maps,
                           const int* __restrict__ ncontrib,
                           const float* __restrict__ gmaps,
                           float* __restrict__ d_records,
                           float* __restrict__ d_charts, int ntx, int tile_h,
                           int tile_w, int height, int width, int ch, int cw,
                           int s_max, int lean) {
  __shared__ int s_id[kChunk];
  // slot k of the tile is gaussian ids[tile, k]
  const IdSlots<kChunk> slots{records,
                              ids + static_cast<long long>(blockIdx.x) * s_max,
                              charts, d_records, d_charts,
                              static_cast<long long>(ch) * cw * 3, s_id};
  backward_tile<kChunk>(slots, blockIdx.x, counts, cam_info, maps, ncontrib,
                        gmaps, ntx, tile_h, tile_w, height, width, ch, cw,
                        s_max, lean);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; d_records and
// d_charts must be zeroed; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gstex_rasterize_dense_bwd(
    const void* records, const void* ids, const void* counts,
    const void* charts, const void* cam_info, const void* maps,
    const void* ncontrib, const void* gmaps, void* d_records, void* d_charts,
    int num_tiles, int ntx, int tile_h, int tile_w, int height, int width,
    int ch, int cw, int s_max, int lean, void* stream) {
  const size_t smem =
      static_cast<size_t>(kPlanes) * tile_h * tile_w * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_dense_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (num_tiles == 0) return 0;
  rasterize_dense_bwd_kernel<<<num_tiles, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(records), static_cast<const int*>(ids),
      static_cast<const int*>(counts), static_cast<const float*>(charts),
      static_cast<const float*>(cam_info), static_cast<const float*>(maps),
      static_cast<const int*>(ncontrib), static_cast<const float*>(gmaps),
      static_cast<float*>(d_records), static_cast<float*>(d_charts), ntx,
      tile_h, tile_w, height, width, ch, cw, s_max, lean);
  return static_cast<int>(cudaGetLastError());
}
