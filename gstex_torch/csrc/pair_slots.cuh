// How the pair-space kernels (rasterize_v3_*.cu, rasterize_v2_*.cu,
// rasterize_v1_*.cu) find a tile's slots for the shared walk of
// tile_walk.cuh: PairFwdSlots for the three forwards and PairRingSlots for
// the three backwards (tiles in a given order, the record ring, kBlock
// threads). Slot k of tile t has its own copy of its splat's record, at
// (t, k) of records_t (T, S, 32), and of its chart, at (t, k) of charts_g
// (T, S, Ch, Cw, 3), and its own rows of the pair-space gradients
// d_records_t and d_charts_g, which only the tile's block writes. So the
// backward needs no atomics across blocks.

#pragma once

#include "tile_walk.cuh"

namespace {

// The forwards' slots: tile `tile`'s, whichever block walks it, for the
// walk's record ring (prefetch; stage without it) and a block of kBlock
// threads.
template <int kBlock>
struct PairFwdSlots {
  const float* tile_rec;
  const float* tile_charts;
  long long chw3;

  __device__ PairFwdSlots(const float* records_t, const float* charts_g,
                          int ch, int cw, int s_max, int tile)
      : chw3(static_cast<long long>(ch) * cw * 3) {
    const long long slot0 = static_cast<long long>(tile) * s_max;
    tile_rec = records_t + slot0 * kRec;
    tile_charts = charts_g + slot0 * chw3;
  }
  __device__ void stage(int base, int n, float* s_rec, int tid) const {
    for (int i = tid; i < n * kRec; i += kBlock)
      s_rec[i] = tile_rec[static_cast<long long>(base) * kRec + i];
  }
  // the chunk's records are contiguous: n * 8 copies of 16 B
  __device__ void prefetch(int base, int n, float* s_rec, int tid) const {
    const float* src = tile_rec + static_cast<long long>(base) * kRec;
    for (int i = tid; i < n * (kRec / 4); i += kBlock)
      cp_async16(s_rec + 4 * i, src + 4 * i);
  }
  __device__ const float* chart(int, int k) const {
    return tile_charts + static_cast<long long>(k) * chw3;
  }
};

// The backwards' slots: tile `tile`'s, whichever block walks it, for
// the walk's record ring (prefetch) and a block of kBlock threads (begin
// and end stride by it). Slot k's record gradients leave with one plain
// store per field in end; its texel gradients go straight into its own
// region of d_charts_g with a global atomicAdd whose result is unused (a
// RED). Only the tile's block writes either, and the wrapper zeroes both.
// With kStage the texel gradients are summed per chunk in shared memory
// (staged: kChunk charts, zeroed here) and stored in end.
template <int kChunk, int kBlock, bool kStage = false>
struct PairRingSlots {
  const float* tile_rec;
  const float* tile_charts;
  float* tile_drec;
  float* tile_dcharts;
  long long chw3;
  float* s_dch;

  __device__ PairRingSlots(const float* records_t, const float* charts_g,
                           float* d_records_t, float* d_charts_g, int ch,
                           int cw, int s_max, int tile, float* staged)
      : chw3(static_cast<long long>(ch) * cw * 3), s_dch(staged) {
    const long long slot0 = static_cast<long long>(tile) * s_max;
    tile_rec = records_t + slot0 * kRec;
    tile_charts = charts_g + slot0 * chw3;
    tile_drec = d_records_t + slot0 * kRec;
    tile_dcharts = d_charts_g + slot0 * chw3;
    if constexpr (kStage)
      for (long long i = threadIdx.x; i < kChunk * chw3; i += kBlock)
        s_dch[i] = 0.0f;
  }
  // without the ring
  __device__ void begin(int base, int n, float* s_rec, float* s_drec,
                        int tid) const {
    for (int i = tid; i < n * kRec; i += kBlock) {
      s_rec[i] = tile_rec[static_cast<long long>(base) * kRec + i];
      s_drec[i] = 0.0f;
    }
  }
  // the chunk's records are contiguous: n * 8 copies of 16 B
  __device__ void prefetch(int base, int n, float* s_rec, int tid) const {
    const float* src = tile_rec + static_cast<long long>(base) * kRec;
    for (int i = tid; i < n * (kRec / 4); i += kBlock)
      cp_async16(s_rec + 4 * i, src + 4 * i);
  }
  __device__ const float* chart(int, int k) const {
    return tile_charts + static_cast<long long>(k) * chw3;
  }
  __device__ float* dchart(int s, int k) const {
    if constexpr (kStage)
      return s_dch + s * chw3;
    else
      return tile_dcharts + static_cast<long long>(k) * chw3;
  }
  __device__ void end(int base, int n, const float* s_drec, int tid) const {
    for (int i = tid; i < n * kRec; i += kBlock)
      tile_drec[static_cast<long long>(base) * kRec + i] = s_drec[i];
    if constexpr (kStage)
      for (long long i = tid; i < n * chw3; i += kBlock) {
        tile_dcharts[base * chw3 + i] = s_dch[i];
        s_dch[i] = 0.0f;  // read by this thread only; the next chunk's
                          // walk starts after a barrier
      }
  }
};

}  // namespace
