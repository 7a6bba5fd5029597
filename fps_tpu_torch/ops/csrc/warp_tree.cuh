// Warp and block building blocks shared by the radix sort (radix_sort.cu),
// K2 (scatter_add.cu), K3 (scatter_add_packed.cu) and K4
// (scatter_add_dim1.cu): the peers of a lane
// by digit, from one ballot a digit bit, which ranks keys stably inside a
// warp; and segmented inclusive scans in a fixed shuffle tree, so that
// every run's sum is added in the same order on every launch.

#pragma once

#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

// The lanes of the warp whose digit equals this lane's, among the live
// lanes: one ballot a digit bit (the pass's digits have `bits` bits).
__device__ __forceinline__ unsigned peers_of(int d, int bits, bool live) {
  unsigned m = __ballot_sync(kFull, live);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < bits) {
      const bool bit = (d >> b) & 1;
      const unsigned v = __ballot_sync(kFull, bit);
      m &= bit ? v : ~v;
    }
  }
  return m;
}

// Segmented inclusive scan within a warp: (f, s[:n]) in lane order, f = 1
// where a segment starts. Fixed shuffle tree, so a fixed addition order.
// n is the same on every lane.
template <int W>
__device__ __forceinline__ void warp_seg_scan(int lane, int n, int& f,
                                              float (&s)[W]) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int f_up = __shfl_up_sync(kFull, f, d);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) {
        const float s_up = __shfl_up_sync(kFull, s[j], d);
        if (lane >= d && !f) s[j] = s_up + s[j];
      }
    }
    if (lane >= d) f |= f_up;
  }
}

// Segmented inclusive scan over the block's threads (a multiple of 32, at
// most 1,024). On return s[:n] is the thread's segmented sum. `wf` and `ws`
// (one entry per warp) are scratch.
template <int W>
__device__ __forceinline__ void block_seg_scan(int n, int f, float (&s)[W],
                                               int* wf, float (*ws)[W]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  warp_seg_scan<W>(lane, n, f, s);
  if (lane == 31) {
    wf[warp] = f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) ws[warp][j] = s[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
    int g = lane < warps ? wf[lane] : 1;
    float t[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      t[j] = (lane < warps && j < n) ? ws[lane][j] : 0.0f;
    }
    warp_seg_scan<W>(lane, n, g, t);
    if (lane < warps) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < n) ws[lane][j] = t[j];
      }
    }
  }
  __syncthreads();
  // No segment start between the warp's first lane and this one: the
  // segment reaches back into earlier warps, whose scan ends at its start.
  if (warp > 0 && !f) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) s[j] = ws[warp - 1][j] + s[j];
    }
  }
}

}  // namespace
