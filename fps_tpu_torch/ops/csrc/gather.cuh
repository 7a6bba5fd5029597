// What K1 (gather_rows.cu) and K5 (gather_rows_dim1.cu) share: the cut of
// the output into 16-byte chunks, the streaming store and the plan's
// constants (kernels.py gather_plan reads them).
//
// A gather copies bits and does no arithmetic, so what bounds it is the
// bytes it moves and, at the paths' smaller batches, the latency of its two
// dependent loads (the id, then the table value). The output, fresh from
// torch.empty and so 16-byte aligned, is cut flat into chunks of 4 floats.
// Neighbouring lanes take neighbouring chunks, so a warp writes 512
// contiguous bytes a pass. A thread takes a chunk a pass over a grid of at
// most the card's resident blocks, striding by the grid: 16 bytes of output
// in flight a thread, 32 KB an SM at 2,048 threads, past the ~18 KB that
// 3.35 TB/s at ~0.7 us of latency needs (more chunks a thread a pass
// measured no faster at the 20-class PA pull and slower at the smaller
// ones; PERF.md). Stores are streaming (st.global.cs, evict-first): an
// output of tens of MB passes through L2 without pushing the table out of
// it. Each kernel waits for the one before it in the stream (grid_wait,
// pdl.cuh) before its first load, since its ids or its table may be that
// kernel's output, and lets the next one start at once: its grid is one
// wave, so the next kernel's blocks cannot crowd it out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"

namespace {

constexpr int kThreads = 256;  // a block

constexpr int cudaInvalid = static_cast<int>(cudaErrorInvalidValue);

// Writes the chunk of 4 floats at flat output position e0 (a multiple of
// 4) of an output of n floats: one 16-byte streaming store, or, for the
// ragged last chunk, a streaming store for each float below n.
template <typename Idx>
__device__ __forceinline__ void store_chunk(float* __restrict__ out, Idx e0,
                                            Idx n, const float (&v)[4]) {
  if (e0 + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(out + e0),
           make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e0 + j < n) __stcs(out + e0 + j, v[j]);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The most blocks of `kernel` an SM holds at once (0 where it cannot
// launch).
int blocks_per_sm(const void* kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return n;
}

}  // namespace
