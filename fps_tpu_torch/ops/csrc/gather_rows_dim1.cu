// K5: scalar-table gather, out[b] = table[ids[b]] for an (R, 1) table, zero
// for ids outside [0, R); with the head-prefix route, the first head_prefix
// positions read against the head table[:H] instead, so an id >= H there
// reads zero.
//
// Replaces gather_rows_dim1_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _gather_dim1_kernel). The TPU kernel packs 128 rows per lane row, splits
// the table into bf16 hi+lo halves and reads each id through two one-hot
// matmuls over every packed row tile: about 16 mantissa bits, and a cost that
// grows with R. Here the read is a plain load: the float's bits go to the
// output unchanged, so the result is bit-identical to the plain PyTorch
// version (mask + index_select), and the cost does not depend on R. The JAX
// package serves the head-prefix route by two calls (head view, then the
// rest) and a concatenation; here it is one launch with a bound a position.
//
// Bound on the H100: bytes. 4 bytes of id read and 4 bytes written per id,
// plus the distinct touched rows read once. The table is at most 4 MB on the
// paths that use it (logistic regression's 1M features), so after the first
// touch every row read is an L2 hit; what is left is the stream of ids in and
// values out, and at these batches (0.3-1M ids) the latency of the id load
// and the dependent table load.
//
// The design (gather.cuh has the cut and the store): a 16-byte output chunk
// is 4 positions. A thread loads their 4 ids with one 16-byte load where the
// ids are 16-byte aligned (4-byte loads otherwise, a misaligned view still
// taking the 16-byte stores), then the 4 values, then stores them in one
// 16-byte streaming store. Every read goes to L2: copying the head, or a
// small table, into each block's shared memory first measured no faster
// (PERF.md), since a block of this one-wave grid takes a single pass and
// the copy and its barrier would sit before its loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"
#include "pdl.cuh"

namespace {

// The value at a position whose id is `id` and whose bound (H in the
// prefix, R after it) is `bound`.
__device__ __forceinline__ float read_scalar(const float* __restrict__ table,
                                            int32_t id, uint32_t bound) {
  const uint32_t u = static_cast<uint32_t>(id);  // a negative id: >= 2^31
  return u < bound ? __ldg(table + u) : 0.0f;
}

// kAlignedIds: 16-byte id loads.
template <bool kAlignedIds>
__global__ void __launch_bounds__(kThreads)
    gather_dim1_kernel(const float* __restrict__ table,
                       const int32_t* __restrict__ ids,
                       float* __restrict__ out, uint32_t num_rows,
                       uint32_t batch, uint32_t head_rows,
                       uint32_t head_prefix) {
  const uint32_t num_chunks = (batch + 3) / 4;
  grid_wait();
  allow_next();
  for (uint32_t c = blockIdx.x * kThreads + threadIdx.x; c < num_chunks;
       c += gridDim.x * kThreads) {
    const uint32_t b = 4 * c;
    int32_t id[4];
    if (kAlignedIds && b + 4 <= batch) {
      int4 w = __ldg(reinterpret_cast<const int4*>(ids) + c);
      id[0] = w.x, id[1] = w.y, id[2] = w.z, id[3] = w.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        id[k] = b + k < batch ? __ldg(ids + b + k) : -1;
    }
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = read_scalar(table, id[k],
                         b + k < head_prefix ? head_rows : num_rows);
    store_chunk(out, b, batch, v);
  }
}

using Dim1Kernel = void (*)(const float*, const int32_t*, float*, uint32_t,
                            uint32_t, uint32_t, uint32_t);

Dim1Kernel pick(int aligned_ids) {
  return aligned_ids ? gather_dim1_kernel<true> : gather_dim1_kernel<false>;
}

}  // namespace

// table (num_rows,) f32 (an (R, 1) table), ids (batch,) int32, out (batch,)
// f32; all contiguous, on the device of `stream`. Positions below
// head_prefix read against head_rows rows, the rest against num_rows. The
// plan (kernels.py gather_plan): `aligned_ids`, `blocks`. Refuses
// (cudaErrorInvalidValue) a plan it cannot run: 16-byte id loads on ids not
// so aligned, an output not 16-byte aligned, a head or a prefix past the
// table or the batch. Returns the launch's error (0 on success).
extern "C" int fps_gather_rows_dim1_f32(
    const void* table, const void* ids, void* out, long long num_rows,
    long long batch, long long head_rows, long long head_prefix,
    int aligned_ids, int blocks, void* stream) {
  if ((aligned_ids && !aligned(ids, 16)) || !aligned(out, 16) ||
      num_rows < 0 || num_rows >= (1ll << 31) || batch <= 0 ||
      batch >= (1ll << 31) || head_rows < 0 || head_rows > num_rows ||
      head_prefix < 0 || head_prefix > batch || blocks < 1)
    return cudaInvalid;
  Dim1Kernel kernel = pick(aligned_ids);
  int rc = launch(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                  static_cast<cudaStream_t>(stream), table, ids, out,
                  static_cast<uint32_t>(num_rows),
                  static_cast<uint32_t>(batch),
                  static_cast<uint32_t>(head_rows),
                  static_cast<uint32_t>(head_prefix));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

// The most blocks of the instance (aligned_ids) an SM holds at once.
extern "C" int fps_gather_dim1_blocks_per_sm(int aligned_ids) {
  return blocks_per_sm(reinterpret_cast<const void*>(pick(aligned_ids)));
}
