// K3: deterministic scatter-add into the write-hot head rows,
// table[r, :] += sum over b with ids[b] == r of deltas[b, :] for r in [0, H),
// in place; ids outside [0, H) are left alone (the tail's scatter, or the
// drop contract, takes them). With H = R it is the whole table's push.
//
// Replaces scatter_add_packed_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _onehot_accum_kernel, with _split_hi_lo). The TPU kernel contracts a
// one-hot (head rows x batch) matrix with the deltas on the MXU: it packs
// 128 // D rows into each lane row and carries the deltas as bf16 hi+lo
// pairs (about 16 mantissa bits), and its sequential grid carries each output
// block across the batch tiles. None of that carries over: CUDA blocks run in
// no order, float atomics would change the sum order (and so the bits) from
// run to run, and the hi+lo split exists only to feed a bf16 matrix unit.
//
// What bounds it on the H100: the bytes of a push are small (ids and deltas
// read once, H x D written), so the bound is bytes; the design's cost is the
// one-hot work it keeps. It must not serialise on a hot row the way K2's
// per-run walk does (the head is where the Zipf-hot rows are), must not sort,
// and must accumulate in exact float32.
//
// Design: the one-hot contraction on CUDA cores, restricted to the pushes
// that hit each row tile.
//
//   1. One block per (row tile, column tile, batch slice). The block walks its
//      slice in chunks of 256 ids. Each chunk is compacted, in batch order
//      (ballot + prefix count), to the ids inside the block's row tile, and
//      their delta columns are staged in shared memory. Each thread owns up
//      to 8 rows of one column in registers and adds every staged delta of
//      its rows in batch order: a predicated add, no multiply, so the sum is
//      exact float32 and an out-of-tile NaN cannot reach a row. The block
//      writes its rows' sums for this slice to a (slices, H, D) scratch.
//   2. One thread per head element sums the slices' partials in slice order
//      and adds the result into the table once.
//
// Every (slice, row, column) sum has one owner and a fixed order, so two
// launches give the same bits; no atomics, no inter-block communication. The
// work is the same for any spread of the pushes over the head rows (each
// in-head push is staged once per column tile and added by the threads that
// own its row); a single hot row puts all of it into one row tile's blocks,
// and the wrapper picks enough slices that those blocks alone fill the card.
// What this design leaves for later: every row tile re-reads its slice's ids,
// and the adds run on CUDA cores, not on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads per block, ids per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;         // columns per column tile
constexpr int kRowsPerThread = 8;    // head rows a thread accumulates

__global__ void __launch_bounds__(kThreads)
    packed_partial_pass(const int32_t* __restrict__ ids,
                        const float* __restrict__ deltas,
                        float* __restrict__ partial, int64_t head_rows,
                        int64_t batch, int dim, int col_tile, int row_groups,
                        int64_t slice_len) {
  __shared__ int32_t s_loc[kThreads];    // compacted ids, relative to r0
  __shared__ int32_t s_pos[kThreads];    // their batch positions
  __shared__ float s_delta[kThreads * kMaxCols];
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * row_groups *
                     kRowsPerThread;
  int64_t r_end = r0 + static_cast<int64_t>(row_groups) * kRowsPerThread;
  if (r_end > head_rows) r_end = head_rows;
  const int c0 = blockIdx.y * col_tile;
  const int ncols = min(col_tile, dim - c0);
  const int64_t b0 = static_cast<int64_t>(blockIdx.z) * slice_len;
  int64_t b1 = b0 + slice_len;
  if (b1 > batch) b1 = batch;

  // Thread -> (row group, column): the row group's kRowsPerThread rows are
  // contiguous, local rows [first, first + kRowsPerThread) of the tile.
  const int col = tid % col_tile;
  const int rg = tid / col_tile;
  const bool owner = rg < row_groups && col < ncols;
  const int first = rg * kRowsPerThread;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  for (int64_t base = b0; base < b1; base += kThreads) {
    const int64_t pos = base + tid;
    const int32_t id = pos < b1 ? ids[pos] : -1;
    const bool hit = id >= r0 && id < r_end;  // r0 >= 0: drops -1 too
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      const int k = before + __popc(mask & ((1u << lane) - 1u));
      s_loc[k] = static_cast<int32_t>(id - r0);
      s_pos[k] = static_cast<int32_t>(pos);
    }
    __syncthreads();
    for (int e = tid; e < total * ncols; e += kThreads) {
      const int k = e / ncols;
      const int c = e - k * ncols;
      s_delta[k * kMaxCols + c] =
          deltas[static_cast<int64_t>(s_pos[k]) * dim + c0 + c];
    }
    __syncthreads();
    if (owner) {
      for (int k = 0; k < total; ++k) {
        const unsigned rel = static_cast<unsigned>(s_loc[k] - first);
        if (rel < kRowsPerThread) {
          const float v = s_delta[k * kMaxCols + col];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            if (rel == static_cast<unsigned>(i)) acc[i] += v;
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged entries
  }

  if (owner) {
    float* out = partial + static_cast<int64_t>(blockIdx.z) * head_rows * dim;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t r = r0 + first + i;
      if (r < r_end) out[r * dim + c0 + col] = acc[i];
    }
  }
}

// table[e] += sum over slices z, in order, of partial[z, e], for the first
// n = H * D elements of the table (the head rows, contiguous).
__global__ void packed_fold_pass(float* __restrict__ table,
                                 const float* __restrict__ partial, int64_t n,
                                 int64_t slices) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int64_t z = 0; z < slices; ++z) s += partial[z * n + e];
  table[e] += s;
}

}  // namespace

// table (num_rows >= head_rows, dim) f32, updated in place in its first
// head_rows rows; ids (batch,) int32, batch < 2^31; deltas (batch, dim) f32;
// partial: scratch of slices * head_rows * dim f32. All contiguous, on the
// device of `stream`. Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int fps_scatter_add_packed_f32(void* table, const void* ids,
                                          const void* deltas,
                                          long long head_rows,
                                          long long batch, int dim,
                                          void* partial, long long slices,
                                          void* stream) {
  if (head_rows <= 0 || batch <= 0 || dim <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (slices < 1 || slices > 65535 || batch >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_tile = dim < kMaxCols ? dim : kMaxCols;
  const int row_groups = kThreads / col_tile;
  const long long tile_rows = static_cast<long long>(row_groups) *
                              kRowsPerThread;
  const long long slice_len = (batch + slices - 1) / slices;
  dim3 grid(static_cast<unsigned>((head_rows + tile_rows - 1) / tile_rows),
            static_cast<unsigned>((dim + col_tile - 1) / col_tile),
            static_cast<unsigned>(slices));
  packed_partial_pass<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(deltas),
      static_cast<float*>(partial), head_rows, batch, dim, col_tile,
      row_groups, slice_len);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long n = head_rows * dim;
  const int threads = 256;
  packed_fold_pass<<<static_cast<unsigned>((n + threads - 1) / threads),
                     threads, 0, s>>>(static_cast<float*>(table),
                                      static_cast<const float*>(partial), n,
                                      slices);
  return static_cast<int>(cudaGetLastError());
}
