// K2: deterministic duplicate-combining scatter-add,
// table[r, :] += sum over b with ids[b] == r of deltas[b, :], in place;
// ids outside [0, R) are dropped.
//
// Replaces scatter_add_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _scatter_kernel). The TPU kernel builds a one-hot (rows x batch) matrix per
// tile and contracts it with the deltas, carrying each output block across
// the batch tiles of its sequential grid. CUDA blocks run in no order, so
// that carry does not exist here, and float atomics (what index_add_ uses on
// the card) would make the sum order, and so the bits, change from run to
// run. A push is Zipf-skewed: its hottest id owns up to tens of thousands of
// the batch's rows, so a design that walks one id's pushes serially spends
// milliseconds on that one chain.
//
// Design. One C call (fps_scatter_add_f32) sorts and sums on the caller's
// stream, every kernel launched with programmatic dependent launch (launch,
// pdl.cuh), so the card sets up a kernel while the one before it still runs:
//
//   sort. radix_sort.cu sorts the keys (the id, or R for a dropped id)
//      stably with their batch positions, on the bits R needs: 3 kernels
//      for each 8 bits. Each id's pushes form one run of sorted positions,
//      in batch order; dropped ids come last.
//   A. one block per tile of kTile sorted positions and chunk of up to 16
//      columns: each thread reads its position's delta row through the
//      permutation (its chunk's columns, contiguous, into registers; 16
//      bytes a load where the width is a multiple of 4), and
//      the block takes a segmented inclusive scan of the rows, keyed by run
//      (warp shuffles, then a scan of the warps' aggregates), in a fixed
//      tree. A run that starts and ends in the tile is added into its row
//      at once (the row read before the scan). The tile's last segment is
//      written out as the tile's partial, with a flag saying whether it
//      started in this tile; the sum of a run that began in an earlier tile
//      and ends in this one is kept aside. A tile whose first key is R holds
//      only dropped ids and stops there.
//   B. one block per column: a segmented inclusive scan of the tile
//      partials, in tile order, so each tile knows the sum of the run that
//      crosses into the next tile from all tiles before it. Then a run that
//      crossed into a tile and ends there takes that carry plus its share
//      from A, added into its row once.
//
// This is K4's segmented tree (scatter_add_dim1.cu) over rows of D columns.
// Every run is added into the table exactly once, and no two adds touch one
// row, so there are no atomics. The order of additions depends only on the
// sorted positions, so two launches give the same bits; it is a tree, not
// batch order, so the bits differ from index_add_'s on the CPU by float32
// rounding. A run as long as the batch costs what a uniform batch costs.
//
// Bound on the H100: bytes (ids and deltas read once, the touched rows read
// and written once). What this design spends beyond that: the sort's passes
// (keys and positions read twice and written once a pass), the gather of
// delta rows through the permutation (rows of D floats at random batch
// positions; from L2 where a push's deltas fit in it), and 3 * passes + 2
// launches a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"
#include "warp_tree.cuh"

// radix_sort.cu
extern "C" int fps_radix_sort_i32(const void* ids, long long num_rows,
                                  long long batch, void* work,
                                  long long work_words, void* stream);

namespace {

constexpr int kTile = 128;  // sorted positions per block; one per thread
constexpr int kWarps = kTile / 32;
constexpr int kMaxChunk = 16;  // most columns a block of pass A carries
constexpr int kCarryThreads = 1024;
constexpr int kBatch = 8;  // tiles a carry thread loads at a time

// Pass A over columns [c0, c0 + n) with n = min(width, dim - c0), c0 =
// blockIdx.y * width. tile_sum and first_sum are column-major: column c of
// tile b at [c * num_tiles + b].
template <int W>
__global__ void __launch_bounds__(kTile)
    rows_tile_pass(float* __restrict__ table,
                   const uint32_t* __restrict__ keys,
                   const int32_t* __restrict__ pos,
                   const float* __restrict__ deltas, uint32_t num_rows,
                   int64_t batch, int dim, int width, bool vec4,
                   float* __restrict__ tile_sum, int* __restrict__ tile_flag,
                   float* __restrict__ first_sum,
                   int* __restrict__ first_ends, int64_t num_tiles) {
  __shared__ int wf[kWarps];
  __shared__ float ws[kWarps][W];
  grid_wait();
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * width;
  const int n = width < dim - c0 ? width : dim - c0;
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int64_t rest = batch - base;
  const int len = rest < kTile ? static_cast<int>(rest) : kTile;
  float* tsum = tile_sum + c0 * num_tiles + tile;  // column c0 + j: j * tiles
  float* fsum = first_sum + c0 * num_tiles + tile;
  const bool live = tid < len;
  const int64_t i = base + tid;
  // Every key the thread needs and its batch position, in one round trip.
  const uint32_t first_key = keys[base];
  const uint32_t before = tile > 0 ? keys[base - 1] : ~0u;
  const uint32_t key = live ? keys[i] : num_rows;
  const uint32_t prev = live && tid > 0 ? keys[i - 1] : ~0u;
  const uint32_t next = live && i + 1 < batch ? keys[i + 1] : ~0u;
  const int32_t at = live ? pos[i] : 0;
  if (first_key >= num_rows) {
    // Dropped ids sort last: this tile and every later one hold only them.
    if (tid < n) tsum[tid * num_tiles] = 0.0f;
    if (blockIdx.y == 0 && tid == 0) {
      tile_flag[tile] = 1;
      first_ends[tile] = 0;
    }
    allow_next();
    return;
  }
  // The tile's first run began in an earlier tile.
  const bool continued = before == first_key;
  if (blockIdx.y == 0 && tid == 0) first_ends[tile] = 0;
  const int head = !live || tid == 0 || prev != key;
  const bool run_end = live && next != key;
  // This element's in-tile segment is the run that crossed into the tile.
  const bool from_before = continued && key == first_key;
  const bool writes_row = run_end && !from_before && key < num_rows;
  // The delta row, and the table row that a run ending here adds into,
  // both read before the scan.
  float s[W];
  float old[W];
  const float* row = deltas + static_cast<int64_t>(at) * dim + c0;
  float* out = table + static_cast<int64_t>(writes_row ? key : 0) * dim + c0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    s[j] = 0.0f;
    old[j] = 0.0f;
  }
  if (vec4) {
    // 16 bytes a load: rows, chunks and both arrays 16-byte aligned.
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      if (j < n && key < num_rows) {
        const float4 v = *reinterpret_cast<const float4*>(row + j);
        s[j] = v.x;
        s[j + 1] = v.y;
        s[j + 2] = v.z;
        s[j + 3] = v.w;
      }
      if (j < n && writes_row) {
        const float4 v = *reinterpret_cast<const float4*>(out + j);
        old[j] = v.x;
        old[j + 1] = v.y;
        old[j + 2] = v.z;
        old[j + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n && key < num_rows) s[j] = row[j];
      if (j < n && writes_row) old[j] = out[j];
    }
  }
  block_seg_scan<W>(n, head, s, wf, ws);
  // The carry pass may start once every block of this one is here: its
  // blocks cannot then take the places of this pass's later blocks.
  allow_next();
  if (!live) return;

  if (writes_row) {
    // The whole run lies in this tile.
#pragma unroll
    for (int j = 0; j < W; ++j) old[j] = old[j] + s[j];
    if (vec4) {
#pragma unroll
      for (int j = 0; j < W; j += 4) {
        if (j < n) {
          *reinterpret_cast<float4*>(out + j) =
              make_float4(old[j], old[j + 1], old[j + 2], old[j + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < n) out[j] = old[j];
      }
    }
  }
  if (run_end && from_before) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) fsum[j * num_tiles] = s[j];
    }
    if (blockIdx.y == 0) first_ends[tile] = 1;  // it ends in this tile
  }
  if (tid == len - 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) tsum[j * num_tiles] = s[j];
    }
    if (blockIdx.y == 0) tile_flag[tile] = from_before ? 0 : 1;
  }
}

// Pass B for column c = blockIdx.x: a segmented inclusive scan of the tile
// partials, in place, in tile order (afterwards tile_sum[c][b] is the sum
// of tile b's last run over tiles <= b; each thread folds a consecutive
// stretch of tiles); then each run that crossed into a tile and ends there
// is added into its row.
__global__ void __launch_bounds__(kCarryThreads)
    rows_carry_pass(float* __restrict__ table,
                    const uint32_t* __restrict__ keys,
                    float* __restrict__ tile_sum,
                    const int* __restrict__ tile_flag,
                    const float* __restrict__ first_sum,
                    const int* __restrict__ first_ends, uint32_t num_rows,
                    int dim, int64_t num_tiles) {
  __shared__ int wf[kCarryThreads / 32];
  __shared__ float ws[kCarryThreads / 32][1];
  __shared__ float incl[kCarryThreads];
  grid_wait();
  allow_next();
  const int c = blockIdx.x;
  float* col = tile_sum + c * num_tiles;
  const int tid = threadIdx.x;
  const int64_t per = (num_tiles + kCarryThreads - 1) / kCarryThreads;
  int64_t lo = static_cast<int64_t>(tid) * per;
  if (lo > num_tiles) lo = num_tiles;
  int64_t hi = lo + per;
  if (hi > num_tiles) hi = num_tiles;
  // Each loop takes kBatch tiles at a time, their loads issued together.
  int f = 0;
  float s[1] = {0.0f};
  for (int64_t b0 = lo; b0 < hi; b0 += kBatch) {
    float v[kBatch];
    int fl[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = b0 + u < hi ? col[b0 + u] : 0.0f;
      fl[u] = b0 + u < hi ? tile_flag[b0 + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b0 + u < hi) {
        s[0] = fl[u] ? v[u] : s[0] + v[u];
        f |= fl[u];
      }
    }
  }
  block_seg_scan<1>(1, f, s, wf, ws);
  incl[tid] = s[0];
  __syncthreads();
  float run = tid > 0 ? incl[tid - 1] : 0.0f;
  for (int64_t b0 = lo; b0 < hi; b0 += kBatch) {
    float v[kBatch];
    int fl[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = b0 + u < hi ? col[b0 + u] : 0.0f;
      fl[u] = b0 + u < hi ? tile_flag[b0 + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b0 + u < hi) {
        run = fl[u] ? v[u] : run + v[u];
        col[b0 + u] = run;
      }
    }
  }
  __syncthreads();  // every tile's carry is in col
  for (int64_t b0 = lo > 0 ? lo : 1; b0 < hi; b0 += kBatch) {
    int ends[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ends[u] = b0 + u < hi ? first_ends[b0 + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ends[u]) continue;
      const int64_t b = b0 + u;
      const uint32_t key = keys[b * kTile];
      if (key < num_rows) {
        table[static_cast<int64_t>(key) * dim + c] +=
            col[b - 1] + first_sum[c * num_tiles + b];
      }
    }
  }
}

template <int W>
int launch_tile_pass(dim3 grid, cudaStream_t s, float* table,
                     const uint32_t* keys, const int32_t* pos,
                     const float* deltas, uint32_t num_rows, int64_t batch,
                     int dim, int width, bool vec4, float* tile_sum,
                     int* tile_flag, float* first_sum, int* first_ends,
                     int64_t num_tiles) {
  return launch(rows_tile_pass<W>, grid, dim3(kTile), s, table, keys, pos,
                deltas, num_rows, batch, dim, width, vec4, tile_sum,
                tile_flag, first_sum, first_ends, num_tiles);
}

}  // namespace

// table (num_rows, dim) f32, updated in place; ids (batch,) int32; deltas
// (batch, dim) f32 in batch order. sort_work: int32 scratch for
// fps_radix_sort_i32 (4 * batch + 256 * max(64, ceil(batch / 4096))
// words); sum_work: at least (2 * dim + 2) * ceil(batch / 128) words. All
// contiguous, on the device of `stream`. Returns the first launch's error
// (0 on success), or cudaErrorInvalidValue for num_rows outside [0, 2^31),
// a batch of 2^31 or more, or too little scratch.
extern "C" int fps_scatter_add_f32(void* table, const void* ids,
                                   const void* deltas, long long num_rows,
                                   long long batch, int dim, void* sort_work,
                                   long long sort_words, void* sum_work,
                                   long long sum_words, void* stream) {
  if (batch <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = (batch + kTile - 1) / kTile;
  // Column chunks of at most kMaxChunk, as even as may be; multiples of 4
  // where the rows allow 16-byte loads.
  const int chunks = (dim + kMaxChunk - 1) / kMaxChunk;
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(deltas) % 16 == 0;
  int width = (dim + chunks - 1) / chunks;
  if (vec4) width = (width + 3) / 4 * 4;
  const int blocks_y = (dim + width - 1) / width;
  if (sum_words < (2LL * dim + 2) * tiles || blocks_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = fps_radix_sort_i32(ids, num_rows, batch, sort_work, sort_words,
                              stream);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* keys = static_cast<const uint32_t*>(sort_work);
  const int32_t* pos = static_cast<const int32_t*>(sort_work) + 2 * batch;
  float* t = static_cast<float*>(table);
  float* tile_sum = static_cast<float*>(sum_work);
  float* first_sum = tile_sum + dim * tiles;
  int* tile_flag = reinterpret_cast<int*>(first_sum + dim * tiles);
  int* first_ends = tile_flag + tiles;
  const uint32_t rows = static_cast<uint32_t>(num_rows);
  const float* d = static_cast<const float*>(deltas);
  const dim3 grid(static_cast<unsigned>(tiles), blocks_y);
#define FPS_TILE_PASS(W)                                                  \
  launch_tile_pass<W>(grid, s, t, keys, pos, d, rows, batch, dim, width, \
                      vec4, tile_sum, tile_flag, first_sum, first_ends, tiles)
  if (width <= 4) {
    rc = FPS_TILE_PASS(4);
  } else if (width <= 8) {
    rc = FPS_TILE_PASS(8);
  } else if (width <= 12) {
    rc = FPS_TILE_PASS(12);
  } else {
    rc = FPS_TILE_PASS(kMaxChunk);
  }
#undef FPS_TILE_PASS
  if (rc != 0) return rc;
  return launch(rows_carry_pass, dim3(static_cast<unsigned>(dim)),
                dim3(kCarryThreads), s, t, keys, tile_sum, tile_flag,
                first_sum, first_ends, rows, dim, tiles);
}
