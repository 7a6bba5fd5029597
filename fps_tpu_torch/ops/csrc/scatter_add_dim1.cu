// K4: deterministic scalar-table scatter-add,
// table[r] += sum over b with ids[b] == r of deltas[b], in place, for an
// (R, 1) table; ids outside [0, R) are dropped.
//
// Replaces scatter_add_dim1_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _scatter_dim1_kernel). The TPU kernel contracts a packed one-hot of the ids
// with the deltas (carried as bf16 hi+lo, about 16 mantissa bits) over every
// packed row tile, carrying each output block across the sequential grid.
// CUDA blocks run in no order, and float atomics would change the sum order,
// and so the bits, from run to run. K2's answer (one thread adds a run of
// equal ids serially) does not serve here: the scalar workloads push 2^20 ids
// per step with Zipf-hot features, and the hottest row takes tens of
// thousands of pushes, one dependent add chain of milliseconds.
//
// Design. The wrapper sorts the ids stably (`sorted_ids`, with `order` the
// permutation), so each id's pushes form one run. The sorted positions are
// cut into tiles of kTile; three passes then reduce every run in a fixed tree
// order, in exact f32, with no atomics and no serial walk of a run:
//
//   A. one block per tile: a segmented inclusive scan of the tile's deltas
//      (warp shuffles, then a scan of the 32 warp aggregates), keyed by run.
//      A run that starts and ends in the tile is added into its row at once.
//      The tile's last segment is written out as the tile's partial, with a
//      flag saying whether it started in this tile; the sum of a run that
//      began in an earlier tile and ends in this one is kept aside.
//   B. one block: a segmented inclusive scan of the tile partials, in tile
//      order, so each tile knows the sum of the run that crosses into the
//      next tile from all tiles before it.
//   C. one thread per tile: a run that crossed into the tile and ends there
//      takes the carry from B plus its share from A, added into its row once.
//
// Every run is added into the table exactly once and no two adds touch one
// row. The order of additions depends only on the sorted positions, so two
// launches give the same bits, and a run as long as the batch costs what a
// uniform batch costs: the tree does the same work either way.
//
// Bound on the H100: bytes (ids and deltas read once, the touched rows read
// and written once). What this design spends beyond that: the stable sort in
// the wrapper, and the gather of deltas through `order` (4-byte reads at
// random, mostly L2 hits: the deltas of one push are 4 MB at most).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // sorted positions per block; one per thread
constexpr int kWarps = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool in_range(int32_t key, int64_t num_rows) {
  return key >= 0 && key < num_rows;
}

// Segmented inclusive scan within a warp: (f, s) pairs in lane order, f = 1
// where a segment starts. Fixed shuffle tree, so a fixed addition order.
__device__ __forceinline__ void warp_seg_scan(int lane, int& f, float& s) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float s_up = __shfl_up_sync(kFull, s, d);
    int f_up = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) s = s_up + s;
      f |= f_up;
    }
  }
}

// Segmented inclusive scan over the block's kTile threads. Returns the
// thread's segmented sum; uses `wf` / `ws` (kWarps entries) as scratch.
__device__ __forceinline__ float block_seg_scan(int f, float s, int* wf,
                                                float* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_seg_scan(lane, f, s);
  if (lane == 31) {
    wf[warp] = f;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    int wf_l = wf[lane];
    float ws_l = ws[lane];
    warp_seg_scan(lane, wf_l, ws_l);
    ws[lane] = ws_l;
  }
  __syncthreads();
  // No segment start between the warp's first lane and this one: the
  // segment reaches back into earlier warps, whose scan ends at its start.
  if (warp > 0 && !f) s = ws[warp - 1] + s;
  return s;
}

__global__ void __launch_bounds__(kTile)
    dim1_tile_pass(float* __restrict__ table,
                   const int32_t* __restrict__ keys,
                   const int64_t* __restrict__ order,
                   const float* __restrict__ deltas, int64_t num_rows,
                   int64_t batch, float* __restrict__ tile_sum,
                   int* __restrict__ tile_flag,
                   float* __restrict__ first_sum,
                   int* __restrict__ first_ends) {
  __shared__ int wf[kWarps];
  __shared__ float ws[kWarps];
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t rest = batch - base;
  const int n = rest < kTile ? static_cast<int>(rest) : kTile;
  const bool live = tid < n;
  const int64_t i = base + tid;
  const int32_t first_key = keys[base];
  // The tile's first run began in an earlier tile.
  const bool continued = blockIdx.x > 0 && keys[base - 1] == first_key;

  int32_t key = live ? keys[i] : 0;
  float v = (live && in_range(key, num_rows)) ? deltas[order[i]] : 0.0f;
  int head = !live || tid == 0 || keys[i - 1] != key;
  float s = block_seg_scan(head, v, wf, ws);
  if (!live) return;

  const bool run_end = (i + 1 == batch) || keys[i + 1] != key;
  // This element's in-tile segment is the run that crossed into the tile.
  const bool from_before = continued && key == first_key;
  if (run_end && !from_before && in_range(key, num_rows)) {
    table[key] += s;  // the whole run lies in this tile
  }
  if (run_end && from_before) first_sum[blockIdx.x] = s;
  if (tid == n - 1) {
    tile_sum[blockIdx.x] = s;
    tile_flag[blockIdx.x] = from_before ? 0 : 1;
  }
  if (tid == 0) {
    // The crossing run ends in this tile (then its last element set
    // first_sum above).
    const int64_t last = base + n - 1;
    const bool ends = keys[last] != first_key || last + 1 == batch ||
                      keys[last + 1] != first_key;
    first_ends[blockIdx.x] = (continued && ends) ? 1 : 0;
  }
}

// Segmented inclusive scan of the tile partials, in place, in tile order:
// afterwards tile_sum[b] is the sum of tile b's last run over tiles <= b.
// One block; each thread folds a contiguous stretch of tiles.
__global__ void __launch_bounds__(kTile)
    dim1_carry_pass(float* __restrict__ tile_sum,
                    const int* __restrict__ tile_flag, int64_t num_tiles) {
  __shared__ int wf[kWarps];
  __shared__ float ws[kWarps];
  __shared__ float incl[kTile];
  const int tid = threadIdx.x;
  const int64_t per = (num_tiles + kTile - 1) / kTile;
  int64_t lo = static_cast<int64_t>(tid) * per;
  if (lo > num_tiles) lo = num_tiles;
  int64_t hi = lo + per;
  if (hi > num_tiles) hi = num_tiles;
  int f = 0;
  float s = 0.0f;
  for (int64_t b = lo; b < hi; ++b) {
    s = tile_flag[b] ? tile_sum[b] : s + tile_sum[b];
    f |= tile_flag[b];
  }
  incl[tid] = block_seg_scan(f, s, wf, ws);
  __syncthreads();
  float run = tid > 0 ? incl[tid - 1] : 0.0f;
  for (int64_t b = lo; b < hi; ++b) {
    run = tile_flag[b] ? tile_sum[b] : run + tile_sum[b];
    tile_sum[b] = run;
  }
}

__global__ void dim1_finish_pass(float* __restrict__ table,
                                 const int32_t* __restrict__ keys,
                                 const float* __restrict__ carry,
                                 const float* __restrict__ first_sum,
                                 const int* __restrict__ first_ends,
                                 int64_t num_rows, int64_t num_tiles) {
  int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b == 0 || b >= num_tiles || !first_ends[b]) return;
  int32_t key = keys[b * kTile];
  if (in_range(key, num_rows)) table[key] += carry[b - 1] + first_sum[b];
}

}  // namespace

// table (num_rows,) f32 (an (R, 1) table), updated in place; sorted_ids
// (batch,) int32 in ascending order, stable; order (batch,) int64 with
// sorted_ids[i] == ids[order[i]]; deltas (batch,) f32 in the original batch
// order. Scratch: tile_sum and first_sum f32, tile_flag and first_ends int32,
// num_tiles = ceil(batch / 1024) entries each. All contiguous, on the device
// of `stream`. Returns cudaGetLastError() after the launches (0 on success),
// or cudaErrorInvalidValue if num_tiles does not match the batch.
extern "C" int fps_scatter_add_dim1_f32(
    void* table, const void* sorted_ids, const void* order, const void* deltas,
    long long num_rows, long long batch, void* tile_sum, void* tile_flag,
    void* first_sum, void* first_ends, long long num_tiles, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (num_tiles != (batch + kTile - 1) / kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  const int32_t* k = static_cast<const int32_t*>(sorted_ids);
  float* ts = static_cast<float*>(tile_sum);
  int* tf = static_cast<int*>(tile_flag);
  float* fs = static_cast<float*>(first_sum);
  int* fe = static_cast<int*>(first_ends);
  dim1_tile_pass<<<static_cast<unsigned>(num_tiles), kTile, 0, s>>>(
      t, k, static_cast<const int64_t*>(order),
      static_cast<const float*>(deltas), num_rows, batch, ts, tf, fs, fe);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  dim1_carry_pass<<<1, kTile, 0, s>>>(ts, tf, num_tiles);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int threads = 256;
  long long blocks = (num_tiles + threads - 1) / threads;
  dim1_finish_pass<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      t, k, ts, fs, fe, num_rows, num_tiles);
  return static_cast<int>(cudaGetLastError());
}
