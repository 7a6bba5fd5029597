// K4: deterministic scalar-table scatter-add,
// table[r] += sum over b with ids[b] == r of deltas[b], in place, for an
// (R, 1) table; ids outside [0, R) are dropped.
//
// Replaces scatter_add_dim1_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _scatter_dim1_kernel). The TPU kernel contracts a packed one-hot of the ids
// with the deltas (carried as bf16 hi+lo, about 16 mantissa bits) over every
// packed row tile, keeping its output row tile resident across the batch
// tiles of its sequential grid. CUDA blocks run in no order, and float
// atomics would change the sum order, and so the bits, from run to run. The
// scalar workloads push up to 2^20 ids a step with Zipf-hot features, so the
// hottest row takes tens of thousands of pushes: no run may be walked
// serially.
//
// What bounds it on the H100: bytes (ids and deltas read once, the touched
// rows read and written once). At one column a row is 4 bytes, so a row
// tile of about 50,000 rows (and a flag byte for each 4 rows) fits in a
// block's 227 KB of shared memory: the whole table on every path but the
// 1M-feature logistic regression. The design keeps the TPU kernel's
// resident output tile and sorts nothing globally:
//
//   0. Only when the table is more than one tile: a bucket pass by row tile.
//      (a) Each block of the pass counts its batch slice's kept ids by bucket
//      (a bucket is one row tile, or a few past 256 tiles). (b) Each block
//      takes its place in every bucket from those counts (the buckets before,
//      then the blocks before it in the bucket), and writes each kept push as
//      its id and its delta to its bucket's stretch, stably, ranked in rounds
//      of 2,048 by the ballot-per-bit peers of the bucket digit. The delta
//      travels with its id: nothing is gathered through a permutation later.
//      Dropped ids are left out here. Block 0 writes the buckets' starts.
//   1. The tile pass: clusters of up to 8 blocks, about one block a
//      multiprocessor. Cluster c takes the c-th of C even parts of the
//      pushes in bucket order, whatever the buckets hold, so a hot tile is
//      spread over as many clusters as its pushes need and the grid is
//      fixed at launch (with a bucket pass each bucket weighs a fixed count
//      of pushes more than it holds, for what a piece costs beside its
//      pushes). Each piece of that part (the pushes of one bucket) is cut
//      evenly over the cluster's blocks. A block keeps the tile in shared
//      memory, a float a row, at -0.0 where unwritten (x + -0.0 == x for
//      every float, so a row's first add stores and an unwritten row adds
//      nothing). Each warp stages its 128 of a chunk of 1,024 by cp.async
//      one chunk ahead, sorts them by (row, place) in registers (a bitonic
//      network) and sums each run by a segmented shuffle scan; the warps add
//      their runs' sums into the tile in warp order, chunk after chunk,
//      handing on through a ring of named barriers (no block barrier), and
//      flag each written group of 4 rows. The cluster then sums, through
//      distributed shared memory, each group some block flagged, over the
//      blocks that flagged it in rank order, each block a share of the
//      groups: into the table where the cluster held the whole bucket, else
//      into its partial, every row of the tile, to global scratch. Each
//      block then puts back -0.0 where it wrote.
//   2. Only with more than one cluster: the fold adds, for each row of a
//      bucket that more than one cluster held, the clusters' partials in
//      cluster order into the table.
//
// Every sum has a fixed order (batch order within a warp's run, warps in
// order, chunks in order, blocks in rank order, clusters in order), so two
// launches give the same bits; no atomics. One id owning every push costs
// what a uniform batch costs: its pushes are cut over the clusters, blocks
// and warps like any others. The kernels a call depend on the plan only: 2
// for the bucket pass, 1 for the tile pass, 1 for the fold
// (kernels.dim1_plan), each launched with programmatic dependent launch. A
// kernel lets the next one start as soon as it has waited for the one
// before it; the next waits in turn for it to finish before it reads.
//
// What this design still pays for (PERF.md): each piece a cluster holds
// costs a reduction of its whole tile through distributed shared memory
// (bound by that memory's bandwidth where the tile is dense), two cluster
// barriers and a reset, whatever the piece's pushes; a table of many tiles
// makes many pieces, and its push four kernels, two of them the bucket
// pass's latency-bound rounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"
#include "warp_tree.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The bucket pass takes its ids in rounds of kChunk, kItems a thread.
constexpr int kItems = 8;
constexpr int kWarpSpan = 32 * kItems;     // consecutive ones a warp
constexpr int kChunk = kThreads * kItems;
constexpr int kRadix = 256;                // 8-bit bucket digits
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxSmem = 232448;    // 227 KB, a block's most
constexpr int kMaxBuckets = 256;    // buckets of the bucket pass, 8 bits
constexpr int kMaxBucketBlocks = 512;  // blocks of the bucket pass
constexpr int kFoldThreads = 256;
constexpr uint32_t kNegZero = 0x80000000u;  // the bits of -0.0f

// The tile pass takes its pushes in chunks of kTileChunk, kTileItems a
// thread; each warp stages its own part of a chunk. Its shared memory, in
// bytes: the ids and the deltas of two chunks; the buckets' starts, 16-byte
// padded; then the tile, a float a row (tile_rows, a multiple of
// kGroupRows * 16 so that the flags after it are 16-byte aligned); then a
// flag byte for each group of kGroupRows rows: whether the block has
// written the group.
constexpr int kTileItems = 4;
constexpr int kTileChunk = kThreads * kTileItems;
constexpr int kStagedBytes = 2 * kTileChunk * 4;
constexpr int kValueBytes = 2 * kTileChunk * 4;
constexpr int kBucketBytes = kMaxBuckets * 4 + 16;
constexpr int kFixedSmem = kStagedBytes + kValueBytes + kBucketBytes;
constexpr int kGroupRows = 4;        // rows a flag byte, a float4
constexpr int kWarpBatch = 32 * kTileItems;  // a warp's entries of a chunk
constexpr int kPosBits = 7;          // an entry's place in its warp's batch
constexpr int kTileAlign = kGroupRows * 16;  // rows: 16 bytes of flags
static_assert(kFixedSmem % 16 == 0, "the tile is 16-byte aligned");
static_assert(kMaxBuckets <= kThreads, "a thread a bucket");
static_assert(kWarpBatch == 1 << kPosBits, "a place fills kPosBits");

// commit_staged() closes the cp.async copies a thread has started so far as
// one group, and staged_but<N>() waits until at most N of its groups are in
// flight.
__device__ __forceinline__ void commit_staged() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void staged_but() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A warp's part of a chunk, the pushes [at, at + 128) before `end`: lane l
// copies ids and deltas 4l .. 4l + 3 of it into its own slots (so that it
// can read its ids once its own copies are in), as one group.
__device__ __forceinline__ void stage_part(int32_t* ids_to, float* vals_to,
                                           const int32_t* __restrict__ ids,
                                           const float* __restrict__ vals,
                                           int64_t at, int64_t end) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int i = kTileItems * lane + r;
    if (at + i < end) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(
                           ids_to + i))),
                   "l"(ids + at + i)
                   : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(
                           vals_to + i))),
                   "l"(vals + at + i)
                   : "memory");
    }
  }
  commit_staged();
}

// Named barrier `id` (1 .. 15; 0 is __syncthreads') of `n` threads: wait for
// the others, or only count this warp in.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Part p of n positions cut in `parts`: it starts at share(n, p, parts).
__device__ __forceinline__ int64_t share(int64_t n, int64_t p,
                                         int64_t parts) {
  return n * p / parts;
}

// The part of `parts` (as share cuts n) that holds position i < n.
__device__ __forceinline__ int64_t part_of(int64_t i, int64_t n,
                                           int64_t parts) {
  return ((i + 1) * parts - 1) / n;
}

// The bucket of an id, -1 for an id outside [0, num_rows).
__device__ __forceinline__ int bucket_of(int32_t id, int64_t num_rows,
                                         int bucket_rows) {
  return id >= 0 && id < num_rows ? id / bucket_rows : -1;
}

// Bucket pass (a): block g counts the kept ids of its batch slice by
// bucket, counts[bucket * blocks + g]. A warp's lanes of one bucket are
// counted by the lowest of them (peers_of), one writer a counter.
__global__ void __launch_bounds__(kThreads)
    dim1_bucket_count(const int32_t* __restrict__ ids, int64_t num_rows,
                      int64_t batch, int bucket_rows, int buckets, int bits,
                      int* __restrict__ counts) {
  __shared__ int wcount[kWarps][kMaxBuckets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kWarps * kMaxBuckets; i += kThreads) {
    wcount[i / kMaxBuckets][i % kMaxBuckets] = 0;
  }
  grid_wait();  // the ids are written by the work before
  allow_next();
  __syncthreads();
  const int64_t lo = share(batch, blockIdx.x, gridDim.x);
  const int64_t hi = share(batch, blockIdx.x + 1, gridDim.x);
  for (int64_t base = lo; base < hi; base += kChunk) {
    int d[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + warp * kWarpSpan + k * 32 + lane;
      d[k] = i < hi ? bucket_of(ids[i], num_rows, bucket_rows) : -1;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned peers = peers_of(d[k], bits, d[k] >= 0);
      if (d[k] >= 0 && lane == __ffs(peers) - 1) {
        wcount[warp][d[k]] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int b = tid; b < buckets; b += kThreads) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += wcount[w][b];
    counts[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] = n;
  }
}

// Bucket pass (b): block g writes each kept push of its slice, its id and
// its delta, to out_ids / out_vals at its place in its bucket: after the
// buckets before it, then after the same bucket's pushes of the blocks
// before g, then in batch order. Block 0 writes starts[b], where bucket b
// starts, and starts[buckets], the pushes kept.
__global__ void __launch_bounds__(kThreads)
    dim1_bucket_scatter(const int32_t* __restrict__ ids,
                        const float* __restrict__ deltas, int64_t num_rows,
                        int64_t batch, int bucket_rows, int buckets, int bits,
                        const int* __restrict__ counts,
                        int* __restrict__ starts,
                        int32_t* __restrict__ out_ids,
                        float* __restrict__ out_vals) {
  __shared__ __align__(16) uint16_t count[kRadix][kWarps];
  __shared__ int place[kMaxBuckets];   // the next place of each bucket
  __shared__ int in_round[kMaxBuckets];  // each bucket's pushes this round
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.x;
  const int radix = 1 << bits;
  grid_wait();  // the counts (and ids, deltas) are written
  allow_next();
  // Each bucket's pushes in the blocks before this one (into place) and in
  // every block (into in_round): a warp a bucket, its lanes over the
  // blocks' counts of it (contiguous), then a shuffle sum (exact integers,
  // so any order).
  for (int b = warp; b < buckets; b += kWarps) {
    const int* of = counts + static_cast<int64_t>(b) * gridDim.x;
    int c[kMaxBucketBlocks / 32];
#pragma unroll
    for (int m = 0; m < kMaxBucketBlocks / 32; ++m) {  // every load first
      const int q = lane + 32 * m;
      c[m] = q < static_cast<int>(gridDim.x) ? of[q] : 0;
    }
    int before = 0;
    int total = 0;
#pragma unroll
    for (int m = 0; m < kMaxBucketBlocks / 32; ++m) {
      total += c[m];
      before += lane + 32 * m < g ? c[m] : 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      total += __shfl_xor_sync(kFull, total, d);
      before += __shfl_xor_sync(kFull, before, d);
    }
    if (lane == 0) {
      place[b] = before;
      in_round[b] = total;
    }
  }
  __syncthreads();
  const int total = tid < buckets ? in_round[tid] : 0;
  // Where each bucket starts: the exclusive scan of the totals, a thread a
  // bucket.
  int incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int start = incl - total;
  for (int w = 0; w < warp; ++w) start += warp_sum[w];
  if (tid < buckets) {
    place[tid] += start;
    if (g == 0) starts[tid] = start;
    if (g == 0 && tid == buckets - 1) starts[buckets] = start + total;
  }
  const int64_t lo = share(batch, g, gridDim.x);
  const int64_t hi = share(batch, g + 1, gridDim.x);
  const unsigned below = (1u << lane) - 1u;
  for (int64_t base = lo; base < hi; base += kChunk) {
    int32_t id[kItems];
    float val[kItems];
    int d[kItems];
    unsigned peers[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + warp * kWarpSpan + k * 32 + lane;
      id[k] = i < hi ? ids[i] : -1;
      val[k] = i < hi ? deltas[i] : 0.0f;
    }
    if (tid < radix) {
      *reinterpret_cast<uint4*>(count[tid]) = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // also: every place of the round before is updated
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      d[k] = bucket_of(id[k], num_rows, bucket_rows);
      peers[k] = peers_of(d[k], bits, d[k] >= 0);
      if (d[k] >= 0 && lane == __ffs(peers[k]) - 1) {
        count[d[k]][warp] += __popc(peers[k]);
      }
      __syncwarp();
    }
    __syncthreads();
    // Each warp's count of a bucket becomes the count in the warps before.
    if (tid < radix) {
      uint4 raw = *reinterpret_cast<const uint4*>(count[tid]);
      uint16_t* c = reinterpret_cast<uint16_t*>(&raw);
      int at = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = c[w];
        c[w] = static_cast<uint16_t>(at);
        at += n;
      }
      *reinterpret_cast<uint4*>(count[tid]) = raw;
      if (tid < buckets) in_round[tid] = at;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (d[k] >= 0) {
        const int at =
            place[d[k]] + count[d[k]][warp] + __popc(peers[k] & below);
        out_ids[at] = id[k];
        out_vals[at] = val[k];
      }
      __syncwarp();  // every lane has read its place before it moves on
      if (d[k] >= 0 && lane == __ffs(peers[k]) - 1) {
        count[d[k]][warp] += __popc(peers[k]);
      }
      __syncwarp();
    }
    __syncthreads();
    if (tid < buckets) place[tid] += in_round[tid];
  }
}

// Sorts a warp's kWarpBatch keys ascending (a bitonic network in registers
// and shuffles): lane l holds keys kTileItems * l .. kTileItems * (l + 1) -
// 1 before and after.
__device__ __forceinline__ void warp_sort(uint32_t (&a)[kTileItems]) {
  constexpr int n = kTileItems;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= kWarpBatch; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < n; ++r) {
        const int i = lane * n + r;
        const bool up = (i & k) == 0;  // this stretch sorts ascending
        if (j >= n) {
          // The partner is key i ^ j, register r of lane l ^ (j / n).
          const uint32_t o = __shfl_xor_sync(kFull, a[r], j / n);
          a[r] = ((i & j) == 0) == up ? min(a[r], o) : max(a[r], o);
        } else if ((r & j) == 0) {
          const uint32_t x = a[r];
          const uint32_t y = a[r + j < n ? r + j : r];
          a[r] = up ? min(x, y) : max(x, y);
          a[r + j < n ? r + j : r] = up ? max(x, y) : min(x, y);
        }
      }
    }
  }
}

// The sort keys of a warp's part of a chunk, its n ids (staged in its
// slots) for the tile of rows [r0, r0 + rows): lane l takes 4 consecutive
// ones, those it staged; a key is (the row in the tile, or `rows` for an id
// outside it) << kPosBits | the entry's place in the part, and ~0 past the
// part (last, never added).
__device__ __forceinline__ void part_keys(uint32_t (&a)[kTileItems],
                                          const int32_t* ids, int n,
                                          int64_t r0, int rows) {
  const int lane = threadIdx.x & 31;
  static_assert(kTileItems == 4,
                "a lane's ids are one int4, the ones it staged");
  const int4 at = reinterpret_cast<const int4*>(ids)[lane];
  const int32_t id[kTileItems] = {at.x, at.y, at.z, at.w};
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int i = lane * kTileItems + r;
    const int64_t row = static_cast<int64_t>(id[r]) - r0;
    const uint32_t key = row >= 0 && row < rows ? static_cast<uint32_t>(row)
                                                : static_cast<uint32_t>(rows);
    a[r] = i < n ? key << kPosBits | static_cast<uint32_t>(i) : ~0u;
  }
}

// Adds a warp's part of a chunk into the tile of `rows` rows, from its keys
// (part_keys) and its deltas (staged in its slots). The warp sorts its 128
// keys, so each row's pushes form a run in batch order, sums each run by a
// segmented scan (a fixed shuffle tree), and the last entry of a run holds
// the run's sum. The warps add their sums into the tile in warp order, and
// chunks in order: a ring of named barriers, warp w waiting for warp w - 1
// (warp 0 for warp 7 of the chunk before, unless `first`) and letting warp
// w + 1 go (unless `last`). Within a warp each row has one run, so one
// writer a row, and every row's sum has a fixed order; a warp sorts its
// next part while the warps after it add. Each add flags the row's group.
__device__ __forceinline__ void add_part(uint32_t (&a)[kTileItems],
                                         float* tile, uint8_t* flags,
                                         const float* vals, int rows,
                                         bool first, bool last) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sort(a);
  int key[kTileItems];
  float x[kTileItems];
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const bool live = a[r] != ~0u;
    key[r] = live ? static_cast<int>(a[r] >> kPosBits) : -1;
    x[r] = live ? vals[a[r] & (kWarpBatch - 1)] : 0.0f;
  }
  // Where runs start: at the warp's first entry, or where the key changes.
  const int before_key = __shfl_up_sync(kFull, key[kTileItems - 1], 1);
  const int after_key = __shfl_down_sync(kFull, key[0], 1);
  bool starts[kTileItems];
  int f = 0;
  float s[1];
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int prev = r > 0 ? key[r > 0 ? r - 1 : 0]
                           : (lane > 0 ? before_key : -2);
    starts[r] = key[r] != prev;
    s[0] = starts[r] || r == 0 ? x[r] : s[0] + x[r];
    f |= starts[r];
  }
  // s: the lane's last run so far; after the scan, that run's sum over the
  // lanes up to this one.
  warp_seg_scan<1>(lane, 1, f, s);
  const float up = __shfl_up_sync(kFull, s[0], 1);
  float run = lane > 0 ? up : 0.0f;
  bool ends[kTileItems];
  float sum[kTileItems];
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    run = starts[r] ? x[r] : run + x[r];
    const int next = r + 1 < kTileItems
                         ? key[r + 1 < kTileItems ? r + 1 : r]
                         : (lane < 31 ? after_key : -2);
    ends[r] = key[r] >= 0 && key[r] < rows && key[r] != next;
    sum[r] = run;
  }
  // Barrier 1 + w: warp w - 1 (mod kWarps) arrives, warp w waits.
  if (!(first && warp == 0)) bar_sync(1 + warp, 64);
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    if (ends[r]) {
      tile[key[r]] += sum[r];
      // Lanes of one group may store this byte together; they store the
      // same value.
      flags[key[r] / kGroupRows] = 1;
    }
  }
  __threadfence_block();  // the adds are seen before the next warp's
  if (!(last && warp == kWarps - 1)) bar_arrive(1 + (warp + 1) % kWarps, 64);
}

// The 16 rows of a flag word's 4 groups (16u .. 16u + 15) to out: stored
// as they are (a partial), or, where `add`, each row of a group flagged in
// `wrote`, among the first `rows`, that holds more than -0.0 added to its
// value in the table, cur (read before).
__device__ __forceinline__ void put_word(float* out, int u,
                                         const float4 (&t)[4],
                                         const float (&cur)[16],
                                         uint32_t wrote, bool add, int rows) {
  if (!add) {
    float4* o = reinterpret_cast<float4*>(out) + 4 * u;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) o[gi] = t[gi];
    return;
  }
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const float v[4] = {t[gi].x, t[gi].y, t[gi].z, t[gi].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * u + 4 * gi + i;
      if (((wrote >> (8 * gi)) & 0xffu) && r < rows &&
          __float_as_uint(v[i]) != kNegZero) {
        out[r] = cur[4 * gi + i] + v[i];
      }
    }
  }
}

// The table's values of a flag word's 16 rows, where `add` and some group
// of the word is flagged in `wrote` (else 0).
__device__ __forceinline__ void read_word(const float* out, int u,
                                          uint32_t wrote, bool add, int rows,
                                          float (&cur)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * u + i;
    cur[i] = add && wrote != 0u && r < rows ? out[r] : 0.0f;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The tile pass. Blocks in clusters of cluster_size along x, `clusters` of
// them, cutting the pushes with each bucket weighted by piece_weight. ids /
// vals: the pushes in bucket order with starts[0, buckets] (the
// bucket pass's), or, with starts null, the batch itself as one bucket
// (ids outside [0, num_rows) among them). A bucket is tiles_per_bucket row
// tiles of tile_rows rows. A cluster that holds a bucket's whole stretch
// adds it into the table; any other writes its partial of each tile of the
// bucket, every row (-0.0 where nothing was written), to
// partial[((c + b) * tiles_per_bucket + j) * tile_rows], for the fold.
__global__ void __launch_bounds__(kThreads, 1)
    dim1_tile_pass(float* __restrict__ table, const int32_t* __restrict__ ids,
                   const float* __restrict__ vals,
                   const int* __restrict__ starts,
                   float* __restrict__ partial, int64_t num_rows,
                   int64_t batch, int tile_rows, int tiles_per_bucket,
                   int buckets, int piece_weight, int cluster_size,
                   int clusters) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* staged = reinterpret_cast<int32_t*>(smem);  // [2][kTileChunk]
  float* staged_vals =  // [2][kTileChunk]
      reinterpret_cast<float*>(smem + kStagedBytes);
  int* bstart = reinterpret_cast<int*>(smem + kStagedBytes + kValueBytes);
  float* tile = reinterpret_cast<float*>(smem + kFixedSmem);
  float4* tile4 = reinterpret_cast<float4*>(tile);
  uint8_t* flags = reinterpret_cast<uint8_t*>(tile + tile_rows);
  uint32_t* flags32 = reinterpret_cast<uint32_t*>(flags);

  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x / cluster_size;
  const int k = static_cast<int>(blockIdx.x % cluster_size);
  const int64_t bucket_rows = static_cast<int64_t>(tiles_per_bucket) *
                              tile_rows;
  const int n4 = tile_rows / kGroupRows;  // groups (float4s) of the tile
  const int n32 = n4 / 4;                 // flag words, 4 groups each
  const float4 neg_zero = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
  // The tile starts at -0.0 and no group flagged; after each tile the block
  // puts back only what it wrote.
  for (int e = tid; e < n4; e += kThreads) tile4[e] = neg_zero;
  for (int e = tid; e < n32; e += kThreads) flags32[e] = 0u;

  grid_wait();  // the pushes (and the table) are written by the work before
  allow_next();
  for (int b = tid; b <= buckets; b += kThreads) {
    bstart[b] = starts != nullptr ? starts[b]
                                  : (b == 0 ? 0 : static_cast<int>(batch));
  }
  __syncthreads();
  // The cut: bucket b weighs its pushes plus piece_weight (what a piece
  // costs beside its pushes), so that a cluster holding many light pieces
  // holds fewer pushes. In those units bucket b's pushes lie at
  // [bstart[b] + (b + 1) w, bstart[b + 1] + (b + 1) w) of v positions.
  const int64_t v = bstart[buckets] +
                    static_cast<int64_t>(buckets) * piece_weight;
  const int64_t vlo = share(v, c, clusters);
  const int64_t vhi = share(v, c + 1, clusters);
  for (int b = 0; b < buckets; ++b) {
    const int64_t w = static_cast<int64_t>(b + 1) * piece_weight;
    const int64_t at = vlo - w > bstart[b] ? vlo - w : bstart[b];
    const int64_t end = vhi - w < bstart[b + 1] ? vhi - w : bstart[b + 1];
    if (at >= end) continue;  // none of this cluster's pushes
    const bool whole = at == bstart[b] && end == bstart[b + 1];
    const int64_t s0 = at + (end - at) * k / cluster_size;
    const int64_t s1 = at + (end - at) * (k + 1) / cluster_size;
    for (int j = 0; j < tiles_per_bucket; ++j) {
      const int64_t r0 = b * bucket_rows + static_cast<int64_t>(j) * tile_rows;
      if (r0 >= num_rows) break;  // the last bucket's tiles past the table
      const int rows = static_cast<int>(
          num_rows - r0 < tile_rows ? num_rows - r0 : tile_rows);
      // The block's pushes, a chunk at a time; each warp stages its part of
      // the next chunk while it sums this one.
      const int64_t chunks = (s1 - s0 + kTileChunk - 1) / kTileChunk;
      const int part = (tid >> 5) * kWarpBatch;  // the warp's slots
      if (chunks > 0) {
        stage_part(staged + part, staged_vals + part, ids, vals, s0 + part,
                   s1);
      }
      for (int64_t ci = 0; ci < chunks; ++ci) {
        const int64_t at = s0 + ci * kTileChunk + part;
        const int cur = static_cast<int>(ci & 1) * kTileChunk + part;
        if (ci + 1 < chunks) {
          const int nxt = static_cast<int>((ci + 1) & 1) * kTileChunk + part;
          stage_part(staged + nxt, staged_vals + nxt, ids, vals,
                     at + kTileChunk, s1);
          staged_but<1>();
        } else {
          staged_but<0>();
        }
        __syncwarp();  // every lane's copies are in
        const int64_t left = s1 - at;
        const int n = static_cast<int>(
            left < 0 ? 0 : (left < kWarpBatch ? left : kWarpBatch));
        uint32_t a[kTileItems];
        part_keys(a, staged + cur, n, r0, rows);
        add_part(a, tile, flags, staged_vals + cur, rows, ci == 0,
                 ci + 1 == chunks);
        __syncwarp();  // every lane is done with these slots
      }
      __syncthreads();  // every chunk's runs are in the tile

      float* dst = whole ? table + r0
                         : partial + ((c + b) * tiles_per_bucket + j) *
                                         static_cast<int64_t>(tile_rows);
      if (cluster_size == 1) {
        for (int u = tid; u < n32; u += kThreads) {
          const float4 t[4] = {tile4[4 * u], tile4[4 * u + 1],
                               tile4[4 * u + 2], tile4[4 * u + 3]};
          float cur[16];
          read_word(dst, u, flags32[u], whole, rows, cur);
          put_word(dst, u, t, cur, flags32[u], whole, rows);
        }
        __syncthreads();  // every group is out before any is put back
      } else {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every block of the cluster has its piece's sums
        const uint32_t* flags_of[kMaxCluster];
        const float4* tile_of[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          flags_of[q] = cluster.map_shared_rank(flags32,
                                                q < cluster_size ? q : 0);
          tile_of[q] = cluster.map_shared_rank(tile4,
                                               q < cluster_size ? q : 0);
        }
        // This block's share of the groups, 4 at a time (a flag word): the
        // groups some block wrote, summed over the blocks that wrote them in
        // rank order; the others are -0.0 (stored only into a partial). A
        // word's loads (its groups from each block, its rows of the table,
        // the next word's flags) all go out before any is used.
        const int hi32 = n32 * (k + 1) / cluster_size;
        int u = n32 * k / cluster_size + tid;
        uint32_t fw[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          fw[q] = q < cluster_size && u < hi32 ? flags_of[q][u] : 0u;
        }
        for (; u < hi32; u += kThreads) {
          uint32_t any = 0u;
#pragma unroll
          for (int q = 0; q < kMaxCluster; ++q) any |= fw[q];
          float4 w[4][kMaxCluster];
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q) {
              if ((fw[q] >> (8 * gi)) & 0xffu) {
                w[gi][q] = tile_of[q][4 * u + gi];
              }
            }
          }
          float cur[16];
          read_word(dst, u, any, whole, rows, cur);
          const int next = u + kThreads;
          uint32_t fn[kMaxCluster];
#pragma unroll
          for (int q = 0; q < kMaxCluster; ++q) {
            fn[q] = q < cluster_size && next < hi32 ? flags_of[q][next] : 0u;
          }
          float4 t[4];
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            t[gi] = neg_zero;
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q) {
              if ((fw[q] >> (8 * gi)) & 0xffu) {
                t[gi] = add4(t[gi], w[gi][q]);
              }
            }
          }
          put_word(dst, u, t, cur, any, whole, rows);
#pragma unroll
          for (int q = 0; q < kMaxCluster; ++q) fw[q] = fn[q];
        }
        cluster.sync();  // no block resets its tile while another reads it
      }
      // Put back what this block wrote: -0.0, no flag.
      for (int u = tid; u < n32; u += kThreads) {
        const uint32_t fw = flags32[u];
        if (fw == 0u) continue;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          if ((fw >> (8 * gi)) & 0xffu) tile4[4 * u + gi] = neg_zero;
        }
        flags32[u] = 0u;
      }
      __syncthreads();  // the next tile starts from a clean one
    }
  }
}

// Where bucket b's pushes were cut (see the tile pass): into clusters c0 ..
// c1 (c0 == c1: one cluster held the bucket and added it), of which cluster
// q held some iff live(q).
struct Cut {
  int64_t v, c0, c1;
  int clusters;
  __device__ Cut(const int* starts, int64_t batch, int64_t b, int buckets,
                 int piece_weight, int clusters_)
      : clusters(clusters_) {
    const int64_t s = starts != nullptr ? starts[b] : 0;
    const int64_t e = starts != nullptr ? starts[b + 1] : batch;
    const int64_t n = starts != nullptr ? starts[buckets] : batch;
    v = n + static_cast<int64_t>(buckets) * piece_weight;
    const int64_t w = (b + 1) * piece_weight;
    c0 = s < e ? part_of(s + w, v, clusters) : 0;
    c1 = s < e ? part_of(e - 1 + w, v, clusters) : 0;
  }
  __device__ bool live(int64_t q) const {
    return share(v, q, clusters) != share(v, q + 1, clusters);
  }
};

// The fold: for each row r of a bucket that more than one cluster held,
// table[r] += the sum, in cluster order, of those clusters' partials of r
// (-0.0 where a cluster wrote nothing, so adding it changes nothing). A
// thread takes 4 rows (a bucket is a multiple of 64 rows, so they lie in
// one bucket and one float4 of each partial); a block works out the cut of
// its first row's bucket once.
__global__ void __launch_bounds__(kFoldThreads)
    dim1_fold_pass(float* __restrict__ table,
                   const float* __restrict__ partial,
                   const int* __restrict__ starts, int64_t num_rows,
                   int64_t batch, int tile_rows, int tiles_per_bucket,
                   int buckets, int piece_weight, int clusters) {
  constexpr int kCached = 256;  // clusters of a cut the block looks up
  __shared__ int64_t cut[3];    // the bucket, c0, c1
  __shared__ uint8_t live[kCached];
  grid_wait();  // the tile pass's partials and adds are in place
  const int64_t bucket_rows = static_cast<int64_t>(tiles_per_bucket) *
                              tile_rows;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kFoldThreads * 4;
  if (threadIdx.x == 0) {
    const int64_t b = first / bucket_rows;
    const Cut k(starts, batch, b, buckets, piece_weight, clusters);
    cut[0] = b;
    cut[1] = k.c0;
    cut[2] = k.c1;
  }
  __syncthreads();
  const int64_t span = cut[2] - cut[1] + 1;
  if (span > 1 && span <= kCached && threadIdx.x < span) {
    const Cut k(starts, batch, cut[0], buckets, piece_weight, clusters);
    live[threadIdx.x] = k.live(cut[1] + threadIdx.x);
  }
  __syncthreads();
  const int64_t r = first + threadIdx.x * 4;
  if (r >= num_rows) return;
  const int64_t b = r / bucket_rows;
  // Cluster q's partial of row r: partial[(q + b) * bucket_rows + r - b *
  // bucket_rows].
  const float4* at = reinterpret_cast<const float4*>(partial + r);
  float4 t = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
  if (b == cut[0] && span <= kCached) {
    if (span == 1) return;  // one cluster held the bucket and added it
    for (int q = 0; q < span; ++q) {
      // A cluster with no pushes wrote nothing.
      if (live[q]) t = add4(t, at[(cut[1] + q) * bucket_rows / 4]);
    }
  } else {
    const Cut k(starts, batch, b, buckets, piece_weight, clusters);
    if (k.c0 == k.c1) return;
    for (int64_t q = k.c0; q <= k.c1; ++q) {
      if (k.live(q)) t = add4(t, at[q * bucket_rows / 4]);
    }
  }
  const float x[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r + i < num_rows && __float_as_uint(x[i]) != kNegZero) {
      table[r + i] += x[i];
    }
  }
}

// int32 words of the bucket pass's scratch: the pushes' ids and deltas in
// bucket order, the blocks' counts and the buckets' starts; a multiple of 4
// so that the partials after it are 16-byte aligned.
long long bucket_words(long long batch, int buckets, int bucket_blocks) {
  if (buckets <= 1) return 0;
  const long long n =
      2 * batch + static_cast<long long>(bucket_blocks) * buckets + buckets +
      1;
  return (n + 3) / 4 * 4;
}

int bits_for(int buckets) {
  int bits = 1;
  while ((1 << bits) < buckets) ++bits;
  return bits;
}

int launch_buckets(const int32_t* ids, const float* deltas,
                   long long num_rows, long long batch, int bucket_rows,
                   int buckets, int bucket_blocks, int32_t* work,
                   cudaStream_t s) {
  int32_t* out_ids = work;
  float* out_vals = reinterpret_cast<float*>(work + batch);
  int* counts = work + 2 * batch;
  int* starts = counts + static_cast<long long>(bucket_blocks) * buckets;
  const int bits = bits_for(buckets);
  int rc = launch(dim1_bucket_count, dim3(bucket_blocks), dim3(kThreads), s,
                  ids, num_rows, batch, bucket_rows, buckets, bits, counts);
  if (rc != 0) return rc;
  return launch(dim1_bucket_scatter, dim3(bucket_blocks), dim3(kThreads), s,
                ids, deltas, num_rows, batch, bucket_rows, buckets, bits,
                counts, starts, out_ids, out_vals);
}

}  // namespace

// The most clusters of `cluster` blocks of the tile pass, with smem_bytes of
// shared memory a block, that the current device holds at once
// (cudaOccupancyMaxActiveClusters); or minus the CUDA error.
extern "C" int fps_dim1_clusters_resident(int smem_bytes, int cluster) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  int n = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      dim1_tile_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveClusters(&n, dim1_tile_pass, &config);
  }
  return rc != cudaSuccess ? -static_cast<int>(rc) : n;
}

// The bucket pass alone, for tests and measurement: ids (batch,) int32,
// deltas (batch,) f32; work: at least bucket_words(batch, buckets,
// bucket_blocks) int32, which on return holds the kept ids, then their
// deltas, in bucket order (a bucket is bucket_rows rows; batch order
// within one), then the blocks' counts, then the buckets' starts and the
// count kept. Returns the first launch error (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int fps_dim1_bucket_f32(const void* ids, const void* deltas,
                                   long long num_rows, long long batch,
                                   int bucket_rows, int buckets,
                                   int bucket_blocks, void* work,
                                   long long work_words, void* stream) {
  if (num_rows <= 0 || batch <= 0 || batch >= (1LL << 31) ||
      bucket_rows < 1 || buckets < 2 || buckets > kMaxBuckets ||
      static_cast<long long>(bucket_rows) * buckets < num_rows ||
      bucket_blocks < 1 || bucket_blocks > kMaxBucketBlocks ||
      work_words < bucket_words(batch, buckets, bucket_blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_buckets(static_cast<const int32_t*>(ids),
                        static_cast<const float*>(deltas), num_rows, batch,
                        bucket_rows, buckets, bucket_blocks,
                        static_cast<int32_t*>(work),
                        static_cast<cudaStream_t>(stream));
}

// table (num_rows, 1) f32, updated in place; ids (batch,) int32, batch <
// 2^31; deltas (batch, 1) f32. The plan (kernels.dim1_plan): row tiles of
// tile_rows rows (a multiple of 64; the tile, its flags and the fixed
// staging in 227 KB of shared memory), tiles_per_bucket of them a bucket,
// `buckets` buckets (one: no bucket pass; at most 256), bucket_blocks
// blocks for the bucket pass, `clusters` clusters of `cluster` blocks (at
// most 8) for the tile pass, which weighs each bucket as piece_weight
// pushes more than it holds (0 with one bucket). work: int32 scratch of at
// least bucket_words(...) plus, with more than one cluster, (clusters +
// buckets - 1) * tiles_per_bucket * tile_rows words for the partials. All
// contiguous, on the device of `stream`. Returns the first launch error (0
// on success), or cudaErrorInvalidValue for a plan or shape the kernels do
// not take.
extern "C" int fps_scatter_add_dim1_f32(
    void* table, const void* ids, const void* deltas, long long num_rows,
    long long batch, long long tile_rows, int tiles_per_bucket, int buckets,
    int bucket_blocks, int piece_weight, int cluster, int clusters, void* work,
    long long work_words, void* stream) {
  if (num_rows <= 0 || batch <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long smem = kFixedSmem + 4 * tile_rows + tile_rows / kGroupRows;
  const long long bucket_rows = tiles_per_bucket * tile_rows;
  if (tile_rows < kTileAlign || tile_rows % kTileAlign != 0 ||
      smem > kMaxSmem ||
      tiles_per_bucket < 1 || buckets < 1 || buckets > kMaxBuckets ||
      bucket_rows * buckets < num_rows || bucket_rows >= (1LL << 31) ||
      batch >= (1LL << 31) || num_rows >= (1LL << 31) ||
      (buckets > 1 &&
       (bucket_blocks < 1 || bucket_blocks > kMaxBucketBlocks)) ||
      piece_weight < 0 || (buckets == 1 && piece_weight != 0) ||
      cluster < 1 || cluster > kMaxCluster || clusters < 1 ||
      static_cast<long long>(clusters) * cluster > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long sort = bucket_words(batch, buckets, bucket_blocks);
  const long long partial_words =
      clusters > 1 ? (clusters + buckets - 1LL) * bucket_rows : 0;
  if (work_words < sort + partial_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  int32_t* w = static_cast<int32_t*>(work);
  float* partial = reinterpret_cast<float*>(w + sort);
  const int32_t* push_ids = static_cast<const int32_t*>(ids);
  const float* push_vals = static_cast<const float*>(deltas);
  const int* starts = nullptr;
  int rc;
  if (buckets > 1) {
    rc = launch_buckets(push_ids, push_vals, num_rows, batch,
                        static_cast<int>(bucket_rows), buckets,
                        bucket_blocks, w, s);
    if (rc != 0) return rc;
    push_ids = w;
    push_vals = reinterpret_cast<const float*>(w + batch);
    starts = w + 2 * batch + static_cast<long long>(bucket_blocks) * buckets;
  }
  rc = static_cast<int>(cudaFuncSetAttribute(
      dim1_tile_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  rc = launch_ex(dim1_tile_pass, dim3(clusters * cluster), dim3(kThreads),
                 static_cast<int>(smem), dim3(cluster, 1, 1), s, t, push_ids,
                 push_vals, starts, partial, num_rows, batch,
                 static_cast<int>(tile_rows), tiles_per_bucket, buckets,
                 piece_weight, cluster, clusters);
  if (rc != 0 || clusters == 1) return rc;
  return launch(dim1_fold_pass,
                dim3(static_cast<unsigned>((num_rows + 4 * kFoldThreads - 1) /
                                           (4 * kFoldThreads))),
                dim3(kFoldThreads), s, t,
                static_cast<const float*>(partial), starts, num_rows, batch,
                static_cast<int>(tile_rows), tiles_per_bucket, buckets,
                piece_weight, clusters);
}
