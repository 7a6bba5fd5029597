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
// run to run, the hi+lo split exists only to feed a bf16 matrix unit, and a
// one-hot product over 2,048 head rows would do 2,048 times the useful adds.
//
// What bounds it on the H100: bytes (every id read once, the deltas of the
// head pushes read once, the head rows read and written once). It must not
// serialise on a hot row (the head is where the Zipf-hot rows are), must not
// sort the batch, and must accumulate in exact float32 in a fixed order.
//
// Design. The head stays in shared memory for a whole batch slice:
//
//   1. One block per (head tile, batch slice). A head tile is as many rows
//      of up to 64 columns as fit in 227 KB beside the staging buffers (the
//      whole 2,048-row head at D = 3, 11 and 20, so each id is read once a
//      launch), each row padded to the kernel instance's W columns, with a
//      byte a row saying whether the block has written it (so the tile is
//      never zeroed: a row's first write stores). The block walks its slice
//      in chunks of 1,024 ids, staged into shared memory by cp.async one
//      chunk ahead of the one being read.
//   2. Each chunk's delta rows are prefetched into L2 as its ids are
//      staged. Its pushes into the tile are appended, in batch order, to a
//      pending list of (row, position). Each time 1,024 are pending (and
//      once at the end), they are put in a fixed order by row: stable LSD
//      passes of up to 8 bits (2 at 2,048 rows) rank them in shared memory
//      with radix_sort.cu's ballot-per-bit peers (warp_tree.cuh); within a
//      row, batch order.
//   3. The block sums the sorted pushes by run: a thread takes up to 4
//      consecutive ones, reads their delta rows (only pushes into the tile
//      cost a delta read), sums them by run, and K2's segmented block scan
//      (warp_tree.cuh, a fixed shuffle tree) carries each run across the
//      threads. The last push of a run adds the run's sum into its row in
//      shared memory: one writer a row, batches in batch order, so every
//      sum has a fixed order, with no atomics, and a hot row costs a tree,
//      not a walk.
//   4. Blocks form clusters of up to 8 slices. After its slice, block k of
//      a cluster sums its share of the tile's rows over the cluster's blocks
//      that wrote them, in rank order, through distributed shared memory,
//      and writes the cluster's partial to global scratch (with one
//      cluster, adds it into the table, rows nobody wrote left alone). A
//      second kernel, chained by programmatic dependent launch, sums the
//      clusters' partials in cluster order into table[:H].
//
// A head too large for one tile splits into row tiles (and column tiles past
// 64 columns); each tile reads the ids again. The wrapper plans the tiles,
// the slices (about one block per SM, fewer for a small batch, no more
// clusters than the card holds at once) and the cluster size
// (kernels.packed_plan).
//
// What this design still pays for (PERF.md): two sort passes and a block
// scan a batch of 1,024 pushes, each a chain of block barriers; a gather of
// one delta row a thread, 16 bytes a load, so a warp's load touches up to
// 32 lines; and the cluster reduction moves every written row of every
// block through distributed shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"
#include "warp_tree.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                  // ids, or pushes, a thread takes
constexpr int kWarpSpan = 32 * kItems;     // consecutive ones a warp
constexpr int kChunk = kThreads * kItems;  // ids staged at once
constexpr int kBatch = kChunk;             // head pushes sorted at once
constexpr int kPending = kBatch + kChunk;  // pushes waiting, at most
constexpr int kIdxBits = 10;               // an index in the batch
constexpr int kRadix = 256;                // 8-bit digits
constexpr int kMaxWidth = 64;              // columns a head tile
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMaxSmem = 232448;           // 227 KB, a block's most
constexpr int kFoldThreads = 256;
constexpr int kFoldBatch = 8;     // partials a fold thread loads at once
constexpr int kUnroll = 2;        // float4s a thread reduces at once
// The row widths of the kernel's instances: a head row of `width` columns
// takes the least that holds it, in shared memory.
constexpr int kStrides[] = {4, 8, 12, 16, 20, 32, 64};
static_assert(kBatch == 1 << kIdxBits, "a batch index fills kIdxBits");
static_assert(kWarps == 8, "a digit's warp counts fill 16 bytes");

// Shared memory before the head tile, in bytes: the staged ids (two
// chunks); the head pushes waiting to be sorted, their rows and positions;
// the sorted entries (two buffers); each digit's count in each warp; the
// digits' starts. The block scan of the sums reuses the last two (the sort
// is done by then): its per-warp flags in the starts, its per-warp sums, up
// to kMaxWidth columns, in the counts. After the head tile, a byte a row:
// whether the block has written it.
constexpr int kStagedBytes = 2 * kChunk * 4;
constexpr int kPendingRowBytes = kPending * 2;
constexpr int kPendingPosBytes = kPending * 4;
constexpr int kSortedBytes = 2 * kBatch * 4;
constexpr int kCountBytes = kRadix * kWarps * 2;
constexpr int kStartBytes = kRadix * 4;
constexpr int kFixedSmem = kStagedBytes + kPendingRowBytes +
                           kPendingPosBytes + kSortedBytes + kCountBytes +
                           kStartBytes;
static_assert(kCountBytes >= kWarps * kMaxWidth * 4 &&
                  kStartBytes >= kWarps * 4,
              "the block scan's scratch fits where the sort's was");
static_assert(kFixedSmem % 16 == 0, "the head tile is 16-byte aligned");

__device__ __forceinline__ void stage_ids(int32_t* dst,
                                          const int32_t* __restrict__ src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned at =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(at),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Asks L2 for the bytes [from, to) ahead of their use: the 16-byte aligned
// range inside, in one bulk prefetch (the edges' few bytes are read as
// they come).
__device__ __forceinline__ void prefetch_l2(const void* from,
                                            const void* to) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(from) + 15) & ~uintptr_t{15};
  const uintptr_t b = reinterpret_cast<uintptr_t>(to) & ~uintptr_t{15};
  if (b > a) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a),
                 "r"(static_cast<unsigned>(b - a))
                 : "memory");
  }
}

template <int N>
__device__ __forceinline__ void staged_but() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One stable LSD pass over a batch's n entries v (a thread's kItems, at
// indices warp * kWarpSpan + k * 32 + lane; those past n are skipped), by
// the `bits` bits of the key at `shift`: each entry to out[its rank]. As
// radix_sort.cu ranks a tile: a lane's rank among its warp's equal digits
// from the peer mask (peers_of), the warps' counts of each digit
// (count[digit][warp], 16 bytes a digit), one writer a counter.
__device__ __forceinline__ void rank_pass(const uint32_t (&v)[kItems],
                                          int n, int shift, int bits,
                                          uint16_t (*count)[kWarps],
                                          int* start, uint32_t* out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int radix = 1 << bits;
  if (tid < radix) {
    *reinterpret_cast<uint4*>(count[tid]) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  int dig[kItems];
  unsigned peers[kItems];
  const int first = warp * kWarpSpan;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    dig[k] = static_cast<int>((v[k] >> (kIdxBits + shift)) & (radix - 1));
    peers[k] = 0u;
    if (first + k * 32 >= n) continue;  // the same on every lane
    peers[k] = peers_of(dig[k], bits, first + k * 32 + lane < n);
    if (lane == __ffs(peers[k]) - 1) count[dig[k]][warp] += __popc(peers[k]);
    __syncwarp();
  }
  __syncthreads();
  // Each warp's count of a digit becomes the count in the warps before it.
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
    start[tid] = at;
  }
  __syncthreads();
  if (warp == 0) {
    // Exclusive scan of the digits' totals: lane l holds digits 8l..8l+7.
    int c[8];
    int total = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = lane * 8 + j < radix ? start[lane * 8 + j] : 0;
      total += c[j];
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    int run = incl - total;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (lane * 8 + j < radix) start[lane * 8 + j] = run;
      run += c[j];
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (first + k * 32 >= n) continue;  // the same on every lane
    if (first + k * 32 + lane < n) {
      out[start[dig[k]] + count[dig[k]][warp] + __popc(peers[k] & below)] =
          v[k];
    }
    __syncwarp();  // every lane has read its place before it moves on
    if (lane == __ffs(peers[k]) - 1) count[dig[k]][warp] += __popc(peers[k]);
    __syncwarp();
  }
  __syncthreads();
}

// Sums a batch's sorted head pushes (sorted[0, hits): key = the row in the
// tile, in batch order within a row; the index of the push's position in
// pos) into the head tile, in tiles of kThreads * R entries: a thread takes
// R consecutive entries, loads their delta rows, sums its entries by run,
// and the block's segmented scan (block_seg_scan, a fixed tree) carries
// each run across the threads. The last entry of each run in a tile adds
// the run's sum into its row (and marks it touched): one writer a row a
// tile, and tiles in order.
template <int W, int R>
__device__ __forceinline__ void add_sorted(
    float* head, uint8_t* touched, const uint32_t* sorted, int hits,
    const int* pos, int64_t b0, const float* __restrict__ deltas, int dim,
    int c0, int ncols, bool vec4, int* wf, float (*ws)[W]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int t0 = 0; t0 < hits; t0 += kThreads * R) {
    const int end = hits - t0 < kThreads * R ? hits : t0 + kThreads * R;
    const int first = t0 + tid * R;
    int key[R];
    float x[R][W];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = first + k;
      const bool live = i < end;
      const uint32_t e = live ? sorted[i] : 0u;
      key[k] = live ? static_cast<int>(e >> kIdxBits) : -1 - k;
      const int64_t b = live ? b0 + pos[e & (kBatch - 1)] : 0;
      const float* src = deltas + b * dim + c0;
      if (vec4) {
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (live && j < ncols) v = *reinterpret_cast<const float4*>(src + j);
          x[k][j] = v.x;
          x[k][j + 1] = v.y;
          x[k][j + 2] = v.z;
          x[k][j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          x[k][j] = live && j < ncols ? src[j] : 0.0f;
        }
      }
    }
    // Where runs start: at the tile's first entry, or where the key
    // changes (an entry past `end` is a run of its own).
    const int before = first > t0 && first - 1 < end
                           ? static_cast<int>(sorted[first - 1] >> kIdxBits)
                           : -1 - R;
    const int after = first + R < end
                          ? static_cast<int>(sorted[first + R] >> kIdxBits)
                          : -2 - R;
    bool starts[R];
    int f = 0;
    float s[W];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      starts[k] = key[k] != (k == 0 ? before : key[k > 0 ? k - 1 : 0]);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        s[j] = starts[k] || k == 0 ? x[k][j] : s[j] + x[k][j];
      }
      f |= starts[k];
    }
    // s: the thread's last run so far; after the scan, that run's sum over
    // every thread up to this one.
    block_seg_scan<W>(W, f, s, wf, ws);
    // The sum of the run open at the end of the thread before.
    float run[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float up = __shfl_up_sync(kFull, s[j], 1);
      run[j] = lane > 0 ? up : (warp > 0 ? ws[warp - 1][j] : 0.0f);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        run[j] = starts[k] ? x[k][j] : run[j] + x[k][j];
      }
      if (key[k] >= 0 && key[k] != (k + 1 < R ? key[k + 1 < R ? k + 1 : k]
                                               : after)) {
        // A row's first write stores (the tile is not zeroed).
        float4* out = reinterpret_cast<float4*>(head + key[k] * W);
        const bool seen = touched[key[k]] != 0;
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          float4 o = seen ? out[j / 4] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          o.x += run[j];
          o.y += run[j + 1];
          o.z += run[j + 2];
          o.w += run[j + 3];
          out[j / 4] = o;
        }
        touched[key[k]] = 1;
      }
    }
    __syncthreads();  // ws and the rows are the next tile's
  }
}

// Element e of a tile in float4s (row e / (W / 4), columns 4 * (e % (W /
// 4)) + [0, 4)) to out, a tile's corner in a (rows, dim) table: added where
// `add`, else stored; columns past ncols are the row's padding.
template <int W>
__device__ __forceinline__ void put(float* out, int dim, int ncols, int e,
                                    float4 v, bool add) {
  const int c = e % (W / 4) * 4;
  float* at = out + static_cast<int64_t>(e / (W / 4)) * dim + c;
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c + i < ncols) at[i] = add ? at[i] + x[i] : x[i];
  }
}

// Pass 1. blockIdx.x: the head tile (row tile tile / col_tiles, column tile
// tile % col_tiles); blockIdx.y: the batch slice, in clusters of
// cluster_size along y. With groups == 1 (one cluster) the cluster's sums go
// straight into the table; otherwise into partial[group][H][dim].
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    packed_slice_pass(float* __restrict__ table,
                      const int32_t* __restrict__ ids,
                      const float* __restrict__ deltas,
                      float* __restrict__ partial, int64_t head_rows,
                      int64_t batch, int dim, int64_t slice_len,
                      int tile_rows, int width, int col_tiles,
                      int cluster_size, int groups, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  int32_t* staged = reinterpret_cast<int32_t*>(p);  // [2][kChunk]
  p += kStagedBytes;
  uint16_t* pending_row = reinterpret_cast<uint16_t*>(p);  // [kPending]
  p += kPendingRowBytes;
  int* pending_pos = reinterpret_cast<int*>(p);  // from b0, [kPending]
  p += kPendingPosBytes;
  uint32_t* sorted = reinterpret_cast<uint32_t*>(p);  // [2][kBatch]
  p += kSortedBytes;
  uint16_t(*count)[kWarps] = reinterpret_cast<uint16_t(*)[kWarps]>(p);
  p += kCountBytes;
  int* start = reinterpret_cast<int*>(p);
  // The block scan's scratch, and the per-warp push counts, where the
  // sort's counts and starts are (never in use at the same time).
  int* wf = start;  // [kWarps]
  float(*ws)[W] = reinterpret_cast<float(*)[W]>(count);
  float* head = reinterpret_cast<float*>(smem + kFixedSmem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t r0 = tile / col_tiles * tile_rows;
  const int c0 = static_cast<int>(tile % col_tiles) * width;
  const int rows = static_cast<int>(
      head_rows - r0 < tile_rows ? head_rows - r0 : tile_rows);
  const int ncols = dim - c0 < width ? dim - c0 : width;
  // The tile in float4s, W / 4 a row (a row of W floats, ncols used).
  const int n4 = rows * (W / 4);
  const float4* head4 = reinterpret_cast<const float4*>(head);
  uint8_t* touched = reinterpret_cast<uint8_t*>(head + tile_rows * W);
  for (int e = tid; e < (rows + 15) / 16; e += kThreads) {
    reinterpret_cast<uint4*>(touched)[e] = make_uint4(0, 0, 0, 0);
  }
  // A key is the row in the tile: bits enough for rows - 1, in as few
  // passes of up to 8 bits as may be.
  int key_bits = 1;
  while (((rows - 1) >> key_bits) != 0) ++key_bits;
  const int passes = (key_bits + 7) / 8;
  const int digit_bits = (key_bits + passes - 1) / passes;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * slice_len;
  const int64_t b1 = b0 + slice_len < batch ? b0 + slice_len : batch;

  // Sorts pending[0, n) (n <= kBatch) by row, stably, and sums it into the
  // head tile.
  auto flush = [&](int n) {
    uint32_t v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = warp * kWarpSpan + k * 32 + lane;
      v[k] = static_cast<uint32_t>(i < n ? pending_row[i] : 0) << kIdxBits |
             i;
    }
    uint32_t* out = sorted;
    for (int shift = 0; shift < key_bits; shift += digit_bits) {
      if (shift > 0) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          v[k] = out[warp * kWarpSpan + k * 32 + lane];
        }
        out = out == sorted ? sorted + kBatch : sorted;
      }
      const int bits =
          key_bits - shift < digit_bits ? key_bits - shift : digit_bits;
      rank_pass(v, n, shift, bits, count, start, out);
    }
    add_sorted<W, (W <= 20 ? 4 : W == 32 ? 2 : 1)>(
        head, touched, out, n, pending_pos, b0, deltas, dim, c0, ncols, vec4,
        wf, ws);
  };

  grid_wait();  // the ids and deltas are written by the work before
  if (b0 < b1) {
    const int64_t end = b1 - b0 < kChunk ? b1 : b0 + kChunk;
    stage_ids(staged, ids + b0, static_cast<int>(end - b0));
    if (tid == 0) prefetch_l2(deltas + b0 * dim, deltas + end * dim);
  }
  const unsigned below = (1u << lane) - 1u;
  int pending = 0;  // head pushes waiting, the same on every thread
  int it = 0;
  for (int64_t base = b0; base < b1; base += kChunk, ++it) {
    const int32_t* cur = staged + (it & 1) * kChunk;
    const int len = static_cast<int>(b1 - base < kChunk ? b1 - base : kChunk);
    const int64_t next = base + kChunk;
    __syncthreads();  // every warp is done with the buffer staged into now
    if (next < b1) {
      const int64_t end = b1 - next < kChunk ? b1 : next + kChunk;
      stage_ids(staged + ((it + 1) & 1) * kChunk, ids + next,
                static_cast<int>(end - next));
      // The next chunk's delta rows are read after its sort: ask for them.
      if (tid == 0) prefetch_l2(deltas + next * dim, deltas + end * dim);
      staged_but<1>();
    } else {
      staged_but<0>();
    }
    __syncthreads();  // this chunk's ids are in place for every warp
    // The chunk's head pushes, appended to pending in batch order: a warp
    // takes kWarpSpan consecutive ids, 32 a round.
    int local[kItems];
    unsigned hit[kItems];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = warp * kWarpSpan + k * 32 + lane;
      const int64_t r = i < len ? static_cast<int64_t>(cur[i]) - r0 : -1;
      local[k] = r >= 0 && r < rows ? static_cast<int>(r) : -1;
      hit[k] = __ballot_sync(kFull, local[k] >= 0);
      mine += __popc(hit[k]);
    }
    if (lane == 0) wf[warp] = mine;
    __syncthreads();
    int to = pending;
    int total = pending;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      to += w < warp ? wf[w] : 0;
      total += wf[w];
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (local[k] >= 0) {
        const int j = to + __popc(hit[k] & below);
        pending_row[j] = static_cast<uint16_t>(local[k]);
        const int at = warp * kWarpSpan + k * 32 + lane;
        pending_pos[j] = static_cast<int>(base - b0) + at;
      }
      to += __popc(hit[k]);
    }
    pending = total;
    __syncthreads();
    if (pending >= kBatch) {
      flush(kBatch);
      // The rest (under a chunk) to the front.
      for (int j = kBatch + tid; j < pending; j += kThreads) {
        pending_row[j - kBatch] = pending_row[j];
        pending_pos[j - kBatch] = pending_pos[j];
      }
      pending -= kBatch;
    }
  }
  if (pending > 0) {
    __syncthreads();
    flush(pending);
  }
  __syncthreads();
  allow_next();

  const int64_t group = blockIdx.y / cluster_size;
  float* out = (groups == 1 ? table : partial + group * head_rows * dim) +
               r0 * dim + c0;
  const bool add = groups == 1;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (cluster_size == 1) {
    // A row nobody wrote adds nothing to the table, and is zero in the
    // partial.
    for (int e = tid; e < n4; e += kThreads) {
      const bool seen = touched[e / (W / 4)] != 0;
      if (seen || !add) {
        put<W>(out, dim, ncols, e, seen ? head4[e] : zero, add);
      }
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster has its slice's sums
  const int k = static_cast<int>(cluster.block_rank());
  const int row_lo = static_cast<int>(static_cast<int64_t>(rows) * k /
                                      cluster_size);
  const int row_hi = static_cast<int>(static_cast<int64_t>(rows) * (k + 1) /
                                      cluster_size);
  // Which blocks wrote each of this block's rows: bit q for block q (the
  // sort's buffer is free now).
  uint8_t* writers = reinterpret_cast<uint8_t*>(sorted);
  for (int r = row_lo + tid; r < row_hi; r += kThreads) {
    int m = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < cluster_size && cluster.map_shared_rank(touched, q)[r]) {
        m |= 1 << q;
      }
    }
    writers[r - row_lo] = static_cast<uint8_t>(m);
  }
  __syncthreads();
  const float4* from[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    from[q] = cluster.map_shared_rank(head4, q < cluster_size ? q : 0);
  }
  // kUnroll float4s a thread at a time, every load issued before the adds;
  // the blocks that wrote the row added in rank order.
  const int lo = row_lo * (W / 4);
  const int hi = row_hi * (W / 4);
  for (int e0 = lo + tid; e0 < hi; e0 += kUnroll * kThreads) {
    float4 v[kUnroll][kMaxCluster];
    int m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      m[u] = e < hi ? writers[e / (W / 4) - row_lo] : 0;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if ((m[u] >> q) & 1) v[u][q] = from[q][e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= hi || (m[u] == 0 && add)) continue;
      float4 t = zero;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if ((m[u] >> q) & 1) {
          t.x += v[u][q].x;
          t.y += v[u][q].y;
          t.z += v[u][q].z;
          t.w += v[u][q].w;
        }
      }
      put<W>(out, dim, ncols, e, t, add);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// Pass 2: table[e] += the sum over groups z, in order, of partial[z][e],
// for the n = H * dim elements of the head (contiguous).
__global__ void __launch_bounds__(kFoldThreads)
    packed_fold_pass(float* __restrict__ table,
                     const float* __restrict__ partial, int64_t n,
                     int groups) {
  grid_wait();
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kFoldThreads +
                    threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int z0 = 0; z0 < groups; z0 += kFoldBatch) {
    float v[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) {
      v[u] = z0 + u < groups ? partial[(z0 + u) * n + e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) {
      if (z0 + u < groups) s += v[u];
    }
  }
  table[e] += s;
}

template <int W>
int launch_slices(dim3 grid, int cluster_size, int smem_bytes,
                  cudaStream_t s, float* table, const int32_t* ids,
                  const float* deltas, float* partial, int64_t head_rows,
                  int64_t batch, int dim, int64_t slice_len, int tile_rows,
                  int width, int col_tiles, int groups, bool vec4) {
  const cudaError_t rc = cudaFuncSetAttribute(
      packed_slice_pass<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return launch_ex(packed_slice_pass<W>, grid, dim3(kThreads), smem_bytes,
                   dim3(1, cluster_size, 1), s, table, ids, deltas, partial,
                   head_rows, batch, dim, slice_len, tile_rows, width,
                   col_tiles, cluster_size, groups, vec4);
}

// The columns a head row takes in shared memory: the kernel instance's W,
// the least of kStrides that holds `width`.
int row_stride(int width) {
  for (int w : kStrides) {
    if (width <= w) return w;
  }
  return kMaxWidth + 1;  // refused
}

// rc = F(W) for the instance W == stride (one of kStrides).
#define FPS_DISPATCH(stride, F) \
  switch (stride) {             \
    case 4: rc = F(4); break;   \
    case 8: rc = F(8); break;   \
    case 12: rc = F(12); break; \
    case 16: rc = F(16); break; \
    case 20: rc = F(20); break; \
    case 32: rc = F(32); break; \
    default: rc = F(64); break; \
  }

template <typename Kernel>
int resident(Kernel* kernel, int smem_bytes,
             const cudaLaunchConfig_t& config, int* n) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveClusters(n, kernel, &config);
  }
  return static_cast<int>(rc);
}

}  // namespace

// The most clusters of `cluster` blocks of the slice pass for head tiles of
// `width` columns, with smem_bytes of shared memory a block, that the
// current device holds at once (cudaOccupancyMaxActiveClusters); or minus
// the CUDA error.
extern "C" int fps_packed_clusters_resident(int width, int smem_bytes,
                                            int cluster) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  int n = 0;
  int rc;
#define FPS_RESIDENT(W) resident(packed_slice_pass<W>, smem_bytes, config, &n)
  FPS_DISPATCH(row_stride(width), FPS_RESIDENT);
#undef FPS_RESIDENT
  return rc != 0 ? -rc : n;
}

// table (num_rows >= head_rows, dim) f32, updated in place in its first
// head_rows rows; ids (batch,) int32, batch < 2^31; deltas (batch, dim) f32.
// The plan (kernels.packed_plan): head tiles of tile_rows rows and `width`
// columns (width <= 64; the shared memory, tile_rows rows of
// row_stride(width) floats and a byte beside the fixed staging, at most 227
// KB); `slices` batch slices in clusters of
// `cluster` (slices a multiple of it, cluster <= 8); with more than one
// cluster, partial: scratch of at least (slices / cluster) * head_rows * dim
// f32. All contiguous, on the device of `stream`. Returns the first error
// of the launches (0 on success), or cudaErrorInvalidValue for a plan or
// shape the kernel does not take.
extern "C" int fps_scatter_add_packed_f32(
    void* table, const void* ids, const void* deltas, long long head_rows,
    long long batch, int dim, long long slices, int cluster,
    long long tile_rows, int width, void* partial, long long partial_words,
    void* stream) {
  if (head_rows <= 0 || batch <= 0 || dim <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int stride = row_stride(width);
  const long long smem =
      kFixedSmem + tile_rows * stride * 4LL + (tile_rows + 15) / 16 * 16;
  const long long col_tiles = (dim + width - 1) / (width > 0 ? width : 1);
  const long long row_tiles =
      (head_rows + tile_rows - 1) / (tile_rows > 0 ? tile_rows : 1);
  if (width < 1 || width > kMaxWidth || tile_rows < 1 ||
      smem > kMaxSmem || slices < 1 || slices > 65535 || cluster < 1 ||
      cluster > kMaxCluster || slices % cluster != 0 ||
      row_tiles * col_tiles >= (1LL << 31) || batch >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = static_cast<int>(slices / cluster);
  if (groups > 1 && partial_words < groups * head_rows * dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slice_len = (batch + slices - 1) / slices;
  // 16 bytes a delta load: every column tile starts and ends on a multiple
  // of 4 and the rows are 16-byte aligned.
  const bool vec4 = width % 4 == 0 && dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(deltas) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(row_tiles * col_tiles),
                  static_cast<unsigned>(slices));
  float* t = static_cast<float*>(table);
  float* p = static_cast<float*>(partial);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const float* d = static_cast<const float*>(deltas);
  const int rows = static_cast<int>(tile_rows);
  const int bytes = static_cast<int>(smem);
  int rc;
#define FPS_SLICES(W)                                                     \
  launch_slices<W>(grid, cluster, bytes, s, t, i, d, p, head_rows, batch, \
                   dim, slice_len, rows, width,                           \
                   static_cast<int>(col_tiles), groups, vec4)
  FPS_DISPATCH(stride, FPS_SLICES);
#undef FPS_SLICES
  if (rc != 0 || groups == 1) return rc;
  const long long n = head_rows * dim;
  return launch(packed_fold_pass,
                dim3(static_cast<unsigned>((n + kFoldThreads - 1) /
                                           kFoldThreads)),
                dim3(kFoldThreads), s, t, static_cast<const float*>(p), n,
                groups);
}
