// The sort in front of K2: a stable LSD radix sort of a push's ids, with
// their batch positions, on keys limited to the bits the table needs.
//
// K2 (scatter_add.cu) sums each run of equal ids, so it needs the ids in
// order and, for each sorted position, the batch position its delta row
// sits at. The key of position i is ids[i] for an id in [0, R) and R for a
// dropped id, so dropped ids sort last and K2 stops at the first key R. A
// key needs only bits = max(1, ceil(log2(R + 1))) bits, sorted 8 at a time:
// 2 passes for R up to 65,535, 3 up to 2^24 - 1, 4 for R up to 2^31 - 1.
// A 32-bit sort of the same ids would take 4 passes at every R.
//
// Each pass launches three kernels:
//
//   a. one block per tile of positions counts the tile's keys by digit;
//      the counts go out digit-major, counts[digit * tiles + tile];
//   b. one block takes the exclusive scan of those counts in that order, so
//      counts[digit * tiles + tile] becomes the first output position of the
//      tile's keys of that digit;
//   c. one block per tile ranks its keys stably within the tile, stages them
//      (with their positions) in shared memory in digit order, and writes
//      each digit's stretch to its start from b, so that neighbouring
//      threads write neighbouring addresses.
//
// The rank inside a warp is the number of lower lanes of the same digit:
// __popc of the lanes below in the warp's peer mask, the mask that
// __match_any_sync gives, here built from one __ballot_sync a digit bit,
// as CUB builds it. The warps of a tile own consecutive stretches of it,
// 8 rounds of 32 positions each, and each warp's start for a digit is the
// tile's start plus the counts of the earlier warps, kept in shared
// memory. So equal keys keep their order and the sort is stable. The lowest lane of each group of equal digits writes
// the group's count, so no two lanes write one counter: no atomics, and all
// counts are exact integers. The result is the same on every launch, and
// equal to torch.sort(keys, stable=True) in keys and in positions.
//
// A tile is 256 positions a warp, 1 to 16 warps: as few as keep the tiles
// at 64 or fewer, so that a small push spreads over the card and a large
// one keeps the scan short (256 counts a tile). Every kernel is launched
// with programmatic dependent launch (launch, in pdl.cuh), so the card
// sets up a kernel while the one before it still runs.
//
// Bound on the H100: bytes. A pass reads the keys and positions twice (a
// and c) and writes them once; the scan's counts stay in L2. At the paths'
// batches (32,768 to 2^20 ids) a pass is a few microseconds of memory
// traffic, and the launches (3 a pass) are a large share of the sort at
// the MF batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"
#include "warp_tree.cuh"

namespace {

constexpr int kItems = 8;                 // positions a thread, in rounds
constexpr int kWarpSpan = 32 * kItems;    // consecutive positions a warp
constexpr int kMaxWarps = 16;
constexpr int kMaxTile = kMaxWarps * kWarpSpan;  // 4,096 positions
constexpr int kTargetTiles = 64;          // most tiles below kMaxWarps
constexpr int kRadix = 256;               // 8-bit digits
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;             // consecutive counts a thread
constexpr int kScanRound = kScanThreads * kScanItems;

// Warps a tile for a batch: as few as keep the tiles at kTargetTiles.
int tile_warps(long long batch) {
  const long long w = (batch + kWarpSpan * kTargetTiles - 1) /
                      (kWarpSpan * kTargetTiles);
  return static_cast<int>(w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w));
}

// The key at position i: the mapped id on the first pass (ids given), the
// previous pass's output after it.
__device__ __forceinline__ uint32_t key_at(const int32_t* __restrict__ ids,
                                           const uint32_t* __restrict__ keys,
                                           int64_t i, uint32_t num_rows) {
  if (ids != nullptr) {
    const int32_t id = ids[i];
    return (id >= 0 && static_cast<uint32_t>(id) < num_rows)
               ? static_cast<uint32_t>(id)
               : num_rows;
  }
  return keys[i];
}

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return static_cast<int>((key >> shift) & (kRadix - 1));
}

// A tile's keys: loaded, their digits and peer masks, and the count of each
// digit in each warp added into wcount[warp] (zeroed before).
struct TileKeys {
  uint32_t key[kItems];
  int dig[kItems];
  unsigned peers[kItems];
};

__device__ __forceinline__ void rank_tile(TileKeys& t, int64_t base,
                                          int64_t batch, int shift, int bits,
                                          uint16_t (*wcount)[kRadix],
                                          const int32_t* __restrict__ ids,
                                          const uint32_t* __restrict__ keys,
                                          uint32_t num_rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // All loads first: the warp syncs below would otherwise wait out one
  // load's latency a round.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * 32;
    t.key[k] = i < batch ? key_at(ids, keys, i, num_rows) : 0u;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool live = base + k * 32 < batch;
    t.dig[k] = digit_of(t.key[k], shift);
    t.peers[k] = peers_of(t.dig[k], bits, live);
    if (live && lane == __ffs(t.peers[k]) - 1) {
      wcount[warp][t.dig[k]] += __popc(t.peers[k]);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_counts(uint16_t (*wcount)[kRadix]) {
  const int n = (blockDim.x >> 5) * kRadix;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    wcount[j / kRadix][j % kRadix] = 0;
  }
}

// Pass a: the tile's count of each digit.
__global__ void __launch_bounds__(kMaxWarps * 32)
    radix_count(const int32_t* __restrict__ ids,
                const uint32_t* __restrict__ keys_in, uint32_t num_rows,
                int64_t batch, int shift, int bits, int64_t num_tiles,
                int* __restrict__ counts) {
  __shared__ uint16_t wcount[kMaxWarps][kRadix];
  grid_wait();
  allow_next();
  const int warps = blockDim.x >> 5;
  zero_counts(wcount);
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * warps * kWarpSpan +
                       (threadIdx.x >> 5) * kWarpSpan + (threadIdx.x & 31);
  TileKeys t;
  rank_tile(t, base, batch, shift, bits, wcount, ids, keys_in, num_rows);
  __syncthreads();
  for (int d = threadIdx.x; d < (1 << bits); d += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += wcount[w][d];
    counts[static_cast<int64_t>(d) * num_tiles + blockIdx.x] = sum;
  }
}

// Pass b: exclusive scan of counts[0, n) in place, in index order. One
// block; each round stages kScanRound counts in shared memory (read and
// written back coalesced) and each thread scans kScanItems consecutive
// ones. The buffer index is skewed by one word in 32 so that neither the
// coalesced nor the consecutive accesses collide in a bank.
__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

__global__ void __launch_bounds__(kScanThreads)
    radix_scan(int* __restrict__ counts, int64_t n) {
  __shared__ int buf[kScanRound + kScanRound / 32];
  __shared__ int warp_sum[kScanThreads / 32];
  grid_wait();
  allow_next();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The next round's counts, requested while this round is scanned.
  int next[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int at = j * kScanThreads + tid;
    next[j] = at < n ? counts[at] : 0;
  }
  int carry = 0;
  for (int64_t start = 0; start < n; start += kScanRound) {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      buf[skew(j * kScanThreads + tid)] = next[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int64_t at = start + kScanRound + j * kScanThreads + tid;
      next[j] = at < n ? counts[at] : 0;
    }
    int v[kScanItems];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = buf[skew(tid * kScanItems + j)];
      total += v[j];
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += up;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    int run = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - total;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      buf[skew(tid * kScanItems + j)] = run;
      run += v[j];
    }
    carry += warp_sum[31];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int at = j * kScanThreads + tid;
      if (start + at < n) counts[start + at] = buf[skew(at)];
    }
    __syncthreads();  // buf and warp_sum are rewritten by the next round
  }
}

// Pass c: every key and position to its place, stably.
__global__ void __launch_bounds__(kMaxWarps * 32)
    radix_scatter(const int32_t* __restrict__ ids,
                  const uint32_t* __restrict__ keys_in,
                  const int32_t* __restrict__ pos_in, uint32_t num_rows,
                  int64_t batch, int shift, int bits, int64_t num_tiles,
                  const int* __restrict__ starts,
                  uint32_t* __restrict__ keys_out,
                  int32_t* __restrict__ pos_out) {
  // wcount[w][d]: warp w's count of digit d, then its next place in the
  // tile; local[d]: the tile's first place of digit d; first_out[d]:
  // digit d's first output position for this tile.
  __shared__ uint16_t wcount[kMaxWarps][kRadix];
  __shared__ int local[kRadix];
  __shared__ int first_out[kRadix];
  __shared__ uint32_t skeys[kMaxTile];
  __shared__ int32_t spos[kMaxTile];
  grid_wait();
  allow_next();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int digits = 1 << bits;
  zero_counts(wcount);
  __syncthreads();
  const int64_t tile_base =
      static_cast<int64_t>(blockIdx.x) * warps * kWarpSpan;
  const int64_t base = tile_base + warp * kWarpSpan + lane;
  // The digits' output starts, all requested at once (a block of one warp
  // takes 8 of them a thread).
  int start_of[kRadix / 32];
#pragma unroll
  for (int r = 0; r < kRadix / 32; ++r) {
    const int d = threadIdx.x + r * blockDim.x;
    start_of[r] =
        d < digits ? starts[static_cast<int64_t>(d) * num_tiles + blockIdx.x]
                   : 0;
  }
  TileKeys t;
  rank_tile(t, base, batch, shift, bits, wcount, ids, keys_in, num_rows);
  int32_t pos[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * 32;
    pos[k] = i < batch ? (ids != nullptr ? static_cast<int32_t>(i)
                                         : pos_in[i])
                       : 0;
  }
  __syncthreads();
  // Each digit's count over the tile (into local), and each warp's count
  // becomes the count of the digit in the warps before it.
#pragma unroll
  for (int r = 0; r < kRadix / 32; ++r) {
    const int d = threadIdx.x + r * blockDim.x;
    if (d < kRadix) {
      int at = 0;
      for (int w = 0; w < warps; ++w) {
        const int c = wcount[w][d];
        wcount[w][d] = static_cast<uint16_t>(at);
        at += c;
      }
      local[d] = at;
      first_out[d] = start_of[r];
    }
  }
  __syncthreads();
  if (warp == 0) {
    // Exclusive scan of the digits' counts: lane l holds digits 8l..8l+7.
    int c[8];
    int total = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = local[lane * 8 + j];
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
      local[lane * 8 + j] = run;
      run += c[j];
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool live = base + k * 32 < batch;
    const int d = t.dig[k];
    if (live) {
      const int at = local[d] + wcount[warp][d] + __popc(t.peers[k] & below);
      skeys[at] = t.key[k];
      spos[at] = pos[k];
    }
    __syncwarp();  // every lane has read its place before it moves on
    if (live && lane == __ffs(t.peers[k]) - 1) {
      wcount[warp][d] += __popc(t.peers[k]);
    }
    __syncwarp();
  }
  __syncthreads();
  // The tile in digit order: a digit's stretch goes to consecutive places.
  const int64_t rest = batch - tile_base;
  const int len = rest < warps * kWarpSpan ? static_cast<int>(rest)
                                           : warps * kWarpSpan;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const uint32_t key = skeys[j];
    const int d = digit_of(key, shift);
    const int64_t at = first_out[d] + (j - local[d]);
    keys_out[at] = key;
    pos_out[at] = spos[j];
  }
}

int key_bits(long long num_rows) {
  int bits = 0;
  while (bits < 63 && (num_rows >> bits) != 0) ++bits;
  return bits > 0 ? bits : 1;
}

}  // namespace

// Sorts the keys of ids (batch,) int32 (id for an id in [0, num_rows),
// num_rows for any other) stably, with their positions. work is int32
// scratch of at least 4 * batch + 256 * max(64, ceil(batch / 4096))
// words: on return work[0, batch) holds the sorted keys and work[2 * batch,
// 3 * batch) the batch position of each (int32); the rest is overwritten.
// All on the device of `stream`. Returns the first launch's error (0 on
// success), or cudaErrorInvalidValue for num_rows outside
// [0, 2^31), a batch of 2^31 or more, or too little scratch.
extern "C" int fps_radix_sort_i32(const void* ids, long long num_rows,
                                  long long batch, void* work,
                                  long long work_words, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const int warps = tile_warps(batch);
  const long long tile = static_cast<long long>(warps) * kWarpSpan;
  const long long tiles = (batch + tile - 1) / tile;
  if (num_rows < 0 || num_rows >= (1LL << 31) || batch >= (1LL << 31) ||
      work_words < 4 * batch + kRadix * tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* keys[2] = {static_cast<uint32_t*>(work),
                       static_cast<uint32_t*>(work) + batch};
  int32_t* pos[2] = {static_cast<int32_t*>(work) + 2 * batch,
                     static_cast<int32_t*>(work) + 3 * batch};
  int* counts = static_cast<int*>(work) + 4 * batch;
  const uint32_t rows = static_cast<uint32_t>(num_rows);
  const int key_width = key_bits(num_rows);
  const int passes = (key_width + 7) / 8;
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    const int bits = key_width - shift < 8 ? key_width - shift : 8;
    // The last pass writes buffer 0.
    const int out = (passes - 1 - p) & 1;
    const int32_t* src = p == 0 ? static_cast<const int32_t*>(ids) : nullptr;
    int rc = launch(radix_count, dim3(static_cast<unsigned>(tiles)),
                    dim3(warps * 32), s, src, keys[out ^ 1], rows, batch,
                    shift, bits, tiles, counts);
    if (rc != 0) return rc;
    rc = launch(radix_scan, dim3(1), dim3(kScanThreads), s, counts,
                (1LL << bits) * tiles);
    if (rc != 0) return rc;
    rc = launch(radix_scatter, dim3(static_cast<unsigned>(tiles)),
                dim3(warps * 32), s, src, keys[out ^ 1], pos[out ^ 1], rows,
                batch, shift, bits, tiles, counts, keys[out], pos[out]);
    if (rc != 0) return rc;
  }
  return 0;
}
