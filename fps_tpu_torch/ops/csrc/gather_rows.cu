// K1: row gather, out[b, :] = table[ids[b], :], zero rows for ids outside [0, R).
//
// Replaces gather_rows_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _gather_kernel). The TPU kernel turns the gather into a one-hot matmul over
// every row tile of the table and has to zero the garbage of ragged boundary
// tiles. Here a thread copies rows' bits and a bounds check on the id takes
// the place of both the one-hot test and the boundary masking, so the result
// is bit-identical to the plain PyTorch version (mask + index_select).
//
// Bound on the H100: bytes. B*D*4 bytes of rows read, B*D*4 written and B*4
// bytes of ids; no arithmetic to speak of. At the 20-class PA pull the
// output is 84 MB and the table 3.8 MB, which L2 keeps; at the MF and
// logistic-regression pulls (1.3-3.4 MB of output) the latency of the id
// load and the dependent table load is most of the time.
//
// The design (gather.cuh has the cut and the store): a thread takes
// 16-byte output chunks. A chunk lies in at most two rows at D >= 2, so it
// needs at most two ids, ids[b] and ids[b + 1]; with D a multiple of 4 it
// lies in one row and needs one. The row and column of a chunk come from a
// division by a compile-time D for the paths' widths, and by a multiply-high
// with a precomputed reciprocal for any other D, in 32-bit index math while
// B*D < 2^31 (a 64-bit instance past that). The table is read through the
// read-only path in 16-byte loads where D is a multiple of 4, 8-byte loads
// where D is even (every path: D = 2, 10, 20), and 4-byte loads otherwise,
// each where the table's base is so aligned. A table of one column takes
// K5's scalar kernel (gather_rows_dim1.cu) from the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"
#include "pdl.cuh"

namespace {

// n / d for n < 2^31 and 1 <= d < 2^31 by a multiply-high and a shift
// (round-up reciprocal: mul = ceil(2^(31 + l) / d) with l = ceil(log2 d);
// the error mul * d - 2^(31 + l) < d keeps the quotient exact below 2^31).
struct FastDiv {
  uint32_t mul;    // 0: d == 1
  uint32_t shift;
};

FastDiv make_fast_div(uint32_t d) {
  FastDiv f{0u, 0u};
  if (d > 1) {
    uint32_t l = 0;
    while ((1ull << l) < d) ++l;
    f.mul = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
    f.shift = l - 1;
  }
  return f;
}

// The row of flat output element e.
template <int kD, typename Idx>
__device__ __forceinline__ Idx row_of(Idx e, uint32_t dim, FastDiv div) {
  if constexpr (kD > 0) {
    return e / static_cast<Idx>(kD);
  } else if constexpr (sizeof(Idx) == 4) {
    return div.mul ? __umulhi(e, div.mul) >> div.shift : e;
  } else {
    return e / dim;
  }
}

// The chunk's 4 floats from row id0 at columns col0.., continuing into row
// id1 at column 0 past the row's end; kVec floats a load (kVec divides D,
// so a load never straddles two rows). An id outside [0, R) reads +0.0.
template <int kVec>
__device__ __forceinline__ void load_chunk(const float* __restrict__ table,
                                           uint32_t num_rows, uint32_t dim,
                                           uint32_t col0, int32_t id0,
                                           int32_t id1, float (&v)[4]) {
#pragma unroll
  for (int p = 0; p < 4; p += kVec) {
    uint32_t col = col0 + p;
    int32_t id = id0;
    if (col >= dim) {
      col -= dim;
      id = id1;
    }
    const bool in = static_cast<uint32_t>(id) < num_rows;
    const float* src = table + static_cast<size_t>(in ? id : 0) * dim + col;
    if constexpr (kVec == 4) {
      float4 t = in ? __ldg(reinterpret_cast<const float4*>(src))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if constexpr (kVec == 2) {
      float2 t = in ? __ldg(reinterpret_cast<const float2*>(src))
                    : make_float2(0.f, 0.f);
      v[p] = t.x, v[p + 1] = t.y;
    } else {
      v[p] = in ? __ldg(src) : 0.0f;
    }
  }
}

// kD: D compiled in (0: read from dim at run time); kVec: floats a table
// load; Idx: the flat output index (uint32_t while B*D < 2^31).
template <int kD, int kVec, typename Idx>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ table,
                       const int32_t* __restrict__ ids,
                       float* __restrict__ out, uint32_t num_rows,
                       uint32_t batch, uint32_t dim_arg, FastDiv div) {
  const uint32_t dim = kD > 0 ? kD : dim_arg;
  const Idx n = static_cast<Idx>(batch) * dim;
  const Idx num_chunks = (n + 3) / 4;
  grid_wait();
  allow_next();
  for (Idx c = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
       c < num_chunks; c += static_cast<Idx>(gridDim.x) * kThreads) {
    const Idx e0 = 4 * c;
    const Idx b = row_of<kD>(e0, dim, div);
    const uint32_t col0 = static_cast<uint32_t>(e0 - b * dim);
    const int32_t id0 = __ldg(ids + b);
    int32_t id1 = -1;
    if (kVec < 4 && col0 + 4 > dim && b + 1 < batch) id1 = __ldg(ids + b + 1);
    float v[4];
    load_chunk<kVec>(table, num_rows, dim, col0, id0, id1, v);
    store_chunk(out, e0, n, v);
  }
}

using RowsKernel = void (*)(const float*, const int32_t*, float*, uint32_t,
                            uint32_t, uint32_t, FastDiv);

// The instance of (width, vec, index_bits); nullptr where there is none.
// width: D compiled in, or 0.
RowsKernel pick(int width, int vec, int index_bits) {
  if (index_bits == 64)
    return width == 0 && vec == 1 ? gather_rows_kernel<0, 1, uint64_t>
                                  : nullptr;
  if (index_bits != 32) return nullptr;
  switch (width * 8 + vec) {
    case 2 * 8 + 2: return gather_rows_kernel<2, 2, uint32_t>;
    case 2 * 8 + 1: return gather_rows_kernel<2, 1, uint32_t>;
    case 3 * 8 + 1: return gather_rows_kernel<3, 1, uint32_t>;
    case 10 * 8 + 2: return gather_rows_kernel<10, 2, uint32_t>;
    case 10 * 8 + 1: return gather_rows_kernel<10, 1, uint32_t>;
    case 11 * 8 + 1: return gather_rows_kernel<11, 1, uint32_t>;
    case 20 * 8 + 4: return gather_rows_kernel<20, 4, uint32_t>;
    case 20 * 8 + 2: return gather_rows_kernel<20, 2, uint32_t>;
    case 20 * 8 + 1: return gather_rows_kernel<20, 1, uint32_t>;
    case 0 * 8 + 4: return gather_rows_kernel<0, 4, uint32_t>;
    case 0 * 8 + 2: return gather_rows_kernel<0, 2, uint32_t>;
    case 0 * 8 + 1: return gather_rows_kernel<0, 1, uint32_t>;
    default: return nullptr;
  }
}

}  // namespace

// table (num_rows, dim) f32, ids (batch,) int32, out (batch, dim) f32; all
// contiguous, on the device of `stream`, dim >= 2. The plan (kernels.py
// gather_plan): `width` D compiled in or 0, `vec` floats a table load,
// `index_bits` 32 or 64, `blocks`. Refuses
// (cudaErrorInvalidValue) a plan it cannot run: no such instance, a width
// that is not dim, vec not dividing dim or the table's alignment, 32-bit
// index math at batch*dim >= 2^31, an output not 16-byte aligned. Returns
// the launch's error (0 on success).
extern "C" int fps_gather_rows_f32(const void* table, const void* ids,
                                   void* out, long long num_rows,
                                   long long batch, int dim, int width,
                                   int vec, int index_bits, int blocks,
                                   void* stream) {
  RowsKernel kernel = pick(width, vec, index_bits);
  const long long n = batch * dim;
  if (kernel == nullptr || dim < 2 || (width != 0 && width != dim) ||
      dim % vec != 0 || !aligned(table, 4u * vec) || !aligned(out, 16) ||
      num_rows < 0 || num_rows >= (1ll << 31) || batch <= 0 ||
      batch >= (1ll << 31) || (index_bits == 32 && n >= (1ll << 31)) ||
      blocks < 1)
    return cudaInvalid;
  int rc = launch(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                  static_cast<cudaStream_t>(stream), table, ids, out,
                  static_cast<uint32_t>(num_rows),
                  static_cast<uint32_t>(batch), static_cast<uint32_t>(dim),
                  make_fast_div(static_cast<uint32_t>(dim)));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

// The most blocks of the instance (width, vec, index_bits) an SM holds at
// once; 0 where there is no such instance.
extern "C" int fps_gather_rows_blocks_per_sm(int width, int vec,
                                             int index_bits) {
  RowsKernel kernel = pick(width, vec, index_bits);
  return kernel == nullptr
             ? 0
             : blocks_per_sm(reinterpret_cast<const void*>(kernel));
}
