// K5: scalar-table gather, out[b] = table[ids[b]] for an (R, 1) table, zero
// for ids outside [0, R).
//
// Replaces gather_rows_dim1_pallas (fps_tpu/ops/pallas_kernels.py, kernel
// _gather_dim1_kernel). The TPU kernel packs 128 rows per lane row, splits
// the table into bf16 hi+lo halves and reads each id through two one-hot
// matmuls over every packed row tile: about 16 mantissa bits, and a cost that
// grows with R. Here the read is a plain load: the float's bits go to the
// output unchanged, so the result is bit-identical to the plain PyTorch
// version (mask + index_select), and the cost does not depend on R.
//
// Bound on the H100: bytes. 4 bytes of id read and 4 bytes written per id,
// plus the distinct touched rows read once. The table is at most 4 MB on the
// paths that use it (logistic regression's 1M features), so after the first
// touch every row read is an L2 hit; what is left is the stream of ids in and
// values out. Each thread therefore takes four ids with one 16-byte load and
// writes four values with one 16-byte store, where both arrays are 16-byte
// aligned; the batch's last B % 4 ids (or all of them, for a misaligned view)
// take one thread each. A bounds check on the id writes zero for a dropped
// id, in place of the TPU kernel's -1 sentinel and row-tile masking.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float read_or_zero(const float* __restrict__ table,
                                              int32_t id, int64_t num_rows) {
  return (id >= 0 && id < num_rows) ? __ldg(table + id) : 0.0f;
}

__global__ void gather_rows_dim1_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ ids,
                                        float* __restrict__ out,
                                        int64_t num_rows, int64_t batch,
                                        int64_t num_vec) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < num_vec) {
    int4 v = __ldg(reinterpret_cast<const int4*>(ids) + t);
    float4 r;
    r.x = read_or_zero(table, v.x, num_rows);
    r.y = read_or_zero(table, v.y, num_rows);
    r.z = read_or_zero(table, v.z, num_rows);
    r.w = read_or_zero(table, v.w, num_rows);
    reinterpret_cast<float4*>(out)[t] = r;
    return;
  }
  int64_t b = 4 * num_vec + (t - num_vec);
  if (b < batch) out[b] = read_or_zero(table, ids[b], num_rows);
}

}  // namespace

// table (num_rows,) f32 (an (R, 1) table), ids (batch,) int32, out (batch,)
// f32; all contiguous, on the device of `stream`. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fps_gather_rows_dim1_f32(const void* table, const void* ids,
                                        void* out, long long num_rows,
                                        long long batch, void* stream) {
  if (batch > 0) {
    bool aligned = (reinterpret_cast<uintptr_t>(ids) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    long long num_vec = aligned ? batch / 4 : 0;
    long long work = num_vec + (batch - 4 * num_vec);
    const int threads = 256;
    long long blocks = (work + threads - 1) / threads;
    gather_rows_dim1_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(ids),
        static_cast<float*>(out), num_rows, batch, num_vec);
  }
  return static_cast<int>(cudaGetLastError());
}
