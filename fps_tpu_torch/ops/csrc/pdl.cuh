// Programmatic dependent launch (Hopper), shared by radix_sort.cu,
// scatter_add.cu, scatter_add_packed.cu and scatter_add_dim1.cu: each kernel is launched so that
// the card may start it while the kernel before it in the stream still
// runs, and it waits (grid_wait) until that kernel has finished and its
// writes are visible before it touches memory. A kernel lets the next one
// start (allow_next) once the next one's blocks cannot crowd it out. What
// this saves is the gap between two dependent launches.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launches kernel<<<grid, block, smem_bytes, s>>>(args...) in clusters of
// `cluster` blocks (none where it is 1 x 1 x 1), with programmatic stream
// serialization allowed; returns the launch's error (0 on success).
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block,
              int smem_bytes, dim3 cluster, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem_bytes;
  config.stream = s;
  cudaLaunchAttribute attrs[2] = {};
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attrs;
  config.numAttrs = 1;
  if (cluster.x * cluster.y * cluster.z > 1) {
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = cluster.x;
    attrs[1].val.clusterDim.y = cluster.y;
    attrs[1].val.clusterDim.z = cluster.z;
    config.numAttrs = 2;
  }
  return static_cast<int>(
      cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...));
}

// Launches kernel<<<grid, block, 0, s>>>(args...) as launch_ex does.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t s,
           Args... args) {
  return launch_ex(kernel, grid, block, 0, dim3(1, 1, 1), s, args...);
}

}  // namespace
