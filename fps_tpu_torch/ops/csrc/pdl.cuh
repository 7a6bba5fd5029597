// Programmatic dependent launch (Hopper), shared by radix_sort.cu and
// scatter_add.cu: each kernel is launched so that the card may start it
// while the kernel before it in the stream still runs, and it waits
// (grid_wait) until that kernel has finished and its writes are visible
// before it touches memory. A kernel lets the next one start (allow_next)
// once the next one's blocks cannot crowd it out. What this saves is the
// gap between two dependent launches.

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

// Launches kernel<<<grid, block, 0, s>>>(args...) with programmatic stream
// serialization allowed; returns the launch's error (0 on success).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t s,
           Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.stream = s;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...));
}

}  // namespace
