// Shared helpers for the mmtrack_torch Hopper kernels.
//
// Every kernel in this directory is compiled into one shared library with a
// plain C interface (kernels/build.py) and launched through ctypes on
// PyTorch's current stream. Each exported function returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmt {

typedef __nv_bfloat16 bf16;

// Round an f32 value to bf16 (round to nearest even) and back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace mmt
