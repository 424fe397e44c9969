// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace madsim {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

}  // namespace madsim
