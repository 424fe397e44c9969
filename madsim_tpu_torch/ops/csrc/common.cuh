// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <climits>
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

// The pop of one lane's event queue, computed by a whole warp: the
// lexicographic (time, seq, index) argmin over the valid slots of the
// row. Thread t reads slots t, t + 32, ... (any Q), and three butterfly
// min-reductions give min time over the valid slots, min seq over the
// time ties, then the first slot index holding both. Every thread gets
// the index; `any` says whether the row holds a valid slot. An
// all-invalid row gives index 0 and any = false, as the reference's
// `_lex_argmin` does. INT_MAX is a legal time: a valid slot at INT_MAX
// still matches the minimum. All 32 threads of the warp must call it.
__device__ __forceinline__ int warp_lex_argmin(const int32_t* __restrict__ time,
                                               const int32_t* __restrict__ seq,
                                               const uint8_t* __restrict__ valid, int q,
                                               bool& any) {
  const int t = threadIdx.x & 31;
  int tmin = INT_MAX;
  bool mine = false;
  for (int j = t; j < q; j += 32) {
    if (valid[j]) {
      mine = true;
      tmin = min(tmin, time[j]);
    }
  }
  tmin = warp_min(tmin);
  any = __any_sync(FULL_MASK, mine);
  int smin = INT_MAX;
  for (int j = t; j < q; j += 32) {
    if (valid[j] && time[j] == tmin) smin = min(smin, seq[j]);
  }
  smin = warp_min(smin);
  int best = q;
  for (int j = t; j < q; j += 32) {
    if (valid[j] && time[j] == tmin && seq[j] == smin) best = min(best, j);
  }
  best = warp_min(best);
  return best == q ? 0 : best;
}

}  // namespace madsim
