// The coverage flush: fold each lane's buffered slot indices into its
// packed hit map, in place.
//
// Replaces the TPU kernel `cov_flush_pallas` of
// madsim_tpu/ops/pallas_pop.py (body `_make_cov_flush_kernel`), which
// rewrites all W map words of every lane. One thread per (lane, entry
// i): if i < n[lane], it sets bit (slot & 31) of word slot >> 5 with
// atomicOr. OR commutes and is idempotent, so the result is the same
// for any order of the atomics and bit-equal to the sequential fold
// (madsim_tpu/ops/coverage.py `cov_flush`). Entries whose word lies
// outside the map are dropped, as the TPU kernel drops them.
//
// What bounds it on an H100: bytes. The buffer [L, C] and counts [L]
// are read once; each live entry costs one 32-byte sector
// read-modify-write of the map, in L2. The TPU kernel's whole-map
// rewrite (2 KiB a lane) is gone: the map is touched only where a bit
// is set, at most C words a lane.

#include "common.cuh"

namespace {

__global__ void cov_flush_kernel(int32_t* __restrict__ cov_map, const int32_t* __restrict__ buf,
                                 const int32_t* __restrict__ n, int lanes, int c, int w) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= static_cast<int64_t>(lanes) * c) return;
  const int64_t lane = g / c;
  const int i = static_cast<int>(g - lane * c);
  if (i >= n[lane]) return;
  const int slot = buf[g];
  const int word = slot >> 5;
  if (word < 0 || word >= w) return;
  atomicOr(reinterpret_cast<unsigned int*>(cov_map) + lane * w + word, 1u << (slot & 31));
}

}  // namespace

extern "C" int cov_flush_launch(void* cov_map, const void* buf, const void* n, int lanes,
                                int c, int w, void* stream) {
  const int64_t total = static_cast<int64_t>(lanes) * c;
  if (total == 0) return 0;
  const int block = 256;
  const int64_t grid = (total + block - 1) / block;
  cov_flush_kernel<<<static_cast<unsigned>(grid), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cov_map), static_cast<const int32_t*>(buf),
      static_cast<const int32_t*>(n), lanes, c, w);
  return static_cast<int>(cudaGetLastError());
}
