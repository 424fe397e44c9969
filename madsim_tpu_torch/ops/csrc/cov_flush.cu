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
// outside the map (a negative slot, or a word >= W) are dropped, as the
// TPU kernel drops them.
//
// What bounds it on an H100: bytes. The buffer [L, C] and counts [L]
// are read once; each live entry costs one 32-byte sector
// read-modify-write of the map, in L2. The TPU kernel's whole-map
// rewrite (2 KiB a lane) is gone: the map is touched only where a bit
// is set, at most C words a lane. In practice, latency: at the flagship
// (8192 lanes, C = 16) a launch is the fixed cost of one wave of 512
// blocks and one trip to L2 for the entry and the count, loaded
// together; the atomics are reductions done in L2, which the thread
// does not wait for.
//
// Why atomics: a design without them (a group of threads a lane merging
// its entries by shuffles so that one thread writes each distinct word
// with a plain load, OR and store) was timed against this one in turns
// and lost in every call: its write must first read the map word back,
// a second dependent trip, and the merge sits on the critical path
// (PERF.md §6).

#include "common.cuh"

namespace {

constexpr int FLUSH_BLOCK = 256;

__global__ void __launch_bounds__(FLUSH_BLOCK)
cov_flush_kernel(int32_t* __restrict__ cov_map, const int32_t* __restrict__ buf,
                 const int32_t* __restrict__ n, int lanes, int c, int w) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * FLUSH_BLOCK + threadIdx.x;
  if (g >= static_cast<int64_t>(lanes) * c) return;
  const int64_t lane = g / c;
  const int i = static_cast<int>(g - lane * c);
  const int slot = __ldg(buf + g);  // issued with the count's load, not after it
  const int count = __ldg(n + lane);
  const int word = slot >> 5;
  if (i >= count || word < 0 || word >= w) return;
  atomicOr(reinterpret_cast<unsigned int*>(cov_map) + lane * w + word, 1u << (slot & 31));
}

dim3 flush_grid(int lanes, int c) {
  return dim3(static_cast<unsigned>((static_cast<int64_t>(lanes) * c + FLUSH_BLOCK - 1) / FLUSH_BLOCK));
}

}  // namespace

extern "C" int cov_flush_launch(void* cov_map, const void* buf, const void* n, int lanes,
                                int c, int w, void* stream) {
  if (lanes < 0 || c < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(lanes) * c;
  if (total == 0) return 0;
  cov_flush_kernel<<<flush_grid(lanes, c), FLUSH_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(cov_map), static_cast<const int32_t*>(buf),
      static_cast<const int32_t*>(n), lanes, c, w);
  return static_cast<int>(cudaGetLastError());
}

// The grid and block of the flush at `lanes` lanes of `c` entries, for the
// launch floor (launch_floor.cu).
extern "C" void cov_flush_geometry(int lanes, int c, int* grid, int* block) {
  *grid = static_cast<int>(flush_grid(lanes, c).x);
  *block = FLUSH_BLOCK;
}
