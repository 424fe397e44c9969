// The pop and gather of the split-chain (v2) step, and the pop alone.
//
// Replace the TPU kernels of madsim_tpu/ops/pallas_pop.py
//   * `pop_gather_pallas` (body `_make_pop_gather_kernel`): per lane the
//     lexicographic (time, seq, index) argmin over the valid slots of the
//     event queue, then the popped (time, kind, node, src, payload[P]);
//     the step prefix whenever the step megakernel does not run (every
//     v2 step, and v3 with pallas_megakernel=False);
//   * `pop_earliest_pallas` (body `_pop_kernel`): the argmin alone,
//     (idx, any); the single-lane replay's pop.
// An all-invalid lane gives idx 0, any 0 and gathers slot 0, as the TPU
// kernels do. Neither kernel draws random words or folds a digest.
//
// What bounds them on an H100: bytes. The time, seq and valid planes are
// read whole (9 bytes a slot); each gathered field (kind, node, src, the
// payload row) costs one 32-byte sector; the outputs are a few words a
// lane. Compute is three compares a slot.
//
// What the design does about it: one warp per lane, the argmin shared
// with the step megakernel (`madsim::warp_lex_argmin`: coalesced loads of
// 32 slots a pass and register-only butterflies), and a gather of the
// popped slot only, where the TPU kernel's one-hot sums read every plane
// whole.

#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
pop_gather_kernel(const int32_t* __restrict__ eq_time, const int32_t* __restrict__ eq_seq,
                  const uint8_t* __restrict__ eq_valid, const int32_t* __restrict__ eq_kind,
                  const int32_t* __restrict__ eq_node, const int32_t* __restrict__ eq_src,
                  const int32_t* __restrict__ eq_payload, int lanes, int q, int p,
                  int32_t* __restrict__ idx_out, uint8_t* __restrict__ any_out,
                  int32_t* __restrict__ time_out, int32_t* __restrict__ kind_out,
                  int32_t* __restrict__ node_out, int32_t* __restrict__ src_out,
                  int32_t* __restrict__ payload_out) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (lane >= lanes) return;  // uniform over the warp
  const int64_t row = static_cast<int64_t>(lane) * q;
  bool any;
  const int best = madsim::warp_lex_argmin(eq_time + row, eq_seq + row, eq_valid + row, q, any);
  const int64_t at = row + best;
  if (t == 0) {
    idx_out[lane] = best;
    any_out[lane] = any ? 1 : 0;
    time_out[lane] = eq_time[at];
    kind_out[lane] = eq_kind[at];
    node_out[lane] = eq_node[at];
    src_out[lane] = eq_src[at];
  }
  for (int c = t; c < p; c += 32) {
    payload_out[static_cast<int64_t>(lane) * p + c] = eq_payload[at * p + c];
  }
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
pop_earliest_kernel(const int32_t* __restrict__ eq_time, const int32_t* __restrict__ eq_seq,
                    const uint8_t* __restrict__ eq_valid, int lanes, int q,
                    int32_t* __restrict__ idx_out, uint8_t* __restrict__ any_out) {
  const int lane = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (lane >= lanes) return;  // uniform over the warp
  const int64_t row = static_cast<int64_t>(lane) * q;
  bool any;
  const int best = madsim::warp_lex_argmin(eq_time + row, eq_seq + row, eq_valid + row, q, any);
  if ((threadIdx.x & 31) == 0) {
    idx_out[lane] = best;
    any_out[lane] = any ? 1 : 0;
  }
}

dim3 grid_for(int lanes) { return dim3((lanes + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK); }

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() after the launch.
extern "C" int pop_gather_launch(const void* eq_time, const void* eq_seq, const void* eq_valid,
                                 const void* eq_kind, const void* eq_node, const void* eq_src,
                                 const void* eq_payload, int lanes, int q, int p, void* idx_out,
                                 void* any_out, void* time_out, void* kind_out, void* node_out,
                                 void* src_out, void* payload_out, void* stream) {
  if (q < 1 || p < 0 || lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  pop_gather_kernel<<<grid_for(lanes), 32 * WARPS_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(eq_time), static_cast<const int32_t*>(eq_seq),
      static_cast<const uint8_t*>(eq_valid), static_cast<const int32_t*>(eq_kind),
      static_cast<const int32_t*>(eq_node), static_cast<const int32_t*>(eq_src),
      static_cast<const int32_t*>(eq_payload), lanes, q, p, static_cast<int32_t*>(idx_out),
      static_cast<uint8_t*>(any_out), static_cast<int32_t*>(time_out),
      static_cast<int32_t*>(kind_out), static_cast<int32_t*>(node_out),
      static_cast<int32_t*>(src_out), static_cast<int32_t*>(payload_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pop_earliest_launch(const void* eq_time, const void* eq_seq, const void* eq_valid,
                                   int lanes, int q, void* idx_out, void* any_out, void* stream) {
  if (q < 1 || lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  pop_earliest_kernel<<<grid_for(lanes), 32 * WARPS_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(eq_time), static_cast<const int32_t*>(eq_seq),
      static_cast<const uint8_t*>(eq_valid), lanes, q, static_cast<int32_t*>(idx_out),
      static_cast<uint8_t*>(any_out));
  return static_cast<int>(cudaGetLastError());
}
