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
// What bounds them on an H100. By the data, bytes: the time, seq and
// valid planes are read whole (9 bytes a slot), each gathered field costs
// one 32-byte sector, the outputs are a few words a lane; compute is
// three compares a slot. In practice, latency: at 8192 lanes the whole
// input is ~4 MB, L2-resident, so a launch is two dependent trips to
// memory (the planes, then the popped slot) plus the instructions issued
// in between, on top of the fixed cost of one launch of one wave.
//
// What the design does about it: lane groups (common.cuh). Eight threads
// own a lane, so a warp serves four and a 256-thread block 32. Each plane
// is read once, as 16-byte loads where Q % 4 == 0 and the rows are
// aligned (a scalar path takes Q = 33 or a sliced plane), and the argmin
// is one local pass in registers and one three-step xor butterfly over
// (time, seq, index) triples. `pop_gather` then gathers with one load per
// field from the thread that owns the field, its address known before
// the argmin, all issued together, and each thread writes what it loaded.
// `pop_earliest` stores (idx, any) from the group's first thread: one trip
// to memory a launch, at any L. Its launches are the single-lane replay's
// (L = 1, Q = 32): one block, whose other 31 groups compute lane 0 again
// and store nothing (a one-warp block there was no faster).

#include "common.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(madsim::GROUP_BLOCK)
pop_gather_kernel(const int32_t* __restrict__ eq_time, const int32_t* __restrict__ eq_seq,
                  const uint8_t* __restrict__ eq_valid, const int32_t* __restrict__ eq_kind,
                  const int32_t* __restrict__ eq_node, const int32_t* __restrict__ eq_src,
                  const int32_t* __restrict__ eq_payload, int lanes, int q, int p,
                  int32_t* __restrict__ idx_out, uint8_t* __restrict__ any_out,
                  int32_t* __restrict__ time_out, int32_t* __restrict__ kind_out,
                  int32_t* __restrict__ node_out, int32_t* __restrict__ src_out,
                  int32_t* __restrict__ payload_out) {
  using namespace madsim;
  const LaneGroup grp = lane_group(lanes);
  const EventPlanes in{eq_time, eq_kind, eq_node, eq_src, eq_payload, p};
  const EventOut out{time_out, kind_out, node_out, src_out, payload_out};
  FieldRef ref[GATHER_ROUNDS];
#pragma unroll
  for (int r = 0; r < GATHER_ROUNDS; ++r) ref[r] = field_ref(in, out, r * GROUP + grp.g);

  const int64_t row = grp.lane * q;
  bool any;
  const int best = group_lex_argmin<VEC>(eq_time + row, eq_seq + row, eq_valid + row, q, grp.g, any);
  if (!grp.live) return;  // no collective follows
  const int64_t at = row + best;
  int32_t v[GATHER_ROUNDS];
#pragma unroll
  for (int r = 0; r < GATHER_ROUNDS; ++r) v[r] = field_load(ref[r], at);
  if (grp.g == 0) {
    idx_out[grp.lane] = best;
    any_out[grp.lane] = any ? 1 : 0;
  }
#pragma unroll
  for (int r = 0; r < GATHER_ROUNDS; ++r) field_store(ref[r], grp.lane, v[r]);
  for (int f = GATHER_ROUNDS * GROUP + grp.g; f < 4 + p; f += GROUP) {  // payloads wider than that
    const FieldRef tail = field_ref(in, out, f);
    field_store(tail, grp.lane, field_load(tail, at));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(madsim::GROUP_BLOCK)
pop_earliest_kernel(const int32_t* __restrict__ eq_time, const int32_t* __restrict__ eq_seq,
                    const uint8_t* __restrict__ eq_valid, int lanes, int q,
                    int32_t* __restrict__ idx_out, uint8_t* __restrict__ any_out) {
  using namespace madsim;
  const LaneGroup grp = lane_group(lanes);
  const int64_t row = grp.lane * q;
  bool any;
  const int best = group_lex_argmin<VEC>(eq_time + row, eq_seq + row, eq_valid + row, q, grp.g, any);
  if (grp.live && grp.g == 0) {
    idx_out[grp.lane] = best;
    any_out[grp.lane] = any ? 1 : 0;
  }
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() after the launch.
extern "C" int pop_gather_launch(const void* eq_time, const void* eq_seq, const void* eq_valid,
                                 const void* eq_kind, const void* eq_node, const void* eq_src,
                                 const void* eq_payload, int lanes, int q, int p, void* idx_out,
                                 void* any_out, void* time_out, void* kind_out, void* node_out,
                                 void* src_out, void* payload_out, void* stream) {
  if (q < 1 || p < 0 || lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  auto kernel = madsim::rows_vectorizable(eq_time, eq_seq, eq_valid, q) ? pop_gather_kernel<true>
                                                                        : pop_gather_kernel<false>;
  kernel<<<madsim::group_grid(lanes), madsim::GROUP_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
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
  auto kernel = madsim::rows_vectorizable(eq_time, eq_seq, eq_valid, q) ? pop_earliest_kernel<true>
                                                                        : pop_earliest_kernel<false>;
  kernel<<<madsim::group_grid(lanes), madsim::GROUP_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(eq_time), static_cast<const int32_t*>(eq_seq),
      static_cast<const uint8_t*>(eq_valid), lanes, q, static_cast<int32_t*>(idx_out),
      static_cast<uint8_t*>(any_out));
  return static_cast<int>(cudaGetLastError());
}
