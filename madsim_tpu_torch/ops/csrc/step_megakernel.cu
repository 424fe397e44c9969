// The step megakernel: the model-independent prefix of every event step.
//
// Replaces the TPU kernel `step_megakernel` of
// madsim_tpu/ops/pallas_pop.py (body `_make_step_kernel`). Per lane it
// computes
//   1. the lexicographic (time, seq, index) argmin over the valid slots
//      of the lane's event queue (an all-invalid lane gives index 0 and
//      any = 0),
//   2. the gather of the popped (time, kind, node, src, payload[P]),
//   3. the v3 Threefry-2x32 word block at counters step*W + i, with
//      jax's odd-W packing (the pad counter is 0, not step*W + W),
//   4. when d0/d1 are given, the flight-recorder digest fold over time,
//      kind, node, src, the payload columns, then the W words
//      (madsim_tpu/engine/core.py `digest_fold`).
//
// What bounds it on an H100. By the data, bytes: the time, seq and valid
// planes are read whole (9 bytes a slot, 288 bytes a lane at Q = 32),
// each gathered field costs one 32-byte sector, the outputs are ~100
// bytes a lane: ~4.3 MB a step at 8192 lanes, 1.3 us at 3.35 TB/s. In
// practice, latency and issue: the input is L2-resident, so a launch is
// two dependent trips to memory (the planes, then the popped slot), a
// serial digest chain of 4 + P + W words and the Threefry rounds, on top
// of the fixed cost of one launch of one wave.
//
// What the design does about it: lane groups (common.cuh). Eight threads
// own a lane, so a warp serves four lanes and every warp instruction
// does four lanes' work.
//   * One load pass: each plane is read once (16-byte loads where Q % 4
//     == 0 and the rows are aligned, else a scalar path), the argmin is a
//     local pass in registers and one three-step xor butterfly over
//     (time, seq, index) triples.
//   * The gather: thread g loads fields g, g + 8, ..., their addresses
//     known before the argmin, all issued together as soon as the index
//     is.
//   * Threefry off the critical path: the key, step and digest are
//     loaded first, and the word block (W/2 pairs shared by the group)
//     runs while the plane loads are in flight, ahead of the argmin.
//   * The digest in registers: every thread of the group folds the same
//     chain, taking the fields and words from their owners by unrolled
//     full-warp shuffles, so four folds run at once in a warp and no
//     shared memory is used. Past W = 2 * GROUP a thread holds more than
//     one pair, and the fold re-reads the lane's words from global memory
//     after __syncwarp instead.

#include "common.cuh"

namespace {

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = madsim::rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ void digest_word(uint32_t& d0, uint32_t& d1, uint32_t w) {
  d0 = (d0 ^ w) * 0x9E3779B1u;
  d0 ^= d0 >> 16;
  d1 = (d1 ^ madsim::rotl32(w, 13)) * 0x85EBCA6Bu;
  d1 = d1 ^ (d1 >> 15) ^ d0;
}

// The digest over one round of gathered fields or words: the first
// `count` of the GROUP values x of the group's threads, in rank order.
// The shuffles go out together, unrolled; the fold is the serial part.
__device__ __forceinline__ void fold_round(uint32_t& d0, uint32_t& d1, uint32_t x, int count) {
  uint32_t w[madsim::GROUP];
#pragma unroll
  for (int j = 0; j < madsim::GROUP; ++j) w[j] = __shfl_sync(madsim::FULL_MASK, x, j, madsim::GROUP);
#pragma unroll
  for (int j = 0; j < madsim::GROUP; ++j) {
    if (j < count) digest_word(d0, d1, w[j]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(madsim::GROUP_BLOCK)
step_megakernel_kernel(
    const int32_t* __restrict__ eq_time, const int32_t* __restrict__ eq_seq,
    const uint8_t* __restrict__ eq_valid, const int32_t* __restrict__ eq_kind,
    const int32_t* __restrict__ eq_node, const int32_t* __restrict__ eq_src,
    const int32_t* __restrict__ eq_payload, const uint32_t* __restrict__ rng_key,
    const int32_t* __restrict__ step, const uint32_t* __restrict__ d0_in,
    const uint32_t* __restrict__ d1_in, int lanes, int q, int p, int w,
    int32_t* __restrict__ idx_out, uint8_t* __restrict__ any_out,
    int32_t* __restrict__ time_out, int32_t* __restrict__ kind_out,
    int32_t* __restrict__ node_out, int32_t* __restrict__ src_out,
    int32_t* __restrict__ payload_out, uint32_t* __restrict__ words_out,
    uint32_t* __restrict__ d0_out, uint32_t* __restrict__ d1_out) {
  using namespace madsim;
  const LaneGroup grp = lane_group(lanes);
  const int64_t lane = grp.lane;
  const bool digest = d0_in != nullptr;
  const EventPlanes in{eq_time, eq_kind, eq_node, eq_src, eq_payload, p};
  const EventOut out{time_out, kind_out, node_out, src_out, payload_out};
  FieldRef ref[GATHER_ROUNDS];
#pragma unroll
  for (int r = 0; r < GATHER_ROUNDS; ++r) ref[r] = field_ref(in, out, r * GROUP + grp.g);

  // the lane's key, step and digest, loaded first
  const uint32_t k0 = __ldg(rng_key + 2 * lane);
  const uint32_t k1 = __ldg(rng_key + 2 * lane + 1);
  const uint32_t base = static_cast<uint32_t>(__ldg(step + lane)) * static_cast<uint32_t>(w);
  uint32_t d0 = digest ? __ldg(d0_in + lane) : 0u;
  uint32_t d1 = digest ? __ldg(d1_in + lane) : 0u;

  // the v3 word block, while the plane loads are in flight: thread g
  // computes the pairs (i, i + half), i = g, g + GROUP, ...; x0/x1 keep
  // its first
  uint32_t* words = words_out + lane * w;
  const int half = (w + 1) / 2;
  uint32_t x0 = 0, x1 = 0;
  for (int i = grp.g; i < half; i += GROUP) {
    const int i1 = i + half;
    uint32_t y0 = base + static_cast<uint32_t>(i);
    uint32_t y1 = i1 < w ? base + static_cast<uint32_t>(i1) : 0u;
    threefry2x32(k0, k1, y0, y1);
    if (grp.live) {
      words[i] = y0;
      if (i1 < w) words[i1] = y1;
    }
    if (i == grp.g) {
      x0 = y0;
      x1 = y1;
    }
  }

  // the argmin (common.cuh)
  const int64_t row = lane * q;
  bool any;
  const int best = group_lex_argmin<VEC>(eq_time + row, eq_seq + row, eq_valid + row, q, grp.g, any);

  // the gather's loads go out
  const int64_t at = row + best;
  int32_t v[GATHER_ROUNDS];
#pragma unroll
  for (int r = 0; r < GATHER_ROUNDS; ++r) v[r] = field_load(ref[r], at);

  if (grp.live) {
    if (grp.g == 0) {
      idx_out[lane] = best;
      any_out[lane] = any ? 1 : 0;
    }
#pragma unroll
    for (int r = 0; r < GATHER_ROUNDS; ++r) field_store(ref[r], lane, v[r]);
  }

  // the digest, in the reference's order: the fields, then the words
  const int nf = 4 + p;
  if (digest) {
#pragma unroll
    for (int r = 0; r < GATHER_ROUNDS; ++r) fold_round(d0, d1, static_cast<uint32_t>(v[r]), nf - r * GROUP);
  }
  for (int r = GATHER_ROUNDS; r * GROUP < nf; ++r) {  // payloads wider than the registers hold
    const FieldRef tail = field_ref(in, out, r * GROUP + grp.g);
    const int32_t x = field_load(tail, at);
    if (grp.live) field_store(tail, lane, x);
    if (digest) fold_round(d0, d1, static_cast<uint32_t>(x), nf - r * GROUP);
  }
  if (!digest) return;
  if (half <= GROUP) {
    fold_round(d0, d1, x0, half);
    fold_round(d0, d1, x1, w - half);
  } else {
    // a group past the last lane reads words it did not write; it stores
    // nothing, so what it reads does not matter
    __syncwarp();
    for (int i = 0; i < w; ++i) digest_word(d0, d1, words[i]);
  }
  if (grp.live && grp.g == 0) {
    d0_out[lane] = d0;
    d1_out[lane] = d1;
  }
}

}  // namespace

// Launch on `stream`; d0_in/d1_in/d0_out/d1_out may be null (no digest).
// Returns cudaGetLastError() after the launch.
extern "C" int step_megakernel_launch(
    const void* eq_time, const void* eq_seq, const void* eq_valid, const void* eq_kind,
    const void* eq_node, const void* eq_src, const void* eq_payload, const void* rng_key,
    const void* step, const void* d0_in, const void* d1_in, int lanes, int q, int p, int w,
    void* idx_out, void* any_out, void* time_out, void* kind_out, void* node_out,
    void* src_out, void* payload_out, void* words_out, void* d0_out, void* d1_out,
    void* stream) {
  if (w < 1 || q < 1 || p < 0 || lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  auto kernel = madsim::rows_vectorizable(eq_time, eq_seq, eq_valid, q) ? step_megakernel_kernel<true>
                                                                        : step_megakernel_kernel<false>;
  kernel<<<madsim::group_grid(lanes), madsim::GROUP_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(eq_time), static_cast<const int32_t*>(eq_seq),
      static_cast<const uint8_t*>(eq_valid), static_cast<const int32_t*>(eq_kind),
      static_cast<const int32_t*>(eq_node), static_cast<const int32_t*>(eq_src),
      static_cast<const int32_t*>(eq_payload), static_cast<const uint32_t*>(rng_key),
      static_cast<const int32_t*>(step), static_cast<const uint32_t*>(d0_in),
      static_cast<const uint32_t*>(d1_in), lanes, q, p, w, static_cast<int32_t*>(idx_out),
      static_cast<uint8_t*>(any_out), static_cast<int32_t*>(time_out),
      static_cast<int32_t*>(kind_out), static_cast<int32_t*>(node_out),
      static_cast<int32_t*>(src_out), static_cast<int32_t*>(payload_out),
      static_cast<uint32_t*>(words_out), static_cast<uint32_t*>(d0_out),
      static_cast<uint32_t*>(d1_out));
  return static_cast<int>(cudaGetLastError());
}
