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
// What bounds it on an H100: bytes. The time, seq and valid planes are
// read whole (9 bytes a slot, 288 bytes a lane at Q = 32); each gathered
// field costs one 32-byte sector; the outputs are ~100 bytes a lane. At
// 8192 lanes that is ~4-5 MB a step, a microsecond or two at 3.35 TB/s.
// The Threefry rounds and the digest are a few hundred integer
// operations a lane, far below the ALUs' rate.
//
// What the design does about it: one warp per lane, so the 32 slots of a
// lane are one coalesced 128-byte load per plane, and the three-stage
// argmin is a register-only butterfly (__shfl_xor_sync), the same
// function the pop kernels run (madsim::warp_lex_argmin, common.cuh). The gather
// reads only the popped slot's kind, node, src and payload, never the
// other planes whole (the TPU kernel's one-hot sums read them all).
// Threefry pairs run one per thread in registers; the word block goes
// to global memory once and to a per-warp shared-memory row that thread
// 0 folds into the digest after __syncwarp.

#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_WORDS = 256;

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

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
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
  __shared__ uint32_t s_words[WARPS_PER_BLOCK][MAX_WORDS];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (lane >= lanes) return;  // uniform over the warp
  const int64_t row = static_cast<int64_t>(lane) * q;

  // 1. argmin: the (time, seq, index) minimum over the valid slots,
  //    shared with the pop kernels (common.cuh)
  bool any;
  const int best = madsim::warp_lex_argmin(eq_time + row, eq_seq + row, eq_valid + row, q, any);

  // 2. gather the popped slot only
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

  // 3. the v3 word block: thread i computes the pair (i, i + half)
  const uint32_t k0 = rng_key[2 * static_cast<int64_t>(lane)];
  const uint32_t k1 = rng_key[2 * static_cast<int64_t>(lane) + 1];
  const uint32_t base = static_cast<uint32_t>(step[lane]) * static_cast<uint32_t>(w);
  const int half = (w + 1) / 2;
  uint32_t* words = words_out + static_cast<int64_t>(lane) * w;
  for (int i = t; i < half; i += 32) {
    const int i1 = i + half;
    uint32_t x0 = base + static_cast<uint32_t>(i);
    uint32_t x1 = i1 < w ? base + static_cast<uint32_t>(i1) : 0u;
    threefry2x32(k0, k1, x0, x1);
    words[i] = x0;
    s_words[warp][i] = x0;
    if (i1 < w) {
      words[i1] = x1;
      s_words[warp][i1] = x1;
    }
  }
  __syncwarp();

  // 4. the digest fold, in the reference's word order
  if (d0_in != nullptr && t == 0) {
    uint32_t d0 = d0_in[lane];
    uint32_t d1 = d1_in[lane];
    digest_word(d0, d1, static_cast<uint32_t>(eq_time[at]));
    digest_word(d0, d1, static_cast<uint32_t>(eq_kind[at]));
    digest_word(d0, d1, static_cast<uint32_t>(eq_node[at]));
    digest_word(d0, d1, static_cast<uint32_t>(eq_src[at]));
    for (int c = 0; c < p; ++c) digest_word(d0, d1, static_cast<uint32_t>(eq_payload[at * p + c]));
    for (int i = 0; i < w; ++i) digest_word(d0, d1, s_words[warp][i]);
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
  if (w < 1 || w > MAX_WORDS || q < 1 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((lanes + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  step_megakernel_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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
