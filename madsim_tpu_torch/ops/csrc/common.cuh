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

// -- lane groups --------------------------------------------------------------
//
// A group of GROUP neighbouring threads of a warp owns one lane, so a warp
// serves 32 / GROUP lanes and a block of GROUP_BLOCK threads GROUP_LANES.
// Every thread of the warp stays to the end: a group past the last lane
// computes the last lane again and stores nothing. So the group's
// exchanges are full-warp shuffles (width GROUP or xor offsets below
// GROUP), which compile to plain SHFLs, where a per-group mask makes the
// compiler check convergence before each one and run a REDUX once per
// group of the warp.

constexpr int GROUP = 8;
constexpr int GROUP_BLOCK = 256;
constexpr int GROUP_LANES = GROUP_BLOCK / GROUP;
// Fields of the popped slot a thread holds in registers: the first
// GATHER_ROUNDS * GROUP (time, kind, node, src and payload[0, 4 GROUP - 4)).
constexpr int GATHER_ROUNDS = 2;
constexpr int NO_SLOT = INT_MAX;  // the slot index of a thread with no valid slot

inline dim3 group_grid(int lanes) { return dim3((lanes + GROUP_LANES - 1) / GROUP_LANES); }

// The int4 / uchar4 loads need Q a multiple of 4 and 16-byte (time, seq)
// and 4-byte (valid) aligned planes; then every row is aligned too.
inline bool rows_vectorizable(const void* time, const void* seq, const void* valid, int q) {
  return q % 4 == 0 && reinterpret_cast<uintptr_t>(time) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(seq) % 16 == 0 && reinterpret_cast<uintptr_t>(valid) % 4 == 0;
}

struct LaneGroup {
  int64_t lane;  // the lane the group computes (the last one past the end)
  bool live;     // whether it owns that lane and stores its results
  int g;         // this thread's rank in the group
};

__device__ __forceinline__ LaneGroup lane_group(int lanes) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * GROUP_LANES + threadIdx.x / GROUP;
  return {lane < lanes ? lane : lanes - 1, lane < lanes, static_cast<int>(threadIdx.x) & (GROUP - 1)};
}

// (t1, s1, j1) < (t2, s2, j2), with bitwise operators: no short circuit,
// so the compiler emits compares and selects, not a branch per slot.
__device__ __forceinline__ bool lex_less(int32_t t1, int32_t s1, int j1, int32_t t2, int32_t s2, int j2) {
  return (t1 < t2) | ((t1 == t2) & ((s1 < s2) | ((s1 == s2) & (j1 < j2))));
}

// A lexicographic (time, seq, index) best; (INT_MAX, INT_MAX, NO_SLOT)
// until a valid slot is taken, which every valid slot beats, INT_MAX
// times and seqs included.
struct LexBest {
  int32_t t = INT_MAX, s = INT_MAX;
  int j = NO_SLOT;
  __device__ __forceinline__ void take(int32_t tj, int32_t sj, bool vj, int jj) {
    const bool better = vj & lex_less(tj, sj, jj, t, s, j);
    t = better ? tj : t;
    s = better ? sj : s;
    j = better ? jj : j;
  }
};

// The pop of one lane's event queue by its group: the lexicographic
// (time, seq, index) argmin over the valid slots of the row, with each
// plane read once. With VEC, thread g loads slots 4g..4g+3 (+ 4 GROUP,
// ...) of the time and seq planes as one int4 each and of the valid plane
// as one uchar4; otherwise slots g, g + GROUP, ... one by one. One local
// pass in registers, then one xor butterfly over the group that keeps the
// lexicographic minimum of (time, seq, index) triples: log2(GROUP) steps
// of three independent shuffles. An all-invalid row gives index 0 and any = false; a valid
// slot at INT_MAX is a legal time and still wins. Every thread of the
// warp must call it.
template <bool VEC>
__device__ __forceinline__ int group_lex_argmin(const int32_t* __restrict__ time,
                                                const int32_t* __restrict__ seq,
                                                const uint8_t* __restrict__ valid, int q, int g,
                                                bool& any) {
  LexBest b;
  if (VEC) {
    for (int j = 4 * g; j < q; j += 4 * GROUP) {
      const int4 t4 = __ldg(reinterpret_cast<const int4*>(time + j));
      const int4 s4 = __ldg(reinterpret_cast<const int4*>(seq + j));
      const uchar4 v4 = __ldg(reinterpret_cast<const uchar4*>(valid + j));
      b.take(t4.x, s4.x, v4.x, j);
      b.take(t4.y, s4.y, v4.y, j + 1);
      b.take(t4.z, s4.z, v4.z, j + 2);
      b.take(t4.w, s4.w, v4.w, j + 3);
    }
  } else {
    for (int j = g; j < q; j += GROUP) b.take(__ldg(time + j), __ldg(seq + j), __ldg(valid + j), j);
  }
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) {
    const int32_t t2 = __shfl_xor_sync(FULL_MASK, b.t, o);
    const int32_t s2 = __shfl_xor_sync(FULL_MASK, b.s, o);
    const int j2 = __shfl_xor_sync(FULL_MASK, b.j, o);
    const bool other = lex_less(t2, s2, j2, b.t, b.s, b.j);
    b.t = other ? t2 : b.t;
    b.s = other ? s2 : b.s;
    b.j = other ? j2 : b.j;
  }
  any = b.j != NO_SLOT;
  return any ? b.j : 0;
}

// The popped event: field f of a slot is 0 time, 1 kind, 2 node, 3 src,
// then payload column f - 4. Thread g of a group takes fields g,
// g + GROUP, ...; it loads and writes only those.
struct EventPlanes {
  const int32_t* time;
  const int32_t* kind;
  const int32_t* node;
  const int32_t* src;
  const int32_t* payload;
  int p;
};

struct EventOut {
  int32_t* time;
  int32_t* kind;
  int32_t* node;
  int32_t* src;
  int32_t* payload;
};

// Where field f of a slot lives: src[at * stride] in, dst[lane * stride]
// out (stride 1 on the four planes, P in a payload row). Known before the
// argmin, so the gather is one multiply-add and a load once the slot is.
struct FieldRef {
  const int32_t* src;
  int32_t* dst;
  int stride;
  bool on;  // f < 4 + P
};

__device__ __forceinline__ FieldRef field_ref(const EventPlanes& in, const EventOut& out, int f) {
  if (f >= 4) return {in.payload + (f - 4), out.payload + (f - 4), in.p, f < 4 + in.p};
  return {f == 0 ? in.time : f == 1 ? in.kind : f == 2 ? in.node : in.src,
          f == 0 ? out.time : f == 1 ? out.kind : f == 2 ? out.node : out.src, 1, true};
}

__device__ __forceinline__ int32_t field_load(const FieldRef& r, int64_t at) {
  return r.on ? __ldg(r.src + at * r.stride) : 0;
}

__device__ __forceinline__ void field_store(const FieldRef& r, int64_t lane, int32_t v) {
  if (r.on) r.dst[lane * r.stride] = v;
}

}  // namespace madsim
