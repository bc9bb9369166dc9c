// The sPCR reach closure, fused: one launch runs a whole closure call (every
// BFS level, both phases) on the device, for Hopper (sm_90a).
//
// It is the port's counterpart of the TPU kernel probe_rows
// (sharkmer_tpu/ops/pallas_kernels.py) inside the JAX closure loop
// (sharkmer_tpu/ops/reach.py _closure_run, a lax.while_loop whose every level
// calls lookup_pallas). The torch loop it replaces (kernels/closure.py
// closure_plain, the CPU path and the test oracle) dispatched ~56 small
// launches and a host sync per level; on the card a level is a few
// microseconds of dependent loads, so the host loop was the whole cost.
//
// One launch = one attempt of ops/reach._reach_call at one (f_cap, f_narrow):
//   * prologue: set the visited bits of the warm-start rows (pre_ids, from
//     one routed probe_rows launch);
//   * root level from c0: canonicalise each key against its reverse
//     complement;
//   * each level: expand every live walker to its 8 de Bruijn neighbours
//     (4 suffix, then 4 prefix shifts), carrying the reverse complements by
//     shifts; route each canonical candidate to the partition whose key range
//     holds it; probe that partition's bucket (probe_rows.cuh, the code of
//     the probe_rows kernel); claim the row with atomicOr on the visited
//     bitmap (a clear old bit is a first visit, so a row is claimed once per
//     call, however many candidates reach it); a block-wide counter compacts
//     the claims into the next frontier and appends their ids to the log;
//   * the phase logic of closure_plain exactly: a wide loop at f_cap while
//     it <= depth, not done, no overflow and more than f_narrow live walkers;
//     then the narrow loop at f_narrow in bodies of 4 levels with the
//     condition tested once per body (levels run on an empty frontier count
//     in `it`, as in JAX); one level per test when f_narrow >= f_cap;
//   * more claims in a level than its width raise overflow and stop the
//     call: _drive_closure discards it and retries wider.
// The visited set, n_vis, iters, done and the boundary set equal the torch
// loop's and the JAX package's; only the order of the ids inside a level's
// log block and of the boundary differ, and nothing downstream reads it
// (_reach_call sorts the log, _drive_closure keeps the boundary's unique
// keys).
//
// Design: one persistent block of 1024 threads. A group of 8 lanes probes one
// candidate, so a round covers 128 candidates: a narrow level (at most 16
// walkers, 128 candidates) is one round, a wide one (256 walkers) 16. The
// level's cost is its chain of dependent loads (frontier, LUT, bucket rows,
// bitmap atomic) plus two block barriers; the bytes it moves are a few KB.
// The frontiers and the log live in global scratch, so every width the
// grow-and-retry loop asks for works.
//
// Plain C interface, bound with ctypes: the entry point launches on the given
// stream, does not synchronise, allocates nothing (the wrapper passes zeroed
// bitmap, INF-filled log and the other scratch), and returns
// cudaGetLastError() after its launch (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

#include "probe_rows.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kGroup = 8;                     // lanes per candidate probe
constexpr int kPerWarp = 32 / kGroup;         // candidates per warp per round
constexpr int kPerRound = kThreads / kGroup;  // candidates per round

struct Closure {
  const shk::PartDesc* parts;
  int n_parts;
  const int64_t* c0;  // root keys, directional, sentinel-padded
  int n_c0;
  const int* pre_ids;  // warm-start global row ids, INT32_MAX-padded
  int n_pre;
  int64_t min_count;
  int k, depth, f_cap, f_narrow;
  unsigned* bitmap;   // visited bit per global row id, zeroed
  int64_t* front;     // [2][f_cap][2]: (key, reverse complement) per walker
  int* log;           // first-visit ids in visit order, INT32_MAX-filled
  int64_t* boundary;  // [f_cap] walkers live at exit, sentinel-padded
  int64_t* state;     // n_vis, iters, overflow, done
};

// Block-shared closure state; only thread 0 writes it, between barriers.
struct State {
  int claims;  // first visits in this level so far
  int n_live;  // walkers in the current frontier
  int it;
  int n_vis;
  int overflow;
  int done;
};

__device__ __forceinline__ uint64_t revcomp(uint64_t x, int k) {
  x = ~x;  // complement: 3 - b == b ^ 3 for a 2-bit base
  x = ((x & 0x3333333333333333ull) << 2) | ((x >> 2) & 0x3333333333333333ull);
  x = ((x & 0x0F0F0F0F0F0F0F0Full) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0Full);
  x = ((x & 0x00FF00FF00FF00FFull) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFull);
  x = ((x & 0x0000FFFF0000FFFFull) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFull);
  x = (x << 32) | (x >> 32);
  return x >> (64 - 2 * k);
}

// One BFS level: candidates from `src` (the root keys c0 when root), first
// visits compacted into `dst`, up to `width` of them.
__device__ __forceinline__ void run_level(const Closure& a, State& st,
                                          const int64_t* src, int64_t* dst,
                                          bool root, int width) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int glane = lane % kGroup;
  const int n_cand = root ? a.n_c0 : 8 * st.n_live;
  const int log_pos = st.n_vis;
  const uint64_t kmask = (1ull << (2 * a.k)) - 1;
  const int top = 2 * (a.k - 1);
  // warp-uniform rounds: every lane of a warp takes part in group_max
  for (int first = (tid >> 5) * kPerWarp; first < n_cand; first += kPerRound) {
    const int i = first + lane / kGroup;
    int64_t key = shk::kSentinel;
    int64_t key_rc = shk::kSentinel;
    if (i < n_cand) {
      uint64_t c = 0, c_rc = 0;
      bool live = true;
      if (root) {
        const int64_t r = a.c0[i];
        live = r != shk::kSentinel;
        c = static_cast<uint64_t>(r);
        c_rc = revcomp(c, a.k);
      } else {
        const uint64_t f = static_cast<uint64_t>(src[2 * (i >> 3)]);
        const uint64_t r = static_cast<uint64_t>(src[2 * (i >> 3) + 1]);
        const uint64_t b = i & 3;
        if ((i & 7) < 4) {  // suffix shift: append b
          c = ((f << 2) | b) & kmask;
          c_rc = ((3 - b) << top) | (r >> 2);
        } else {  // prefix shift: prepend b
          c = (b << top) | (f >> 2);
          c_rc = ((r << 2) | (3 - b)) & kmask;
        }
      }
      if (live) {
        key = static_cast<int64_t>(c < c_rc ? c : c_rc);
        key_rc = static_cast<int64_t>(c < c_rc ? c_rc : c);
      }
    }
    const shk::PartDesc& p = a.parts[shk::route_part(a.parts, a.n_parts, key)];
    const int row = shk::group_max<kGroup>(shk::probe_lane<kGroup>(
        p.keys, p.counts, p.lut, p.n_lut, p.shift, key, a.min_count, glane));
    if (glane == 0 && row >= 0) {
      const int id = p.base + row;
      const unsigned bit = 1u << (id & 31);
      if (!(atomicOr(a.bitmap + (id >> 5), bit) & bit)) {
        const int slot = atomicAdd(&st.claims, 1);
        if (slot < width) {
          dst[2 * slot] = key;
          dst[2 * slot + 1] = key_rc;
          a.log[log_pos + slot] = id;
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int n_new = min(st.claims, width);
    st.overflow |= st.claims > width;
    st.n_vis += n_new;
    st.it += 1;
    st.done = n_new == 0;
    st.n_live = n_new;
    st.claims = 0;
  }
  __syncthreads();
}

// A level after the root: the current frontier front[cur] feeds the other one.
__device__ __forceinline__ void next_level(const Closure& a, State& st,
                                           int64_t* const front[2], int& cur,
                                           int width) {
  run_level(a, st, front[cur], front[cur ^ 1], false, width);
  cur ^= 1;
}

__global__ void __launch_bounds__(kThreads, 1) reach_closure_kernel(Closure a) {
  __shared__ State st;
  const int tid = threadIdx.x;
  // warm start: rows below the floor probed to INT32_MAX and are skipped
  for (int i = tid; i < a.n_pre; i += kThreads) {
    const int id = a.pre_ids[i];
    if (id != shk::kInf) atomicOr(a.bitmap + (id >> 5), 1u << (id & 31));
  }
  if (tid == 0) {
    st.claims = 0;
    st.n_live = 0;
    st.it = 0;
    st.n_vis = 0;
    st.overflow = 0;
    st.done = 0;
  }
  __syncthreads();

  int64_t* const front[2] = {a.front,
                             a.front + 2 * static_cast<int64_t>(a.f_cap)};
  int cur = 0;
  run_level(a, st, nullptr, front[cur], true, a.f_cap);
  // every thread reads the same shared state after a barrier, so the loop
  // conditions are uniform across the block
  if (a.f_narrow < a.f_cap) {
    while (st.it <= a.depth && !st.done && !st.overflow &&
           st.n_live > a.f_narrow) {
      next_level(a, st, front, cur, a.f_cap);
    }
    // the narrow loop runs only when the wide one left <= f_narrow walkers:
    // they sit at the front of the frontier, so the cut keeps them all
    while (st.it <= a.depth && !st.done && !st.overflow) {
      for (int j = 0; j < 4 && !st.overflow; ++j) {
        next_level(a, st, front, cur, a.f_narrow);
      }
    }
  } else {
    while (st.it <= a.depth && !st.done && !st.overflow) {
      next_level(a, st, front, cur, a.f_cap);
    }
  }

  const int n_live = st.n_live;
  const int64_t* frontier = front[cur];
  for (int i = tid; i < a.f_cap; i += kThreads) {
    a.boundary[i] = i < n_live ? frontier[2 * i] : shk::kSentinel;
  }
  if (tid == 0) {
    a.state[0] = st.n_vis;
    a.state[1] = st.it;
    a.state[2] = st.overflow;
    a.state[3] = st.done;
  }
}

}  // namespace

extern "C" {

int shk_reach_closure(const void* parts, int n_parts, const int64_t* c0,
                      int n_c0, const int* pre_ids, int n_pre,
                      int64_t min_count, int k, int depth, int f_cap,
                      int f_narrow, unsigned* bitmap, int64_t* front, int* log,
                      int64_t* boundary, int64_t* state, cudaStream_t stream) {
  Closure a;
  a.parts = static_cast<const shk::PartDesc*>(parts);
  a.n_parts = n_parts;
  a.c0 = c0;
  a.n_c0 = n_c0;
  a.pre_ids = pre_ids;
  a.n_pre = n_pre;
  a.min_count = min_count;
  a.k = k;
  a.depth = depth;
  a.f_cap = f_cap;
  a.f_narrow = f_narrow;
  a.bitmap = bitmap;
  a.front = front;
  a.log = log;
  a.boundary = boundary;
  a.state = state;
  reach_closure_kernel<<<1, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
