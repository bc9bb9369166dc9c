// Segmented run scans over a sorted int64 key array, for Hopper (sm_90a).
//
// run_ends:   out[i] = position of the LAST element of i's equal-key run
// run_starts: out[i] = position of the FIRST element of i's equal-key run
//
// They replace the Pallas TPU kernels sharkmer_tpu/ops/pallas_kernels.py
// run_ends (_run_end_kernel) and run_starts (_run_start_kernel), which the
// sorted store's drains use to turn a sorted key buffer into run totals.
//
// Bound: device memory bandwidth. Each key is read once (8 B) and its
// position written once (4 B): 12 B a key, so at 3.35 TB/s a 2^27-key
// array takes 0.48 ms at best. The design moves just those 12 B, in one
// launch, with no scratch and no communication between blocks. It rests
// on the keys being sorted: run_starts[i] is the lower bound of keys[i]
// and run_ends[i] its upper bound less one, so the start (end) of a run
// that crosses into a tile from before (after) it is a search, not a
// carry passed from tile to tile.
//   - A block of 512 threads takes a tile of 4096 contiguous keys, 8 a
//     thread, loaded with 16-byte vector loads where the key pointer is
//     16-byte aligned, else key by key; a ragged last tile takes guarded
//     loads. At 32 registers a thread an SM holds 4 blocks, 128 KB of
//     keys in flight, so one block loads while another waits at its scan
//     barriers (16 keys a thread took 48-56 registers, 2 blocks an SM,
//     and ran slower: PERF.md). The neighbour across a thread's chunk
//     comes by shuffle, one extra load at a warp's edge.
//   - Run starts (ends) inside the tile: a bit mask per thread, the
//     thread's last start (first end) as its aggregate, one block-wide
//     exclusive max (min) scan, then a thread-serial pass that writes the
//     positions with 16-byte vector stores.
//   - The tile's carry: when the run of its first key began before the
//     tile (keys[lo-1] == keys[lo]), one warp finds where it began with
//     32 parallel loads a round: first the 32 keys just before the tile,
//     then a gallop (steps of 32 << lane), then rounds that cut the
//     bracket into 33 parts: at most 8 rounds for a run of 2^27. The carry
//     lies below every start in the tile, so max(local, carry) is exact.
//     run_ends mirrors it forward from the tile's end. Inside a long run
//     (the sentinel tail) every tile searches, its loads converging on
//     the same lines; across an all-equal array the gallop's last lane
//     reads the array's edge, so each search takes 2 rounds.
// None of the TPU kernel's workarounds carry over (u32 hi/lo planes,
// [R, 512] lane shifts, 8-row boundary blocks, the stitch of tile maxima).
//
// Plain C interface, bound with ctypes: each entry point launches one
// kernel on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after its launch (0 = success).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;             // threads per block
constexpr int kPer = 8;                   // keys per thread
constexpr int kTile = kThreads * kPer;    // keys per tile (block)
constexpr int kWarps = kThreads / 32;
static_assert(kPer % 4 == 0 && kPer <= 32, "int4 stores, a 32-bit mask");
// blocks an SM must hold: 2^14 keys (128 KB) in flight, a full SM
constexpr int kMinBlocks = 4;
constexpr unsigned kFullMask = 0xffffffffu;

struct MinOp {
  static __device__ __forceinline__ int identity() { return INT_MAX; }
  static __device__ __forceinline__ int apply(int a, int b) {
    return a < b ? a : b;
  }
};

struct MaxOp {
  static __device__ __forceinline__ int identity() { return -1; }
  static __device__ __forceinline__ int apply(int a, int b) {
    return a > b ? a : b;
  }
};

// Inclusive scan across the 32 lanes of a warp. kReverse scans from lane 31
// down to lane 0 (lane i gets op over lanes i..31).
template <class Op, bool kReverse>
__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = kReverse ? __shfl_down_sync(kFullMask, x, o)
                           : __shfl_up_sync(kFullMask, x, o);
    const bool in_range = kReverse ? (lane + o < 32) : (lane >= o);
    if (in_range) x = Op::apply(x, y);
  }
  return x;
}

// The exclusive value of each lane, from the lanes' inclusive values.
template <class Op, bool kReverse>
__device__ __forceinline__ int warp_exclusive(int incl, int lane) {
  const int y = kReverse ? __shfl_down_sync(kFullMask, incl, 1)
                         : __shfl_up_sync(kFullMask, incl, 1);
  const bool edge = kReverse ? (lane == 31) : (lane == 0);
  return edge ? Op::identity() : y;
}

// Block-wide exclusive scan of one value per thread, in thread order
// (kReverse: from the last thread back). Every thread of the block must
// call it; it holds two block barriers.
template <class Op, bool kReverse>
__device__ __forceinline__ int block_exclusive(int x) {
  __shared__ int warp_agg[kWarps];
  __shared__ int warp_carry[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive<Op, kReverse>(x, lane);
  const int excl = warp_exclusive<Op, kReverse>(incl, lane);
  // a warp's aggregate is the inclusive value of its last lane in scan
  // order (lane 31 forward, lane 0 reverse)
  if (lane == (kReverse ? 0 : 31)) warp_agg[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_agg[lane] : Op::identity();
    const int wi = warp_inclusive<Op, kReverse>(w, lane);
    const int we = warp_exclusive<Op, kReverse>(wi, lane);
    if (lane < kWarps) warp_carry[lane] = we;
  }
  __syncthreads();
  return Op::apply(excl, warp_carry[warp]);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A thread's keys [g0, g0 + kPer); keys at or past n are not loaded.
__device__ __forceinline__ void load_chunk(const int64_t* __restrict__ keys,
                                           int64_t g0, int64_t n,
                                           int64_t (&k)[kPer]) {
  if (g0 + kPer <= n && aligned16(keys)) {
    const longlong2* v = reinterpret_cast<const longlong2*>(keys + g0);
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      const longlong2 p = __ldg(v + j);
      k[2 * j] = p.x;
      k[2 * j + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      k[j] = g0 + j < n ? __ldg(keys + g0 + j) : 0;
  }
}

// A thread's positions [g0, g0 + kPer); those at or past n are dropped.
__device__ __forceinline__ void store_chunk(int* __restrict__ out, int64_t g0,
                                            int64_t n, const int (&o)[kPer]) {
  if (g0 + kPer <= n && aligned16(out)) {
    int4* v = reinterpret_cast<int4*>(out + g0);
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j)
      v[j] = make_int4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (g0 + j < n) out[g0 + j] = o[j];
  }
}

// The far edge of a run, searched by one whole warp. Positions e + d*t for
// 0 <= t <= t_max (d = -1: back toward 0; d = +1: forward toward n-1); the
// keys there equal x for t in [0, t*] and differ beyond, keys[e] == x.
// Returns e + d*t*. Each round loads 32 keys at once and takes their
// ballot, whose hits are a prefix of the lanes (t grows with the lane):
//   1. t = lane + 1: a run that ends within 32 keys is found here;
//   2. a gallop, t = 32 << lane (lane 31 reaches t_max, as t_max < 2^31);
//   3. rounds that cut the bracket (lo_t hit, hi_t missed) into 33 parts.
// tests/test_torch_kernels.py::_run_edge mirrors it in numpy on the CPU;
// change both together.
__device__ int64_t run_edge(const int64_t* __restrict__ keys, int64_t e, int d,
                            int64_t t_max, int64_t x, int lane) {
  int64_t t = min64(static_cast<int64_t>(lane) + 1, t_max);
  unsigned hit = __ballot_sync(kFullMask, __ldg(keys + e + d * t) == x);
  int h = __popc(hit);
  if (h < 32) return e + d * static_cast<int64_t>(h);
  if (t_max <= 32) return e + d * t_max;
  t = min64(static_cast<int64_t>(32) << lane, t_max);
  hit = __ballot_sync(kFullMask, __ldg(keys + e + d * t) == x);
  h = __popc(hit);
  if (h == 32) return e + d * t_max;
  // lane h - 1 hit (lane 0 probed t = 32, a hit of round 1), lane h missed
  const int below = h > 0 ? h - 1 : 0;
  int64_t lo_t = min64(static_cast<int64_t>(32) << below, t_max);
  int64_t hi_t = min64(static_cast<int64_t>(32) << h, t_max);
  while (hi_t - lo_t > 1) {
    const int64_t len = hi_t - lo_t;
    t = lo_t + len * (lane + 1) / 33;
    hit = __ballot_sync(kFullMask, __ldg(keys + e + d * t) == x);
    h = __popc(hit);
    const int64_t base = lo_t;
    if (h > 0) lo_t = base + len * h / 33;
    if (h < 32) hi_t = base + len * (h + 1) / 33;
  }
  return e + d * lo_t;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
run_starts_kernel(const int64_t* __restrict__ keys, int* __restrict__ out,
                  int64_t n) {
  __shared__ int tile_carry;
  const int lane = threadIdx.x & 31;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t g0 = lo + static_cast<int64_t>(threadIdx.x) * kPer;
  int64_t k[kPer];
  load_chunk(keys, g0, n, k);
  // the key before this thread's chunk: the previous lane's last one, or
  // a load at a warp's first lane
  int64_t prev = __shfl_up_sync(kFullMask, k[kPer - 1], 1);
  if (lane == 0 && g0 > 0 && g0 <= n) prev = __ldg(keys + g0 - 1);
  unsigned starts = 0;  // bit j: position g0 + j starts a run
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t before = j == 0 ? prev : k[j - 1];
    if (g0 + j < n && (g0 + j == 0 || k[j] != before)) starts |= 1u << j;
  }
  if (threadIdx.x < 32) {
    // the start of the run that holds keys[lo], where it began earlier
    const int64_t first = __shfl_sync(kFullMask, k[0], 0);
    const int64_t before = __shfl_sync(kFullMask, prev, 0);
    int carry = MaxOp::identity();
    if (lo > 0 && first == before)
      carry = static_cast<int>(
          run_edge(keys, lo - 1, -1, lo - 1, first, lane));
    if (lane == 0) tile_carry = carry;
  }
  const int agg = starts ? static_cast<int>(g0) + 31 - __clz(starts)
                         : MaxOp::identity();
  // the scan's barriers order warp 0's write of tile_carry before the read
  const int scanned = block_exclusive<MaxOp, false>(agg);
  int run = MaxOp::apply(scanned, tile_carry);
  int o[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((starts >> j) & 1u) run = static_cast<int>(g0) + j;
    o[j] = run;
  }
  store_chunk(out, g0, n, o);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
run_ends_kernel(const int64_t* __restrict__ keys, int* __restrict__ out,
                int64_t n) {
  __shared__ int tile_carry;
  const int lane = threadIdx.x & 31;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t hi = lo + kTile;  // past n for a ragged last tile
  const int64_t g0 = lo + static_cast<int64_t>(threadIdx.x) * kPer;
  int64_t k[kPer];
  load_chunk(keys, g0, n, k);
  // the key after this thread's chunk: the next lane's first one, or a
  // load at a warp's last lane
  int64_t next = __shfl_down_sync(kFullMask, k[0], 1);
  if (lane == 31 && g0 + kPer < n) next = __ldg(keys + g0 + kPer);
  unsigned ends = 0;  // bit j: position g0 + j ends a run
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t after = j == kPer - 1 ? next : k[j + 1];
    if (g0 + j < n && (g0 + j == n - 1 || k[j] != after)) ends |= 1u << j;
  }
  if (threadIdx.x >= kThreads - 32) {
    // the end of the run that holds keys[hi-1], where it goes on later
    const int64_t last = __shfl_sync(kFullMask, k[kPer - 1], 31);
    const int64_t after = __shfl_sync(kFullMask, next, 31);
    int carry = MinOp::identity();
    if (hi < n && last == after)
      carry = static_cast<int>(
          run_edge(keys, hi, 1, n - 1 - hi, last, lane));
    if (lane == 31) tile_carry = carry;
  }
  const int agg = ends ? static_cast<int>(g0) + __ffs(ends) - 1
                       : MinOp::identity();
  // the scan's barriers order the last warp's write of tile_carry before
  // the read
  const int scanned = block_exclusive<MinOp, true>(agg);
  int run = MinOp::apply(scanned, tile_carry);
  int o[kPer];
#pragma unroll
  for (int j = kPer - 1; j >= 0; --j) {
    if ((ends >> j) & 1u) run = static_cast<int>(g0) + j;
    o[j] = run;
  }
  store_chunk(out, g0, n, o);
}

}  // namespace

extern "C" {

// Keys per tile, for tests of ragged lengths around it.
int shk_run_scan_tile() { return kTile; }

int shk_run_ends(const int64_t* keys, int* out, int64_t n,
                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  run_ends_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      keys, out, n);
  return static_cast<int>(cudaGetLastError());
}

int shk_run_starts(const int64_t* keys, int* out, int64_t n,
                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  run_starts_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      keys, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
