// Segmented run scans over a sorted int64 key array, for Hopper (sm_90a).
//
// run_ends:   out[i] = position of the LAST element of i's equal-key run
// run_starts: out[i] = position of the FIRST element of i's equal-key run
//
// They replace the Pallas TPU kernels sharkmer_tpu/ops/pallas_kernels.py
// run_ends (_run_end_kernel) and run_starts (_run_start_kernel), which the
// sorted store's drains use to turn a sorted key buffer into run totals.
//
// Bound: device memory bandwidth. Each element is read once (8 B key; the
// neighbour's load hits L1) and its position written once (4 B), so at
// 3.35 TB/s a 2^27-element array costs about 0.5 ms at best. The design is
// the plain three-pass tiled scan, which moves each element 20 B in all:
//   1. one block per tile of kThreads elements, one element per thread
//      (coalesced loads): mark run ends (starts), take the block-local
//      suffix min (prefix max) with warp shuffles plus one shared-memory
//      step, write the local result and the tile's aggregate;
//   2. one block scans the tile aggregates in place (exclusive, in the
//      scan's direction): the carry each tile gets from the tiles after
//      (before) it;
//   3. out[i] = op(out[i], carry[tile(i)]).
// None of the TPU kernel's workarounds carry over (u32 hi/lo planes,
// [R, 512] lane shifts, 8-row boundary blocks). A single pass with
// decoupled look-back would save passes 2 and 3.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launches (0 = success).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // elements per tile = threads per block
constexpr int kWarps = kThreads / 32;
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
// (kReverse: from the last thread back). *total receives op over the whole
// block. Every thread of the block must call it.
template <class Op, bool kReverse>
__device__ __forceinline__ int block_exclusive(int x, int* total) {
  __shared__ int warp_agg[kWarps];
  __shared__ int warp_carry[kWarps];
  __shared__ int block_total;
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
    if (lane == (kReverse ? 0 : 31)) block_total = wi;
  }
  __syncthreads();
  *total = block_total;
  return Op::apply(excl, warp_carry[warp]);
}

// Pass 1 of run_ends: tile-local suffix min of (is run end ? pos : INT_MAX).
__global__ void __launch_bounds__(kThreads)
run_ends_tiles(const int64_t* __restrict__ keys, int* __restrict__ out,
               int* __restrict__ tile_agg, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int v = INT_MAX;
  if (i < n) {
    const bool last = (i == n - 1) || keys[i] != keys[i + 1];
    v = last ? static_cast<int>(i) : INT_MAX;
  }
  int total;
  const int later = block_exclusive<MinOp, true>(v, &total);
  if (i < n) out[i] = MinOp::apply(v, later);
  if (threadIdx.x == 0) tile_agg[blockIdx.x] = total;
}

// Pass 1 of run_starts: tile-local prefix max of (is run start ? pos : -1).
__global__ void __launch_bounds__(kThreads)
run_starts_tiles(const int64_t* __restrict__ keys, int* __restrict__ out,
                 int* __restrict__ tile_agg, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int v = -1;
  if (i < n) {
    const bool first = (i == 0) || keys[i] != keys[i - 1];
    v = first ? static_cast<int>(i) : -1;
  }
  int total;
  const int earlier = block_exclusive<MaxOp, false>(v, &total);
  if (i < n) out[i] = MaxOp::apply(v, earlier);
  if (threadIdx.x == 0) tile_agg[blockIdx.x] = total;
}

// Pass 2: one block turns the tile aggregates, in place, into each tile's
// exclusive carry (op over the tiles after it for kReverse, before it
// otherwise). Each thread owns a contiguous chunk of tiles.
template <class Op, bool kReverse>
__global__ void __launch_bounds__(kThreads)
scan_tiles(int* __restrict__ agg, int n_tiles) {
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int acc = Op::identity();
  for (int t = lo; t < hi; ++t) acc = Op::apply(acc, agg[t]);
  int total;
  int carry = block_exclusive<Op, kReverse>(acc, &total);
  if (kReverse) {
    for (int t = hi - 1; t >= lo; --t) {
      const int a = agg[t];
      agg[t] = carry;
      carry = Op::apply(carry, a);
    }
  } else {
    for (int t = lo; t < hi; ++t) {
      const int a = agg[t];
      agg[t] = carry;
      carry = Op::apply(carry, a);
    }
  }
}

// Pass 3: fold each tile's carry into its elements.
template <class Op>
__global__ void __launch_bounds__(kThreads)
apply_carry(int* __restrict__ out, const int* __restrict__ carry, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = Op::apply(out[i], carry[blockIdx.x]);
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper sizes tile_agg as ceil(n / tile) ints.
int shk_run_scan_tile() { return kThreads; }

int shk_run_ends(const int64_t* keys, int* out, int* tile_agg, int n,
                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int tiles = (n + kThreads - 1) / kThreads;
  run_ends_tiles<<<tiles, kThreads, 0, stream>>>(keys, out, tile_agg, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles<MinOp, true><<<1, kThreads, 0, stream>>>(tile_agg, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_carry<MinOp><<<tiles, kThreads, 0, stream>>>(out, tile_agg, n);
  return static_cast<int>(cudaGetLastError());
}

int shk_run_starts(const int64_t* keys, int* out, int* tile_agg, int n,
                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const int tiles = (n + kThreads - 1) / kThreads;
  run_starts_tiles<<<tiles, kThreads, 0, stream>>>(keys, out, tile_agg, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles<MaxOp, false><<<1, kThreads, 0, stream>>>(tile_agg, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_carry<MaxOp><<<tiles, kThreads, 0, stream>>>(out, tile_agg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
