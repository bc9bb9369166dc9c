// Bucket probe of the sPCR reach closure over a partitioned table, for
// Hopper (sm_90a).
//
// For each candidate key c: route c to its partition (probe_rows.cuh route:
// the last one whose first key is <= c, or in a sharded table the shard
// that owns c), then, with that partition's
//   b      = min(c >> shift, n_lut - 2)        (the LUT bucket of c)
//   out[c] = base + the largest row i in [lut[b], lut[b + 1]) with
//            keys[i] == c and counts[i] >= min_count, or INT32_MAX when there
//            is none or c is the sentinel (INT64_MAX).
// A partition (probe_rows.cuh PartDesc, packed by kernels/probe.py
// PartTable.desc) is its sorted int64 keys (sentinel tail), its int64
// counts, the bucket LUT of ops/reach.build_sidecar (int32, 2^bits + 1 row
// offsets), its first key and its global row-id base. The closure's warm
// start probes its keys with one launch for every partition.
//
// It replaces the Pallas TPU kernel sharkmer_tpu/ops/pallas_kernels.py
// probe_rows (_gather_windows_kernel), the table probe of every BFS level of
// a reach closure. The TPU kernel DMAs a fixed 16 x 64-row window of a
// count-packed u32 hi/lo "probe plane" per candidate and compares in XLA;
// the plane, its 8-aligned windows, the u32 halves and the 128-candidate
// chunks are Mosaic constraints and none of them carries over.
//
// Bound: one level of dependent loads, not bytes. The warm start's 4096
// keys read about 0.8 MB, a quarter of a microsecond at the memory rate,
// while each probe is a chain of round trips: its key, its bucket's two
// LUT words, then the bucket rows. A one-level grid cannot hide that chain
// behind other work, so the design shortens the chain and the launch:
//   * the partition descriptors (48 B each) go into shared memory at block
//     start, copied by the whole block while each thread's candidate load
//     is already in flight, and the route (a binary search over the first
//     keys, or the owner's mix64 arithmetic) reads only shared memory: over
//     descriptors in global memory, the search of 21 partitions is about
//     five dependent L2 loads before the LUT load can start. Past
//     kSmemParts descriptors the kernel routes from global memory, as
//     reach_closure.cu does;
//   * an 8-lane group per candidate, four candidates a warp (the closure's
//     kGroup): a bucket holds at most 32 rows below the LUT's bits cap, so
//     each lane loads 4 rows of keys and counts as predicated loads issued
//     together, with no loop, and the group takes the largest matching row
//     (probe_rows.cuh probe_lane<8>, group_max<8>). A bucket past 32 rows,
//     which occurs only at the bits cap, takes the rest in probe_bucket's
//     tail loop, so the probe stays exact;
//   * 256 threads, 32 candidates a block: the warm start's 4096 keys are
//     128 blocks, one wave on the 132 SMs.
// The device code of the probe itself (probe_rows.cuh) is the closure's;
// only the launch, the route's memory and the group width are this file's.
// On the H100 the launch alone (an empty kernel on this grid) takes about
// 0.9 us and one probe level's chain of loads about 0.65 us at best, so
// the kernel cannot come within half of that chain bound.
//
// shk_probe_rows_empty launches an empty kernel on the same grid: the
// floor of a one-level launch, which chip_smoke.py times beside the probe.
//
// Plain C interface, bound with ctypes: the entry points launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() after the launch (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

#include "probe_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                     // lanes per candidate
constexpr int kPerBlock = kThreads / kGroup;  // candidates per block
constexpr int kSmemParts = 256;               // descriptors copied to shared

// The candidate's global row id, or INT32_MAX: route `key` over `parts` (a
// shared-memory copy, or the descriptors in global memory), then probe its
// bucket with the lane's share of the group.
__device__ __forceinline__ int probe_key(const shk::PartDesc* parts,
                                         int n_parts, int n_shards,
                                         int64_t key, int64_t min_count,
                                         int lane) {
  const shk::PartDesc& p = parts[shk::route(parts, n_parts, n_shards, key)];
  const int best = shk::group_max<kGroup>(shk::probe_lane<kGroup>(
      p.keys, p.counts, p.lut, p.n_lut, p.shift, key, min_count, lane));
  return best >= 0 ? p.base + best : shk::kInf;
}

__global__ void __launch_bounds__(kThreads)
probe_rows_kernel(const shk::PartDesc* __restrict__ parts, int n_parts,
                  int n_shards, const int64_t* __restrict__ cand,
                  int64_t min_count, int* __restrict__ out, int n_cand) {
  __shared__ shk::PartDesc parts_s[kSmemParts];
  const int tid = threadIdx.x;
  const int lane = tid % kGroup;
  const int c = blockIdx.x * kPerBlock + tid / kGroup;
  // the candidate's load first, in flight during the descriptor copy; a
  // group past the end probes the sentinel, which loads nothing
  const int64_t key = c < n_cand ? cand[c] : shk::kSentinel;
  const bool in_smem = n_parts <= kSmemParts;
  if (in_smem) {
    for (int j = tid; j < 6 * n_parts; j += kThreads) {
      reinterpret_cast<int64_t*>(parts_s)[j] =
          reinterpret_cast<const int64_t*>(parts)[j];
    }
  }
  __syncthreads();
  // every lane of the warp reaches group_max's full-mask shuffles
  const int id = in_smem
      ? probe_key(parts_s, n_parts, n_shards, key, min_count, lane)
      : probe_key(parts, n_parts, n_shards, key, min_count, lane);
  if (lane == 0 && c < n_cand) out[c] = id;
}

__global__ void __launch_bounds__(kThreads) probe_rows_empty_kernel() {}

int blocks_for(int n_cand) { return (n_cand + kPerBlock - 1) / kPerBlock; }

}  // namespace

extern "C" {

// n_shards: 0 routes by key range, > 0 by owner shard (== n_parts).
int shk_probe_rows(const void* parts, int n_parts, int n_shards,
                   const int64_t* cand, int64_t min_count, int* out,
                   int n_cand, cudaStream_t stream) {
  if (n_cand <= 0) return 0;
  probe_rows_kernel<<<blocks_for(n_cand), kThreads, 0, stream>>>(
      static_cast<const shk::PartDesc*>(parts), n_parts, n_shards, cand,
      min_count, out, n_cand);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on shk_probe_rows' grid for n_cand candidates.
int shk_probe_rows_empty(int n_cand, cudaStream_t stream) {
  if (n_cand <= 0) return 0;
  probe_rows_empty_kernel<<<blocks_for(n_cand), kThreads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
