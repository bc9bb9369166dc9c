// The bucket probe of the sPCR reach closure, shared by probe_rows.cu (one
// probe launch) and reach_closure.cu (the probe inside every BFS level of a
// closure), so the two probes cannot drift apart.
//
// A partition is a sorted run of int64 keys (sentinel INT64_MAX tail) with
// int64 counts and the bucket LUT of ops/reach.build_sidecar: lut[b] (int32,
// b in [0, n_lut)) is the first row whose key >> shift is >= b. A key's rows
// lie in [lut[b], lut[b + 1]) with b = min(key >> shift, n_lut - 2).
//
// A G-lane group of a warp probes one key: lane j scans rows s + j, s + j + G,
// ... of the bucket, and the group takes the largest matching row. G = 32
// reads a 32-row bucket as one coalesced 256 B segment; a smaller G probes
// 32 / G keys per warp at once.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace shk {

constexpr int64_t kSentinel = INT64_MAX;
constexpr int kInf = 0x7fffffff;  // "no row" in global row ids
constexpr unsigned kFullMask = 0xffffffffu;

// One partition of the table, as the Python side packs it: six int64 words
// per partition (kernels/probe.py PartTable.desc).
struct PartDesc {
  const int64_t* keys;
  const int64_t* counts;
  const int* lut;
  int64_t first_key;  // lower bound of the key range (partition 0: unused)
  int n_lut;
  int shift;
  int base;  // global row id of the partition's row 0
  int pad;
};
static_assert(sizeof(PartDesc) == 48, "PartDesc is six int64 words");

// The lane's largest row of `key` in its bucket with count >= min_count, or
// -1 (also for the sentinel). Combine a group's lanes with group_max<G>.
template <int G>
__device__ __forceinline__ int probe_lane(const int64_t* __restrict__ keys,
                                          const int64_t* __restrict__ counts,
                                          const int* __restrict__ lut,
                                          int n_lut, int shift, int64_t key,
                                          int64_t min_count, int lane) {
  int best = -1;
  if (key != kSentinel) {
    // unsigned shift: the JAX package's u64 bucket arithmetic
    const uint64_t bucket = static_cast<uint64_t>(key) >> shift;
    const uint64_t last = static_cast<uint64_t>(n_lut - 2);
    const int b = static_cast<int>(bucket < last ? bucket : last);
    const int s = lut[b];
    const int e = lut[b + 1];
    // each lane visits ascending rows, so its last match is its largest
    for (int i = s + lane; i < e; i += G) {
      if (keys[i] == key && counts[i] >= min_count) best = i;
    }
  }
  return best;
}

// The max over each G-lane group of the warp; every lane of the warp calls
// it together, and each lane gets its group's max.
template <int G>
__device__ __forceinline__ int group_max(int v) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 1, 2, ..., 32");
  if constexpr (G == 32) {
    return __reduce_max_sync(kFullMask, v);
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      v = max(v, __shfl_xor_sync(kFullMask, v, off, G));
    }
    return v;
  }
}

// The partition whose key range holds `key`: the last one whose first key is
// <= key (partition 0 takes every smaller key). Global row ids follow
// partition key order, so this is the only partition that can hold it.
__device__ __forceinline__ int route_part(const PartDesc* __restrict__ parts,
                                          int n_parts, int64_t key) {
  int lo = 0, hi = n_parts - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (parts[mid].first_key <= key) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

}  // namespace shk
