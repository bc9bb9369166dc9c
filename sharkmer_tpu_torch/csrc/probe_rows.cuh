// The bucket probe of the sPCR reach closure, shared by probe_rows.cu (one
// probe launch) and reach_closure.cu (the probe inside every BFS level of a
// closure), so the two probes cannot drift apart.
//
// A partition is a sorted run of int64 keys (sentinel INT64_MAX tail) with
// int64 counts and the bucket LUT of ops/reach.build_sidecar: lut[b] (int32,
// b in [0, n_lut)) is the first row whose key >> shift is >= b. A key's rows
// lie in [lut[b], lut[b + 1]) with b = min(key >> shift, n_lut - 2).
//
// A G-lane group of a warp probes one key in two dependent loads, each one
// memory round trip: the bucket's two LUT words (one 8 B load where they
// are aligned), then every row of the bucket at once. build_sidecar keeps a
// bucket to at most kBucketRows = 32 rows (ops/reach.py BLOCK) unless its
// LUT reached its bits cap, so lane j loads rows s + j, s + j + G, ... of
// the first 32, keys and counts together, as predicated loads unrolled at
// compile time: no load waits on a compare. A bucket past 32 rows (only at
// the bits cap) takes the rest in a loop after them, so the probe stays
// exact for every k. The group then takes the largest matching row. G = 32
// reads a 32-row bucket as one coalesced 256 B segment of keys and one of
// counts; a smaller G probes 32 / G keys per warp at once.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "mix64.cuh"

namespace shk {

constexpr int64_t kSentinel = INT64_MAX;
constexpr int kInf = 0x7fffffff;  // "no row" in global row ids
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBucketRows = 32;  // ops/reach.py BLOCK

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

// The bucket [s, e) of `key`: lut[b] and lut[b + 1] in one 8 B load where
// lut + b is 8 B aligned, else two loads issued together.
__device__ __forceinline__ void bucket_bounds(const int* __restrict__ lut,
                                              int n_lut, int shift,
                                              int64_t key, int& s, int& e) {
  // unsigned shift: the JAX package's u64 bucket arithmetic
  const uint64_t bucket = static_cast<uint64_t>(key) >> shift;
  const uint64_t last = static_cast<uint64_t>(n_lut - 2);
  const int b = static_cast<int>(bucket < last ? bucket : last);
  if ((reinterpret_cast<uintptr_t>(lut + b) & 7) == 0) {
    const int2 pair = *reinterpret_cast<const int2*>(lut + b);
    s = pair.x;
    e = pair.y;
  } else {
    s = lut[b];
    e = lut[b + 1];
  }
}

// The lane's largest row of `key` in its bucket [s, e) with count >=
// min_count, or -1. Combine a group's lanes with group_max<G>.
template <int G>
__device__ __forceinline__ int probe_bucket(const int64_t* __restrict__ keys,
                                            const int64_t* __restrict__ counts,
                                            int s, int e, int64_t key,
                                            int64_t min_count, int lane) {
  static_assert(kBucketRows % G == 0, "G divides the bucket rows");
  constexpr int kRows = kBucketRows / G;
  int64_t k[kRows];
  int64_t c[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = s + lane + j * G;
    k[j] = r < e ? keys[r] : kSentinel;
    c[j] = r < e ? counts[r] : 0;
  }
  // each lane visits ascending rows, so its last match is its largest
  int best = -1;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (k[j] == key && c[j] >= min_count) best = s + lane + j * G;
  }
#pragma unroll 4
  for (int r = s + kBucketRows + lane; r < e; r += G) {
    if (keys[r] == key && counts[r] >= min_count) best = r;
  }
  return best;
}

// probe_bucket of `key`'s bucket, or -1 for the sentinel.
template <int G>
__device__ __forceinline__ int probe_lane(const int64_t* __restrict__ keys,
                                          const int64_t* __restrict__ counts,
                                          const int* __restrict__ lut,
                                          int n_lut, int shift, int64_t key,
                                          int64_t min_count, int lane) {
  if (key == kSentinel) return -1;
  int s, e;
  bucket_bounds(lut, n_lut, shift, key, s, e);
  return probe_bucket<G>(keys, counts, s, e, key, min_count, lane);
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
// <= key (partition 0 takes every smaller key). In a key-range table this is
// the only partition that can hold it. `parts` may be a shared-memory copy.
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

// The partition that probes `key`. n_shards == 0: a key-range table
// (route_part). n_shards > 0: a sharded table whose partition s is shard s of
// n_shards (== n_parts) and holds exactly the keys that owner() gives s
// (kernels/probe.py PartTable.route). Under owner routing ascending global row
// ids are not ascending keys: ops/reach.py sorts a closure's rows by key.
__device__ __forceinline__ int route(const PartDesc* __restrict__ parts,
                                     int n_parts, int n_shards, int64_t key) {
  return n_shards > 0 ? owner(static_cast<uint64_t>(key), n_shards)
                      : route_part(parts, n_parts, key);
}

}  // namespace shk
