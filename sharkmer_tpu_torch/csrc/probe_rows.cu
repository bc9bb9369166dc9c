// Bucket probe of the sPCR reach closure over a partitioned table, for
// Hopper (sm_90a).
//
// For each candidate key c: route c to the partition whose key range holds
// it (the last one whose first key is <= c), then, with that partition's
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
// chunks are Mosaic constraints and none of them carries over. Here:
//   * one warp per candidate (probe_rows.cuh, shared with the fused closure
//     in reach_closure.cu): the warp routes the candidate, reads its two LUT
//     entries, then its bucket rows [s, e) straight from the partition's key
//     and count arrays, 32 rows per step (a coalesced 256 B load of each),
//     compares the full key and the count, and takes the max matching row
//     with one warp reduction;
//   * no probe plane (the JAX sidecar's +8 B per row goes away) and no
//     fixed window: an overfull bucket just takes more steps, so the
//     probe is exact for every k and every min_count.
// Bound: latency of the scattered bucket reads. A bucket holds at most 32
// rows once build_sidecar has sized the LUT, so a candidate costs its route
// (cached descriptor loads), then two dependent loads (LUT, then one
// key/count segment).
//
// Plain C interface, bound with ctypes: the entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

#include "probe_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // candidates per block

__global__ void __launch_bounds__(kThreads)
probe_rows_kernel(const shk::PartDesc* __restrict__ parts, int n_parts,
                  const int64_t* __restrict__ cand, int64_t min_count,
                  int* __restrict__ out, int n_cand) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_cand) return;  // the whole warp leaves together
  const int64_t key = cand[c];
  const shk::PartDesc& p = parts[shk::route_part(parts, n_parts, key)];
  const int best = shk::group_max<32>(shk::probe_lane<32>(
      p.keys, p.counts, p.lut, p.n_lut, p.shift, key, min_count, lane));
  if (lane == 0) out[c] = best >= 0 ? p.base + best : shk::kInf;
}

}  // namespace

extern "C" {

int shk_probe_rows(const void* parts, int n_parts, const int64_t* cand,
                   int64_t min_count, int* out, int n_cand,
                   cudaStream_t stream) {
  if (n_cand <= 0) return 0;
  const int blocks = (n_cand + kWarps - 1) / kWarps;
  probe_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const shk::PartDesc*>(parts), n_parts, cand, min_count,
      out, n_cand);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
