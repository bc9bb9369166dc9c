// Bucket probe of the sPCR reach closure, for Hopper (sm_90a).
//
// For each candidate key c:
//   b      = min(c >> shift, n_lut - 2)        (the LUT bucket of c)
//   out[c] = the largest row i in [lut[b], lut[b + 1]) with keys[i] == c
//            and counts[i] >= min_count, or -1 when there is none or c is
//            the sentinel (INT64_MAX).
// keys: one partition's sorted int64 keys (sentinel tail); counts: its int64
// counts; lut: the bucket LUT of ops/reach.build_sidecar (int32, 2^bits + 1
// row offsets).
//
// It replaces the Pallas TPU kernel sharkmer_tpu/ops/pallas_kernels.py
// probe_rows (_gather_windows_kernel), the table probe of every BFS level of
// a reach closure. The TPU kernel DMAs a fixed 16 x 64-row window of a
// count-packed u32 hi/lo "probe plane" per candidate and compares in XLA;
// the plane, its 8-aligned windows, the u32 halves and the 128-candidate
// chunks are Mosaic constraints and none of them carries over. Here:
//   * one warp per candidate: the warp reads the candidate's two LUT
//     entries, then its bucket rows [s, e) straight from the partition's
//     key and count arrays, 32 rows per step (a coalesced 256 B load of
//     each), compares the full key and the count, and takes the max
//     matching row with one warp reduction;
//   * no probe plane (the JAX sidecar's +8 B per row goes away) and no
//     fixed window: an overfull bucket just takes more steps, so the
//     probe is exact for every k and every min_count.
// Bound: latency of the scattered bucket reads. A bucket holds at most 32
// rows once build_sidecar has sized the LUT, so a candidate costs two
// dependent loads (LUT, then one key/count segment): at the main path's
// 128-2048 candidates a launch is a few microseconds of device time.
//
// Plain C interface, bound with ctypes: the entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launch (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // candidates per block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int64_t kSentinel = INT64_MAX;

__global__ void __launch_bounds__(kThreads)
probe_rows_kernel(const int64_t* __restrict__ keys,
                  const int64_t* __restrict__ counts,
                  const int* __restrict__ lut, int n_lut, int shift,
                  const int64_t* __restrict__ cand, int64_t min_count,
                  int* __restrict__ out, int n_cand) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_cand) return;  // the whole warp leaves together
  const int64_t key = cand[c];
  int best = -1;
  if (key != kSentinel) {
    // unsigned shift: the JAX package's u64 bucket arithmetic
    const uint64_t bucket = static_cast<uint64_t>(key) >> shift;
    const uint64_t last = static_cast<uint64_t>(n_lut - 2);
    const int b = static_cast<int>(bucket < last ? bucket : last);
    const int s = lut[b];
    const int e = lut[b + 1];
    // each lane visits ascending rows, so its last match is its largest
    for (int i = s + lane; i < e; i += 32) {
      if (keys[i] == key && counts[i] >= min_count) best = i;
    }
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0) out[c] = best;
}

}  // namespace

extern "C" {

int shk_probe_rows(const int64_t* keys, const int64_t* counts, const int* lut,
                   int n_lut, int shift, const int64_t* cand,
                   int64_t min_count, int* out, int n_cand,
                   cudaStream_t stream) {
  if (n_cand <= 0) return 0;
  const int blocks = (n_cand + kWarps - 1) / kWarps;
  probe_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, counts, lut, n_lut, shift, cand, min_count, out, n_cand);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
