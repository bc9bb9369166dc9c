// Canonical k-mer encode of a code batch, with its valid-window and
// valid-base totals, for Hopper (sm_90a).
//
// codes [n, width] uint8, row-major and contiguous (0-3 the bases A C G T,
// 4 N, 5 pad); keys [n, w] int64, w = width - k + 1, 1 <= k <= 31:
//   keys[r][j] = min(fwd, revcomp) of codes[r][j .. j + k - 1], where fwd
//                holds base j + i at bit 2 (k - 1 - i) and revcomp the
//                complemented base j + i at bit 2 i; SENTINEL (2^63 - 1)
//                where the window holds a code >= 4;
//   totals[0] += the windows that hold no code >= 4 (the k-mers),
//   totals[1] += the codes < 4 of every column of every row (the valid
//                bases), where totals is given (it may be null).
// A batch narrower than k writes no key and still adds its bases.
//
// It replaces no TPU kernel: the JAX package's canonical_kmers
// (sharkmer_tpu/ops/encoding.py:88) is one jitted XLA function, which the
// port had written as eager PyTorch, about eight elementwise passes over
// int64 windows for each of the k bases. Its bound is device memory: one
// byte read a code and eight written a key, so [131072, 160] at k = 19
// reads 21.0 MB and writes 148.9 MB, 0.051 ms at 3.35 TB/s.
//
// Design. The rows are cut into segments: a whole row where the width is
// at most the wrapper's BUDGET codes (a block stages as many rows as fit),
// else tiles of LONG_TILE windows, which overlap by k - 1 codes (a block a
// tile). Each segment's keys, and so each block's, are contiguous in the
// output.
//   1. Stage: each thread reads 16 codes of a segment (one 16 B load where
//      they lie whole and aligned, else bytes) into one word of 2-bit bases
//      and one of "bad" bits (a code >= 4), both first code highest, in
//      shared memory; it counts the codes < 4 of the segment's own columns
//      (a tile's own are its windows' first columns, the last tile's run to
//      the row's end), so each column counts once.
//   2. Keys: consecutive threads take consecutive windows (coalesced 8 B
//      stores). A window is three words away at most: a funnel shift gives
//      its 2k bits at the top of a 64-bit word, so the forward key is one
//      shift, and the reverse complement is a bit reverse of the
//      complement with each 2-bit pair swapped back; the bad bits of the
//      same three words say whether the window holds a code >= 4. The work
//      per key does not grow with k.
//   3. A block's two counts go through warp shuffles and shared memory,
//      then into totals with one 64-bit atomic each: integer sums, so the
//      order of the blocks does not matter.
//
// Plain C interface, bound with ctypes: the entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launch (0 = success). The segment plan
// (tile, n_tiles, segments a block, words a segment) comes from the
// wrapper, kernels/encode.py, which the CPU tests hold to the kernel's
// indexing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSentinel = INT64_MAX;
constexpr uint64_t kPairLow = 0x5555555555555555ull;

__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ codes, int64_t* __restrict__ keys,
              unsigned long long* __restrict__ totals, int64_t n_rows,
              int width, int k, int tile, int n_tiles, int seg_per_block,
              int slot_words) {
  extern __shared__ uint32_t smem[];
  uint32_t* packed = smem;  // 2-bit bases, code m of a word at bit 30 - 2m
  uint32_t* bad = smem + seg_per_block * slot_words;  // code m at bit 15 - m
  __shared__ unsigned long long sums[2];
  if (threadIdx.x == 0) {
    sums[0] = 0;
    sums[1] = 0;
  }
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * seg_per_block;
  const int64_t n_segs = n_rows * n_tiles;
  const int n_here = static_cast<int>(
      s0 + seg_per_block <= n_segs ? seg_per_block : n_segs - s0);

  // 1. stage the block's segments, counting their own valid bases
  unsigned long long n_bases = 0;
  for (int g = threadIdx.x; g < n_here * slot_words; g += kThreads) {
    const int i = g / slot_words;
    const int first = (g - i * slot_words) * 16;
    const int64_t s = s0 + i;
    const int64_t row = s / n_tiles;
    const int t = static_cast<int>(s - row * n_tiles);
    const int c0 = t * tile;  // the segment's first column
    // the segment's codes: its windows and their k - 1 tail, to the row's
    // end at most
    const int seg_codes =
        tile + k - 1 < width - c0 ? tile + k - 1 : width - c0;
    const int own = t == n_tiles - 1 ? width - c0 : tile;
    const int left = seg_codes - first;  // the segment's codes from here on
    const uint8_t* src = codes + row * width + c0 + first;
    uint32_t p = 0, b = 0;
    if (left >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      const uint32_t parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t c = (parts[q] >> (8 * e)) & 0xFFu;
          const int m = 4 * q + e;
          p |= (c & 3u) << (30 - 2 * m);
          b |= static_cast<uint32_t>(c >= 4u) << (15 - m);
        }
      }
    } else {
      for (int m = 0; m < 16; ++m) {
        uint32_t c = 4u;  // past the segment: bad
        if (m < left) c = src[m];
        p |= (c & 3u) << (30 - 2 * m);
        b |= static_cast<uint32_t>(c >= 4u) << (15 - m);
      }
    }
    packed[g] = p;
    bad[g] = b;
    // the word's own columns, its first own_n codes
    const int own_n = own - first <= 0 ? 0 : own - first >= 16 ? 16
                                                               : own - first;
    n_bases += __popc(~b & ((0xFFFFu << (16 - own_n)) & 0xFFFFu));
  }
  __syncthreads();  // also orders sums[] zeroed before any add

  // 2. the keys: the block's are contiguous from segment s0's first
  unsigned long long n_kmers = 0;
  if (tile > 0) {
    const int w = width - k + 1;
    const int64_t row0 = s0 / n_tiles;
    const int t0 = static_cast<int>(s0 - row0 * n_tiles);
    // several segments a block only where each is a whole row
    const int rest = w - t0 * tile;
    const int n_out = seg_per_block > 1 ? n_here * tile
                                        : rest < tile ? rest : tile;
    int64_t* out = keys + row0 * w + static_cast<int64_t>(t0) * tile;
    const int fwd_shift = 64 - 2 * k;
    const uint64_t mask = (1ull << (2 * k)) - 1;
    const int di = kThreads / tile, dj = kThreads - di * tile;
    int i = threadIdx.x / tile, j = threadIdx.x - i * tile;
    for (int o = threadIdx.x; o < n_out; o += kThreads) {
      const int word = i * slot_words + (j >> 4);
      const int off = j & 15;
      const uint32_t p0 = packed[word], p1 = packed[word + 1],
                     p2 = packed[word + 2];
      const uint64_t x =
          (static_cast<uint64_t>(__funnelshift_l(p1, p0, 2 * off)) << 32) |
          __funnelshift_l(p2, p1, 2 * off);
      const uint64_t v = (static_cast<uint64_t>(bad[word]) << 48) |
                         (static_cast<uint64_t>(bad[word + 1]) << 32) |
                         (static_cast<uint64_t>(bad[word + 2]) << 16);
      const bool ok = ((v << off) >> (64 - k)) == 0;
      const uint64_t fwd = x >> fwd_shift;
      uint64_t r = __brevll(~x);
      r = ((r >> 1) & kPairLow) | ((r & kPairLow) << 1);
      const uint64_t rev = r & mask;
      out[o] = ok ? static_cast<int64_t>(fwd < rev ? fwd : rev) : kSentinel;
      n_kmers += ok;
      i += di;
      j += dj;
      if (j >= tile) {
        j -= tile;
        ++i;
      }
    }
  }

  // 3. one atomic a block for each total
  if (totals == nullptr) return;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    n_kmers += __shfl_down_sync(0xFFFFFFFFu, n_kmers, d);
    n_bases += __shfl_down_sync(0xFFFFFFFFu, n_bases, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sums[0], n_kmers);
    atomicAdd(&sums[1], n_bases);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sums[0]) atomicAdd(&totals[0], sums[0]);
    if (sums[1]) atomicAdd(&totals[1], sums[1]);
  }
}

}  // namespace

extern "C" {

int shk_encode(const uint8_t* codes, int64_t* keys, int64_t* totals,
               int64_t n_rows, int width, int k, int tile, int n_tiles,
               int seg_per_block, int slot_words, cudaStream_t stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  const int64_t n_segs = n_rows * n_tiles;
  const int64_t blocks = (n_segs + seg_per_block - 1) / seg_per_block;
  const size_t smem =
      2 * static_cast<size_t>(seg_per_block) * slot_words * sizeof(uint32_t);
  encode_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      codes, keys, reinterpret_cast<unsigned long long*>(totals), n_rows,
      width, k, tile, n_tiles, seg_per_block, slot_words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
