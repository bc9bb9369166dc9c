// Row stitch of drain v2, for Hopper (sm_90a).
//
// rows [R, W] int64, each row's survivors compacted to its front; offs [R]
// int32, the exclusive prefix sum of the rows' kept lengths. Then, with
// len_r = offs[r + 1] - offs[r] for r < R - 1 and len_{R-1} = W:
//   out[offs[r] + j] = rows[r][j]   for j < len_r,
//   out[i]           = fill         for offs[R - 1] + W <= i < R * W.
// Kept lengths must not exceed W, so the row copies tile
// [0, offs[R - 1] + W) without a gap or an overlap.
//
// It replaces the Pallas TPU kernel sharkmer_tpu/ops/pallas_kernels.py
// stitch_rows (_stitch_call, _make_stitch_kernel), the compaction step of
// the sorted store's drain v2. The TPU kernel issues one full-row DMA per
// row, in row order, so that each row overwrites the sentinel tail of the
// row before; the ordered DMAs, the 1024-element offset alignment they need
// and the split of u64 rows into two u32 planes are DMA constraints and do
// not carry over. Here every element is copied exactly once, in any order:
//   * stitch_copy: a 2-D grid, blockIdx.y the row, the x blocks striding
//     over the row's first len_r elements (coalesced 8 B loads and stores);
//   * stitch_fill: a grid-stride fill of the tail behind the last row.
// Bound: device memory bandwidth, 8 B read and 8 B written per kept
// element plus 8 B written per filled one: 2^27 elements move 2 GiB, about
// 0.6 ms at 3.35 TB/s.
//
// Plain C interface, bound with ctypes: the entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launches (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // row elements per thread of a copy block
constexpr int kFillBlocks = 132 * 8;

__global__ void __launch_bounds__(kThreads)
stitch_copy(const int64_t* __restrict__ rows, const int* __restrict__ offs,
            int64_t* __restrict__ out, int n_rows, int width) {
  const int r = blockIdx.y;
  const int64_t off = offs[r];
  const int len = r + 1 < n_rows ? offs[r + 1] - offs[r] : width;
  const int64_t* src = rows + static_cast<int64_t>(r) * width;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < len;
       j += gridDim.x * kThreads) {
    out[off + j] = src[j];
  }
}

__global__ void __launch_bounds__(kThreads)
stitch_fill(const int* __restrict__ offs, int64_t* __restrict__ out,
            int64_t fill, int n_rows, int width, int64_t total) {
  const int64_t start = static_cast<int64_t>(offs[n_rows - 1]) + width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = start + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < total; i += stride) {
    out[i] = fill;
  }
}

}  // namespace

extern "C" {

int shk_stitch_rows(const int64_t* rows, const int* offs, int64_t* out,
                    int64_t fill, int n_rows, int width, cudaStream_t stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  const int per_block = kThreads * kPerThread;
  dim3 grid((width + per_block - 1) / per_block, n_rows);
  stitch_copy<<<grid, kThreads, 0, stream>>>(rows, offs, out, n_rows, width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(n_rows) * width;
  stitch_fill<<<kFillBlocks, kThreads, 0, stream>>>(offs, out, fill, n_rows,
                                                     width, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
