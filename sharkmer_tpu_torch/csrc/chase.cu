// Dependent-load latency of the card, for the latency bounds that
// chip_smoke.py states beside the byte bounds of the kernels whose work is a
// chain of dependent loads (probe_rows, reach_closure). Not on the program's
// path.
//
// One thread follows a ring of int32 indices, j = next[j], `steps` times,
// each load through L2 only (ld.global.cg: the closure's scattered probes
// miss the SM's L1 anyway), and writes where it ended, so the loads are not
// dead. The caller times the launch with CUDA events and divides by `steps`;
// the ring's footprint decides where the loads are served: a ring of a few
// MB that one walk has loaded hits L2 (50 MB), a ring far past it goes to
// DRAM. shk_atomic_chase walks the same kind of ring with a returning
// atomicOr at each step instead of a load: the latency of a claim on the
// closure's visited bitmap (tools/closure_stages.py).
//
// Plain C interface, bound with ctypes: launches on the given stream, does
// not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start,
                             int steps, int* __restrict__ out) {
  int j = start;
  for (int s = 0; s < steps; ++s) j = __ldcg(next + j);
  *out = j;
}

__global__ void atomic_chase_kernel(unsigned* ring, int start, int steps,
                                    int* out) {
  unsigned j = start;
  for (int s = 0; s < steps; ++s) j = atomicOr(ring + j, 0u);
  *out = static_cast<int>(j);
}

}  // namespace

extern "C" int shk_chase(const int* next, int start, int steps, int* out,
                         cudaStream_t stream) {
  chase_kernel<<<1, 1, 0, stream>>>(next, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shk_atomic_chase(unsigned* ring, int start, int steps,
                                int* out, cudaStream_t stream) {
  atomic_chase_kernel<<<1, 1, 0, stream>>>(ring, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}
