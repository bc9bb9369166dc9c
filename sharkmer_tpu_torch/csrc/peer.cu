// Peer access between two cards: lets the current card's kernels load from
// another card's memory through plain device pointers (over NVLink on an
// H100 host). The reach closure, probe_rows and the pointer-table
// hash_lookup read shards that live on other cards this way
// (kernels/peer.py).
//
// Plain C interface, bound with ctypes; no kernel here.

#include <cuda_runtime.h>

extern "C" {

// Enable the current card's access to `peer`'s memory. Returns 0 on success,
// also when the access was already enabled (torch's cross-card copies may
// have done it), else the cudaError. The already-enabled error is cleared so
// that the next launch's cudaGetLastError() does not report it.
int shk_enable_peer_access(int peer) {
  const cudaError_t rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(rc);
}

}  // extern "C"
