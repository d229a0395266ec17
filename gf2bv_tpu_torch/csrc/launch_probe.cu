// Launch-floor probe for Hopper: out = a ^ 1 on one block.
//
// Replaces the TPU probe scripts/bench_launch_floor.py:_copy_kernel
// (tiny_call: a (256, 128) u32 pass-through on a (1, 1) grid).  It does no
// work worth the name (128 KB read, 128 KB written by one block), so a chain
// of these launches prices what ONE launch costs on this card: the floor
// under the ~400 launches of a solve, and the yardstick for the scan's
// microseconds per step.  Bound: neither bytes nor operations, the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 1024;

__global__ void __launch_bounds__(kProbeThreads)
launch_probe_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a, int n) {
  for (int i = threadIdx.x; i < n; i += kProbeThreads) out[i] = a[i] ^ 1u;
}

}  // namespace

extern "C" int gf2_launch_probe(uint32_t* out, const uint32_t* a, int n,
                                cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  launch_probe_kernel<<<1, kProbeThreads, 0, stream>>>(out, a, n);
  return (int)cudaGetLastError();
}
