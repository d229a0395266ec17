// Launch-floor probe for Hopper: out = a ^ 1, one launch that does no work
// worth the name.
//
// Replaces the TPU probe scripts/bench_launch_floor.py:_copy_kernel
// (tiny_call: a (256, 128) u32 pass-through on a (1, 1) grid, that chip's way
// to say "one launch, next to no work").  Here the 128 KB in and 128 KB out
// are spread over many blocks with 16-byte accesses, one vector a thread, so
// that no single SM's bandwidth is what the probe times: a chain of these
// launches prices what ONE launch costs on this card, the floor under the
// ~400 launches of a solve and the yardstick for the scan's microseconds per
// step.  Bound: neither bytes nor operations, the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbeMaxBlocks = 1056;  // 8 blocks an SM on 132 SMs; past that a thread strides

// Words [0, 4 * nvec) as 16-byte vectors, one a thread at the probe's size;
// the n % 4 words after them (and every word, when a pointer is not 16-byte
// aligned and nvec is 0) one by one in block 0.
__global__ void __launch_bounds__(kProbeThreads)
launch_probe_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a, int n,
                    int nvec) {
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int i = blockIdx.x * kProbeThreads + threadIdx.x; i < nvec;
       i += gridDim.x * kProbeThreads) {
    uint4 v = a4[i];
    v.x ^= 1u;
    v.y ^= 1u;
    v.z ^= 1u;
    v.w ^= 1u;
    out4[i] = v;
  }
  if (blockIdx.x == 0)
    for (int i = 4 * nvec + threadIdx.x; i < n; i += kProbeThreads) out[i] = a[i] ^ 1u;
}

}  // namespace

extern "C" int gf2_launch_probe(uint32_t* out, const uint32_t* a, int n,
                                cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(a)) & 15u) == 0;
  const int nvec = aligned ? n / 4 : 0;
  int blocks = (nvec + kProbeThreads - 1) / kProbeThreads;
  blocks = blocks < 1 ? 1 : (blocks > kProbeMaxBlocks ? kProbeMaxBlocks : blocks);
  launch_probe_kernel<<<blocks, kProbeThreads, 0, stream>>>(out, a, n, nvec);
  return (int)cudaGetLastError();
}
