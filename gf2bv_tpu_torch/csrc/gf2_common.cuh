// Shared declarations of the gf2bv_tpu_torch Hopper kernels.
//
// Layout (same as the JAX package, gf2bv_tpu/core/packing.py): a packed row
// is an array of 32-bit words, bit j of the row at word j >> 5, bit j & 31;
// bit 0 is the affine term.  Matrices are row-major and contiguous.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gf2 {

__device__ __forceinline__ uint4 xor4(uint4 x, uint4 y) {
  return make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}

// A quad from lane src of the warp.
__device__ __forceinline__ uint4 shfl4(const uint4 r, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, r.x, src), __shfl_sync(0xffffffffu, r.y, src),
                    __shfl_sync(0xffffffffu, r.z, src), __shfl_sync(0xffffffffu, r.w, src));
}

// Word c (0..3) of a quad.
__device__ __forceinline__ uint32_t word_of(const uint4 r, int c) {
  return c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w;
}

// The SMs of the current device, asked once (the port drives one device per
// process).
inline cudaError_t sm_count(int* nsm) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, n = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    cached = n;
  }
  *nsm = cached;
  return cudaSuccess;
}

}  // namespace gf2

// a[i] ^= XOR_{t : bit t of sel[i]} pf[t] (GF(2) rank-K update) in place on
// the words {0 if const_word} U [word_lo, wp), through Four-Russians XOR tables
// in shared memory; words outside that set are neither read nor written.
// Defined in update_table.cu; the panel updates of the solver go through it.
cudaError_t launch_table_update(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                                int wp, int kw, int word_lo, int const_word,
                                cudaStream_t stream);

// The pure product out = S . PF on every word through the same tables, out
// written and never read, over `batch` independent problems in ONE launch
// (gridDim.z = batch): problem b writes out at b*mat_stride and reads sel at
// b*sel_stride and pf at b*pf_stride words.  The strides are whole rows, so
// every problem is aligned as the first.  Defined in update_table.cu; the
// pivot-row rebuilds (reconstruct.cu) form pf = T . arows with it.
cudaError_t launch_table_product(uint32_t* out, const uint32_t* sel, const uint32_t* pf,
                                 int rows, int wp, int kw, int batch, size_t mat_stride,
                                 size_t sel_stride, size_t pf_stride, cudaStream_t stream);
