// Shared declarations of the gf2bv_tpu_torch Hopper kernels.
//
// Layout (same as the JAX package, gf2bv_tpu/core/packing.py): a packed row
// is an array of 32-bit words, bit j of the row at word j >> 5, bit j & 31;
// bit 0 is the affine term.  Matrices are row-major and contiguous.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// out[i] = (a ? a[i] : 0) ^ XOR_{t : bit t of sel[i]} pf[t]  (GF(2) rank-K
// product), restricted to words {0 if const_word} U [word_lo, wp).
// Words outside that set are neither read nor written.  out may equal a
// (in-place update); a may be null (pure product, out fully written on the
// selected words).  Defined in panel_update.cu.
cudaError_t launch_rank_k(uint32_t* out, const uint32_t* a, const uint32_t* sel,
                          const uint32_t* pf, int rows, int wp, int kw,
                          int word_lo, int const_word, cudaStream_t stream);

// The same product over `batch` independent problems in ONE launch
// (gridDim.z = batch): problem b reads and writes out/a at b*mat_stride,
// sel at b*sel_stride and pf at b*pf_stride words.
cudaError_t launch_rank_k_batched(uint32_t* out, const uint32_t* a, const uint32_t* sel,
                                  const uint32_t* pf, int rows, int wp, int kw,
                                  int word_lo, int const_word, int batch,
                                  size_t mat_stride, size_t sel_stride,
                                  size_t pf_stride, cudaStream_t stream);
