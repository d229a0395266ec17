// Pivot-row rebuild and back pass of one panel (phase 1, second half).
//
// Replaces gf2bv_tpu/ops/pallas_phase1.py: _make_reconstruct_kernel
// (launched by phase1_reconstruct).  Same contract:
//   in : arows (K, wp) gathered pivot rows, coeff (K, kw) their scan
//        coefficients, prow (K,) (-1 = no pivot), w0 (panel word offset)
//   out: pf (K, wp) = the panel's intra-panel RREF pivot rows, where
//        forward:  pf[j] = arows[j] ^ XOR{pf[t] : coeff bit t}, 0 if no pivot
//        back:     for j descending with a pivot, pf[k] ^= pf[j] for every
//                  k != j below 32*(j/32 + 1) whose bit j (word w0 + j/32)
//                  is set (the reference's triangular window).
//
// What bounds it on the H100: the TPU kernel walks 2K dependent steps over
// full (K, wp) rows.  Both passes are GF(2)-linear row operations, so
// pf = T . arows for a K x K bit matrix T, and every elimination decision
// depends only on the K x kw pivot-column slice (8 KB at K = 256).  The
// design therefore splits the work in two launches:
//   1. one block of K threads (thread k owns row k) runs both passes on
//      [T | slice] rows of 2*kw words in shared memory, one barrier per step
//      (512 steps at K = 256; latency-bound, but on 16 words per row, not
//      640), and writes T;
//   2. pf = T . arows, the same GF(2) rank-K product as the panel update
//      (launch_rank_k in panel_update.cu), parallel over all words.
// The forward pass is run right-looking: when row t is final it is pushed
// into every later row k > t whose coefficient bit t is set.
//
// The batched rebuild (gf2_reconstruct_batched) replaces
// gf2bv_tpu/ops/gauss_batched.py: _make_reconstruct_kernel_b (launched by
// _reconstruct_batched): the same contract over B systems, arows (B, K, wp),
// coeff (B, K, kw), prow (B, K) -> pf (B, K, wp), triangular window included.
// Launch 1 runs the coefficient solve with one block per system
// (gridDim.x = B); launch 2 is ONE batched rank-K product over all B
// (gridDim.z = B), so the two launches per panel do not grow with B.

#include "gf2_common.cuh"

namespace {

constexpr int kMaxKw = 8;  // K <= 256

__global__ void reconstruct_coeff_kernel(const uint32_t* __restrict__ arows,
                                         const uint32_t* __restrict__ coeff,
                                         const int32_t* __restrict__ prow,
                                         uint32_t* __restrict__ tbits, int wp, int kw,
                                         int w0) {
  extern __shared__ uint32_t smem[];
  const int K = 32 * kw;
  const int k = threadIdx.x;         // blockDim.x == K
  const int rw = 2 * kw;             // row: [T (kw words) | slice (kw words)]
  uint32_t* row = smem;              // [K][2*kw]
  uint32_t* cf = smem + K * rw;      // [K][kw] coefficients
  int* has = (int*)(cf + K * kw);    // [K]
  // block b of the grid takes system b
  arows += (size_t)blockIdx.x * K * wp;
  coeff += (size_t)blockIdx.x * K * kw;
  prow += (size_t)blockIdx.x * K;
  tbits += (size_t)blockIdx.x * K * kw;

  for (int g = 0; g < kw; ++g) {
    row[k * rw + g] = (g == (k >> 5)) ? (1u << (k & 31)) : 0u;
    row[k * rw + kw + g] = arows[(size_t)k * wp + w0 + g];
    cf[k * kw + g] = coeff[(size_t)k * kw + g];
  }
  has[k] = prow[k] >= 0;
  __syncthreads();

  // forward rebuild; row t is final at step t
  for (int t = 0; t < K; ++t) {
    if (k == t && !has[t]) {
      for (int g = 0; g < rw; ++g) row[k * rw + g] = 0u;
    } else if (k > t && has[t] && ((cf[k * kw + (t >> 5)] >> (t & 31)) & 1u)) {
      for (int g = 0; g < rw; ++g) row[k * rw + g] ^= row[t * rw + g];
    }
    __syncthreads();
  }

  // back pass; row j is final at step j
  for (int j = K - 1; j >= 0; --j) {
    if (has[j] && k != j && k < 32 * ((j >> 5) + 1) &&
        ((row[k * rw + kw + (j >> 5)] >> (j & 31)) & 1u)) {
      for (int g = 0; g < rw; ++g) row[k * rw + g] ^= row[j * rw + g];
    }
    __syncthreads();
  }

  for (int g = 0; g < kw; ++g) tbits[(size_t)k * kw + g] = row[k * rw + g];
}

}  // namespace

extern "C" int gf2_reconstruct(const uint32_t* arows, const uint32_t* coeff,
                               const int32_t* prow, uint32_t* tbits, uint32_t* pf,
                               int wp, int kw, int w0, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw) return (int)cudaErrorInvalidValue;
  const int K = 32 * kw;
  const size_t smem = (size_t)(K * 3 * kw) * sizeof(uint32_t) + (size_t)K * sizeof(int);
  reconstruct_coeff_kernel<<<1, K, smem, stream>>>(arows, coeff, prow, tbits, wp, kw, w0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rank_k(pf, nullptr, tbits, arows, K, wp, kw, 0, 0, stream);
}

extern "C" int gf2_reconstruct_batched(const uint32_t* arows, const uint32_t* coeff,
                                       const int32_t* prow, uint32_t* tbits, uint32_t* pf,
                                       int batch, int wp, int kw, int w0,
                                       cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || batch < 1) return (int)cudaErrorInvalidValue;
  const int K = 32 * kw;
  const size_t smem = (size_t)(K * 3 * kw) * sizeof(uint32_t) + (size_t)K * sizeof(int);
  reconstruct_coeff_kernel<<<batch, K, smem, stream>>>(arows, coeff, prow, tbits, wp, kw,
                                                       w0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rank_k_batched(pf, nullptr, tbits, arows, K, wp, kw, 0, 0, batch,
                                    (size_t)K * wp, (size_t)K * kw, (size_t)K * wp,
                                    stream);
}
