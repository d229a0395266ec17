// Forward pivot scan of one K-column panel (phase 1, first half).
//
// Replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel (launched by
// _call_scan_kernel, variant "", from phase1_panel_split).  Same contract:
//   in : bT (kw, rows) transposed panel slice, used (rows,) 0/1, w0, cols
//   out: prow (K,) pivot row per panel column (-1 = free or invalid),
//        used' (rows,), cT (kw, rows) elimination coefficients
// For each panel column jj (packed bit 32*w0 + jj, valid in 1..cols) the
// pivot is the LOWEST unused row index with the bit set (the reference's
// rule: any other rule permutes rows and breaks bit-exact comparisons).  Its
// slice words >= jj's word are XORed into every other candidate, the
// candidate's coefficient bit jj is set in cT, and the pivot is marked used.
//
// What bounds it on the H100: latency.  K = 256 dependent steps per panel
// (about 20k per flagship solve), each a block-wide min-reduction followed
// by an elimination sweep; the arithmetic is negligible.  bT + cT at the
// flagship shape are 1.3 MB, beyond shared memory, so this first version is
// ONE block of 1024 threads striding over the rows with the state in global
// memory (L2-resident).  Each thread owns the rows r = tid (mod 1024), so a
// step needs no cross-thread hazard handling beyond the two barriers of its
// reduction (warp __reduce_min_sync, then one warp over the 32 warp minima).
// A candidate search stops at a thread's first hit: its rows ascend.
//
// The batched scan (gf2_scan_batched) replaces
// gf2bv_tpu/ops/gauss_batched.py: _make_scan_kernel_b (launched by
// _scan_batched): the same scan over B independent systems, bT (B, kw, rows),
// used (B, rows) -> prow (B, K), used' (B, rows), cT (B, kw, rows).  The TPU
// kernel advances all B systems in each sequential step to share the cost of
// a step's cross-lane reductions.  Here the systems share nothing, so each
// gets its own block (gridDim.x = B) running the same loop on its slices, on
// its own SM: B steps progress in parallel, and the per-system working set
// (bT in + bT work + cT + used, about 2 MB at the flagship shape) stays in
// the 50 MB L2 for B up to ~24.  prow is written as (B, K) directly.

#include "gf2_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxKw = 8;  // K <= 256

// The scan of one system by one block of kThreads threads.
__device__ __forceinline__ void
scan_system(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
            int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
            int rows, int kw, int w0, int cols) {
  __shared__ int warp_min[kThreads / 32];
  __shared__ int piv_s;
  const int tid = threadIdx.x;
  const int nwarps = blockDim.x / 32;

  for (int r = tid; r < rows; r += blockDim.x) {
    used[r] = used_in[r];
    for (int g = 0; g < kw; ++g) {
      bT[(size_t)g * rows + r] = bT_in[(size_t)g * rows + r];
      cT[(size_t)g * rows + r] = 0u;
    }
  }

  const int K = 32 * kw;
  for (int jj = 0; jj < K; ++jj) {
    const long long gbit = 32LL * w0 + jj;
    if (gbit < 1 || gbit > cols) {  // block-uniform: no pivot, no barrier
      if (tid == 0) prow[jj] = -1;
      continue;
    }
    const int sw = jj >> 5;
    const uint32_t bit = 1u << (jj & 31);
    const uint32_t* col = bT + (size_t)sw * rows;

    int mine = rows;
    for (int r = tid; r < rows; r += blockDim.x) {
      if (!used[r] && (col[r] & bit)) {
        mine = r;
        break;
      }
    }
    mine = __reduce_min_sync(0xffffffffu, mine);
    if ((tid & 31) == 0) warp_min[tid >> 5] = mine;
    __syncthreads();
    if (tid < 32) {
      int v = tid < nwarps ? warp_min[tid] : rows;
      v = __reduce_min_sync(0xffffffffu, v);
      if (tid == 0) {
        piv_s = v;
        prow[jj] = v < rows ? v : -1;
      }
    }
    __syncthreads();
    const int piv = piv_s;
    if (piv >= rows) continue;  // block-uniform

    uint32_t bp[kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g)
      bp[g] = (g >= sw && g < kw) ? bT[(size_t)g * rows + piv] : 0u;

    for (int r = tid; r < rows; r += blockDim.x) {
      if (r == piv) {
        used[r] = 1;
        continue;
      }
      if (used[r] || !(col[r] & bit)) continue;
#pragma unroll
      for (int g = 0; g < kMaxKw; ++g)
        if (g >= sw && g < kw) bT[(size_t)g * rows + r] ^= bp[g];
      cT[(size_t)sw * rows + r] ^= bit;
    }
  }
}

// One system; the pointers stay kernel parameters.  (Offsetting them by
// blockIdx.x here as well cost 17% per step: 2.25 against 1.93 ms per
// flagship panel on the H100.)
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
            int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
            int rows, int kw, int w0, int cols) {
  scan_system(bT_in, used_in, prow, used, cT, bT, rows, kw, w0, cols);
}

// B systems; block b takes system b.
__global__ void __launch_bounds__(kThreads)
scan_batched_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                    int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                    int rows, int kw, int w0, int cols) {
  const size_t slice = (size_t)kw * rows;  // words of one system's bT / cT
  const size_t b = blockIdx.x;
  scan_system(bT_in + b * slice, used_in + b * rows, prow + b * 32 * kw, used + b * rows,
              cT + b * slice, bT + b * slice, rows, kw, w0, cols);
}

}  // namespace

extern "C" int gf2_scan(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                        int32_t* used_out, uint32_t* cT, uint32_t* bT_work, int rows,
                        int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw) return (int)cudaErrorInvalidValue;
  scan_kernel<<<1, kThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT, bT_work,
                                          rows, kw, w0, cols);
  return (int)cudaGetLastError();
}

extern "C" int gf2_scan_batched(const uint32_t* bT_in, const int32_t* used_in,
                                int32_t* prow, int32_t* used_out, uint32_t* cT,
                                uint32_t* bT_work, int batch, int rows, int kw, int w0,
                                int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || batch < 1) return (int)cudaErrorInvalidValue;
  scan_batched_kernel<<<batch, kThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT,
                                                      bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}
