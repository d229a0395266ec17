// The forward pivot scan of one system by ONE block with its state in global
// memory: the body of the one-block kernels that take the systems too tall
// for a cluster (scan.cu: gf2_scan_block, gf2_scan_batched_block;
// panel_update.cu: the scan block of gf2_update_scan_block), whose helpers
// the fused phase 1 and the two-pivot and min-key scans also use.  The
// cluster scan (scan_cluster.cuh) keeps the same contract with the state in
// the shared memory of several blocks.
//
// Contract of scan_system (pallas_phase1.py: _make_scan_kernel):
//   in : bT_in (kw, rows) transposed panel slice, used_in (rows,) 0/1, w0, cols
//   out: prow (K,) pivot row per panel column (-1 = free or invalid),
//        used (rows,), cT (kw, rows) elimination coefficients; bT (kw, rows)
//        is the working copy of the slice
// For each panel column jj (packed bit 32*w0 + jj, valid in 1..cols) the
// pivot is the LOWEST unused row index with the bit set (the reference's
// rule: any other rule permutes rows and breaks bit-exact comparisons).  Its
// slice words >= jj's word are XORed into every other candidate, the
// candidate's coefficient bit jj is set in cT, and the pivot is marked used.
//
// One block of kScanThreads threads strides over the rows with the state in
// global memory (L2-resident).  Each thread owns the rows r = tid (mod
// blockDim.x), so a step needs no cross-thread hazard handling beyond the two
// barriers of its election (warp __reduce_min_sync, then one warp over the 32
// warp minima).  A candidate search stops at a thread's first hit: its rows
// ascend.
#pragma once

#include "gf2_common.cuh"

namespace gf2 {

constexpr int kScanThreads = 1024;
constexpr int kMaxKw = 8;  // K <= 256

// Block-wide minimum of one int per thread, returned to every thread (two
// barriers: warp __reduce_min_sync, then one warp over the warp minima).
// `warp_min` has one slot per warp, `out` is one shared int.
__device__ __forceinline__ int block_min(int v, int none, int* warp_min, int* out) {
  const int tid = threadIdx.x;
  v = __reduce_min_sync(0xffffffffu, v);
  if ((tid & 31) == 0) warp_min[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    int m = tid < (int)(blockDim.x / 32) ? warp_min[tid] : none;
    m = __reduce_min_sync(0xffffffffu, m);
    if (tid == 0) *out = m;
  }
  __syncthreads();
  return *out;
}

// The initial state of a scan: used = used_in, bT = bT_in, cT = 0.
__device__ __forceinline__ void
scan_init(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
          int32_t* used, uint32_t* cT, uint32_t* bT, int rows, int kw) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    used[r] = used_in[r];
    for (int g = 0; g < kw; ++g) {
      bT[(size_t)g * rows + r] = bT_in[(size_t)g * rows + r];
      cT[(size_t)g * rows + r] = 0u;
    }
  }
}

// This thread's lowest unused row with `bit` set in `col`, or rows: its rows
// ascend, so the first hit is its minimum.
__device__ __forceinline__ int
first_candidate(const uint32_t* col, const int32_t* used, uint32_t bit, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    if (!used[r] && (col[r] & bit)) return r;
  return rows;
}

// One pivot's sweep: the pivot row is marked used; every other unused row
// with `bit` set in `col` (word sw of bT) gets the pivot's words bp[sw..kw)
// and its coefficient bit.
__device__ __forceinline__ void
eliminate(const uint32_t* col, int32_t* used, uint32_t* cT, uint32_t* bT,
          const uint32_t (&bp)[kMaxKw], uint32_t bit, int sw, int piv, int rows, int kw) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
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

// the one-block scan's steps, written out: built from first_candidate, block_min and
// eliminate instead, the batched scan (offset pointers) ran 1.5% slower on the
// H100 (2.28 against 2.24 ms per flagship panel at B = 4, in one run).
__device__ __forceinline__ void
scan_system(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
            int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
            int rows, int kw, int w0, int cols) {
  __shared__ int warp_min[kScanThreads / 32];
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

}  // namespace gf2
