// Fused phase 1 of one panel: scan, pivot-row rebuild and back pass in ONE
// kernel (the "pallas" phase-1 engine).
//
// Replaces gf2bv_tpu/ops/pallas_phase1.py: _make_kernel (launched by
// phase1_panel).  Same contract:
//   in : a (rows, wp) the matrix at the panel's start, bT (kw, rows) its
//        panel slice transposed, used (rows,), w0 (panel word offset), cols
//   out: pf (K, wp) the panel's intra-panel RREF pivot rows, prow (K,),
//        used' (rows,)
// Per pivot step the TPU kernel scans one column (kernel 1's step), DMAs the
// pivot's row a[piv] and rebuilds the forward pivot row at full width,
// pf[jj] = a[piv] ^ XOR{pf[t] : t < jj, bit t of C[piv]}; after the K steps a
// triangular back pass turns the forward rows into the panel's RREF rows.
//
// What bounds it on the H100, and the design: pf is K x wp words (655 KB at
// the flagship shape), more than the 227 KB of shared memory a block can use,
// and a full-width rebuild per step would stream about K^2/4 earlier rows
// (42 MB per panel) through one SM from L2.  Both passes are GF(2) row
// operations, and every decision in them reads only the rows' pivot-column
// slice (kw words), so each panel row is carried in shared memory as
// [T | slice]: T (K bits) the combination of pivot rows a[prow[t]] it is made
// of, slice its words w0 .. w0+kw-1.  Per pivot step, after the scan's
// election, the block rebuilds row jj from the earlier rows selected by
// C[piv] (each thread owns one earlier row and four of the 2*kw words; four
// warp XOR-reductions and one barrier combine them), the slice part starting
// from the pivot's own row a[piv].  The back pass runs on the same rows
// (thread k owns row k, the reference's triangular window kept).  Finally
// the block forms pf = T . a[prow] at full width, reading each pivot row from
// a once per 32-word tile.  The scan itself is kernel 1's
// (scan_system.cuh): one block of 1024 threads, its state in L2.  The whole
// panel stays on one SM, so this engine is expected to be slower than the
// split engine (scan + gather + reconstruct on many SMs); it is the
// reference's engine, ported for measurement.

#include "scan_system.cuh"

namespace {

using gf2::kMaxKw;
using gf2::kScanThreads;

constexpr int kMaxK = 32 * kMaxKw;
constexpr int kTsStride = 2 * kMaxKw + 1;  // one [T | slice] row, padded against bank conflicts

__global__ void __launch_bounds__(kScanThreads)
phase1_fused_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bT_in,
                    const int32_t* __restrict__ used_in, int32_t* __restrict__ prow,
                    int32_t* used, uint32_t* cT, uint32_t* bT, uint32_t* __restrict__ pf,
                    int rows, int wp, int kw, int w0, int cols) {
  __shared__ uint32_t ts[kMaxK * kTsStride];  // the panel rows as [T | slice]
  __shared__ uint32_t part[kScanThreads / 32][4];
  __shared__ int prow_s[kMaxK];
  __shared__ int warp_min[kScanThreads / 32];
  __shared__ int piv_s;
  const int tid = threadIdx.x;
  const int K = 32 * kw;
  const int rw = 2 * kw;

  gf2::scan_init(bT_in, used_in, used, cT, bT, rows, kw);
  for (int i = tid; i < kMaxK * kTsStride; i += blockDim.x) ts[i] = 0u;
  // the rebuild's split: thread owns earlier row t_own and words q + 4m
  const int t_own = tid & (kMaxK - 1);
  const int q = tid / kMaxK;

  for (int jj = 0; jj < K; ++jj) {
    const long long gbit = 32LL * w0 + jj;
    if (gbit < 1 || gbit > cols) {  // block-uniform: no pivot, no barrier
      if (tid == 0) prow[jj] = prow_s[jj] = -1;
      continue;
    }
    const int sw = jj >> 5;
    const uint32_t bit = 1u << (jj & 31);
    const uint32_t* col = bT + (size_t)sw * rows;

    const int piv =
        gf2::block_min(gf2::first_candidate(col, used, bit, rows), rows, warp_min, &piv_s);
    if (tid == 0) prow[jj] = prow_s[jj] = piv < rows ? piv : -1;
    if (piv >= rows) continue;  // block-uniform: row jj stays zero

    uint32_t bp[kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g)
      bp[g] = (g >= sw && g < kw) ? bT[(size_t)g * rows + piv] : 0u;

    // forward rebuild of row jj from the earlier rows selected by C[piv]
    const bool take = t_own < jj && ((cT[(size_t)(t_own >> 5) * rows + piv] >> (t_own & 31)) & 1u);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int g = q + 4 * m;
      uint32_t x = (take && g < rw) ? ts[t_own * kTsStride + g] : 0u;
      x = __reduce_xor_sync(0xffffffffu, x);
      if ((tid & 31) == 0) part[tid >> 5][m] = x;
    }
    __syncthreads();
    if (tid < rw) {
      const int g = tid;
      uint32_t x = g < kw ? (g == sw ? bit : 0u) : a[(size_t)piv * wp + w0 + (g - kw)];
      const int w_lo = (g & 3) * (kMaxK / 32);  // the warps that hold word g
      for (int w = w_lo; w < w_lo + kMaxK / 32; ++w) x ^= part[w][g >> 2];
      ts[jj * kTsStride + g] = x;
    }

    gf2::eliminate(col, used, cT, bT, bp, bit, sw, piv, rows, kw);
  }
  __syncthreads();

  // back pass; row j is final at step j
  for (int j = K - 1; j >= 0; --j) {
    if (prow_s[j] < 0) continue;  // block-uniform
    const int k = tid;
    if (k < 32 * ((j >> 5) + 1) && k != j &&
        ((ts[k * kTsStride + kw + (j >> 5)] >> (j & 31)) & 1u)) {
      for (int g = 0; g < rw; ++g) ts[k * kTsStride + g] ^= ts[j * kTsStride + g];
    }
    __syncthreads();
  }

  // pf = T . a[prow], one 32-word tile at a time: thread (tx, ty) owns word
  // tx of rows ty + 32 r
  const int tx = tid & 31, ty = tid >> 5;
  for (int wb = 0; wb < wp; wb += 32) {
    const int w = wb + tx;
    uint32_t acc[kMaxKw];
#pragma unroll
    for (int r = 0; r < kMaxKw; ++r) acc[r] = 0u;
    for (int g = 0; g < kw; ++g) {
      uint32_t s[kMaxKw];
#pragma unroll
      for (int r = 0; r < kMaxKw; ++r) s[r] = r < kw ? ts[(ty + 32 * r) * kTsStride + g] : 0u;
      for (int b = 0; b < 32; ++b) {
        const int pr = prow_s[32 * g + b];
        if (pr < 0) continue;  // block-uniform
        const uint32_t p = w < wp ? a[(size_t)pr * wp + w] : 0u;
#pragma unroll
        for (int r = 0; r < kMaxKw; ++r) acc[r] ^= p & (0u - ((s[r] >> b) & 1u));
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxKw; ++r)
      if (r < kw && w < wp) pf[(size_t)(ty + 32 * r) * wp + w] = acc[r];
  }
}

}  // namespace

extern "C" int gf2_phase1_fused(const uint32_t* a, const uint32_t* bT_in,
                                const int32_t* used_in, int32_t* prow, int32_t* used_out,
                                uint32_t* cT, uint32_t* bT_work, uint32_t* pf, int rows,
                                int wp, int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || w0 < 0 || w0 + kw > wp) return (int)cudaErrorInvalidValue;
  phase1_fused_kernel<<<1, kScanThreads, 0, stream>>>(a, bT_in, used_in, prow, used_out, cT,
                                                      bT_work, pf, rows, wp, kw, w0, cols);
  return (int)cudaGetLastError();
}
