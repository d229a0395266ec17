// The fused phase 1's stages after its scan, as a body two kernels call: the
// cluster kernel (phase1_fused.cu, stages 3-4) and the last link of the
// chained kernel (fused_chunked.cu).  When it starts, prow (K,) and the
// scan's coefficients cT (kw, ld) are final and visible to every block that
// calls it (the scan body's closing cluster barrier, or a __syncthreads with
// one block; pivots elected by earlier launches of a chain were written
// before this launch began).  Then:
//   3. every block solves T (pf = T . a[prow]) by itself with the rebuild's
//      blocked coefficient solve (coeff_blocked_body in reconstruct_coeff.cuh)
//      on its first four warps, reading the pivot rows' slice words from a
//      and their coefficients from cT through prow, into its own shared
//      memory: the same 0.026 ms in every block, and no exchange;
//   4. block `rank` of nb forms the strips rank, rank + nb, ... of pf's
//      4-word strips with the table body of update_table.cuh, reading the
//      pivot rows of each strip from a through prow (no gather).
// The coefficient solve is compiled for K = 256 and takes every kw (the
// groups past kw hold no pivot and are skipped), so a kernel that calls the
// body needs no instantiation per kw.
#pragma once

#include "reconstruct_coeff.cuh"
#include "update_table.cuh"

namespace gf2 {

constexpr int kFusedSolveKw = 8;
constexpr int kFusedSolveSmemWords = 2816;  // the solve's shared memory at K = 256, words
static_assert(kFusedSolveSmemWords == blocked_smem_words(kFusedSolveKw),
              "the solve's shared memory");

// Bytes of the product stages: T (32 kw rows of kw words, a whole number of
// quads), then the larger of the solve's words and the tables.
inline size_t fused_product_bytes(int kw) {
  const size_t solve = sizeof(uint32_t) * kFusedSolveSmemWords;
  const size_t tables = table_smem_bytes(kw);
  return sizeof(uint32_t) * 32 * kw * kw + (solve > tables ? solve : tables);
}

// Stages 3-4 by the calling block, rank `rank` of the nb blocks that share
// pf's strips.  ld: the rows of cT (its stride); smem4: fused_product_bytes(kw)
// of this block's shared memory that nothing else uses any more; nstrips:
// pf's 4-word strips; aligned: a, pf and wp allow 16-byte accesses.  Every
// thread of the block must call it.
__device__ __forceinline__ void
phase1_product_body(const uint32_t* __restrict__ a, const uint32_t* cT, const int32_t* prow,
                    uint32_t* __restrict__ pf, int ld, int wp, int kw, int w0, int nstrips,
                    int aligned, uint4* smem4, int rank, int nb) {
  uint32_t* tbits = reinterpret_cast<uint32_t*>(smem4);  // [32 kw][kw]
  uint4* work = smem4 + 8 * kw * kw;                     // the solve's words, then tables
  if (threadIdx.x < 32 * blocked_quads(kFusedSolveKw)) {
    const CoeffIndexed src = {a, cT, prow, ld, wp, w0, kw};
    coeff_blocked_body<kFusedSolveKw>(src, tbits, kw, reinterpret_cast<uint32_t*>(work));
  }
  __syncthreads();

  // this block's strips of pf = T . a[prow]: the K rows are one chunk
  const int K = 32 * kw;
  for (int strip = rank; strip < nstrips; strip += nb)
    table_update_body<true, true>(pf, tbits, a, K, wp, kw, 0, 0, K, aligned, kw == 8, strip,
                                  0, work, prow);
}

}  // namespace gf2
