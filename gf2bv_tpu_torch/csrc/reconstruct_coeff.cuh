// The rebuild's coefficient solve as a body other kernels call: the blocked
// warp-level triangular solve of reconstruct.cu (where its design is
// described), which turns a panel's K pivot rows into the K x K bit matrix T
// with pf = T . arows.  reconstruct.cu launches it on gathered inputs (one
// block per system); phase1_fused.cu runs it inside the fused phase 1, where
// it reads the pivot rows' slice words straight from the matrix and their
// coefficients from the scan's cT, row k of the panel at prow[k].
#pragma once

#include "gf2_common.cuh"

namespace gf2 {

// r ^= v where bit `bit` of `takes` is set: branch-free
__device__ __forceinline__ void xor4_if(uint4& r, const uint4 v, uint32_t takes, int bit) {
  const uint32_t m = (uint32_t)((int32_t)(takes << (31 - bit)) >> 31);
  r.x ^= v.x & m;
  r.y ^= v.y & m;
  r.z ^= v.z & m;
  r.w ^= v.w & m;
}

// Warps of the solve: one per 16-byte quad of a [T | slice] row.
__host__ __device__ constexpr int blocked_quads(int kw) { return (2 * kw + 3) / 4; }

// Shared memory of the solve, in 32-bit words: cf[K][kw + 1], the
// coefficients padded against bank conflicts, and dpub[2][K], a row's decision
// word published before each back group (two buffers in turn).
__host__ __device__ constexpr int blocked_smem_words(int kw) {
  return 32 * kw * (kw + 1) + 2 * 32 * kw;
}

// The inputs as the rebuild has them: arows (K, wp) the gathered pivot rows,
// coeff (K, KW) their coefficients, prow (K,).  Every row exists.
template <int KW>
struct CoeffGathered {
  const uint32_t* arows;
  const uint32_t* coeff;
  const int32_t* prow;
  int wp, w0;
  __device__ int groups() const { return KW; }  // groups of 32 rows that exist
  __device__ bool has(int k) const { return prow[k] >= 0; }
  __device__ uint32_t slice(int k, int g) const { return arows[(size_t)k * wp + w0 + g]; }
  __device__ uint32_t coef(int k, int g) const { return coeff[k * KW + g]; }
};

// The inputs as the fused phase 1 has them after its scan: a (rows, wp) the
// matrix, cT (kw, rows) the scan's coefficients, prow (32 kw,); row k of the
// panel is a[prow[k]], and the rows from 32 kw on do not exist (the body is
// compiled for KW >= kw).
struct CoeffIndexed {
  const uint32_t* a;
  const uint32_t* cT;
  const int32_t* prow;
  int rows, wp, w0, kw;
  __device__ int groups() const { return kw; }
  __device__ bool has(int k) const { return k < 32 * kw && prow[k] >= 0; }
  __device__ uint32_t slice(int k, int g) const {
    return g < kw && has(k) ? a[(size_t)prow[k] * wp + w0 + g] : 0u;
  }
  __device__ uint32_t coef(int k, int g) const {
    return g < kw && has(k) ? cT[(size_t)g * rows + prow[k]] : 0u;
  }
};

// The barrier of the solve's warps alone (named barrier 1), so that a block
// with more threads can run the solve on its first warps.
template <int KW>
__device__ __forceinline__ void solve_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * blocked_quads(KW)) : "memory");
}

// T of one system by the warps 0 .. blocked_quads(KW) - 1 of the calling
// block (the others must not call it): warp q = threadIdx.x / 32 holds quad q
// of every row, lane l the rows 32 g + l.  Row k of T goes to
// tbits[k * tstride + c], c < the words the source has.  smem: the solve's
// blocked_smem_words(KW) words.
template <int KW, class Src>
__device__ __forceinline__ void coeff_blocked_body(const Src& src, uint32_t* tbits, int tstride,
                                                   uint32_t* smem) {
  constexpr int K = 32 * KW;
  constexpr int nthreads = 32 * blocked_quads(KW);
  uint32_t* cf = smem;                 // [K][KW + 1]
  uint32_t* dpub = cf + K * (KW + 1);  // [2][K]
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ngroups = src.groups();  // the groups from ngroups on hold no pivot

  // row k = [T = e_k (KW words) | slice (KW words) | zero padding]; r[g] is
  // this warp's quad of row 32 g + lane, has[g] the pivots of group g
  uint4 r[KW];
  uint32_t has[KW];
#pragma unroll
  for (int g = 0; g < KW; ++g) {
    const int k = 32 * g + lane;
    uint32_t w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * q + c;
      w[c] = i < KW ? (i == g ? 1u << lane : 0u) : (i < 2 * KW ? src.slice(k, i - KW) : 0u);
    }
    r[g] = make_uint4(w[0], w[1], w[2], w[3]);
    has[g] = __ballot_sync(0xffffffffu, src.has(k));
  }
  for (int i = threadIdx.x; i < K * KW; i += nthreads)
    cf[(i / KW) * (KW + 1) + i % KW] = src.coef(i / KW, i % KW);
  solve_barrier<KW>();

#pragma unroll
  for (int g = 0; g < KW; ++g) {  // forward: row 32 g + t is final at step t
    if (g >= ngroups) break;      // block-uniform
    // the steps each of this thread's rows takes: pivots of group g whose
    // coefficient bit is set, for the group's own row only those before it
    uint32_t takes[KW];
#pragma unroll
    for (int h = g; h < KW; ++h) takes[h] = cf[(32 * h + lane) * (KW + 1) + g] & has[g];
    takes[g] &= (1u << lane) - 1u;
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const uint4 rt = shfl4(r[g], t);
#pragma unroll
      for (int h = g; h < KW; ++h) xor4_if(r[h], rt, takes[h], t);
    }
    if (!((has[g] >> lane) & 1u)) r[g] = make_uint4(0u, 0u, 0u, 0u);
  }

#pragma unroll
  for (int g = KW - 1; g >= 0; --g) {  // back: row 32 g + j is used as it is at step j
    if (g >= ngroups) continue;         // block-uniform: such a group holds no pivot
    // d[h]: word g of the slice of row 32 h + lane, from the warp that holds it
    uint32_t* pub = dpub + (g & 1) * K;
    if (q == (KW + g) / 4) {
#pragma unroll
      for (int h = 0; h <= g; ++h) pub[32 * h + lane] = word_of(r[h], (KW + g) & 3);
    }
    solve_barrier<KW>();
    uint32_t d[KW];
#pragma unroll
    for (int h = 0; h <= g; ++h) d[h] = pub[32 * h + lane];
    const uint32_t others = has[g] & ~(1u << lane);  // steps j != lane that have a pivot
#pragma unroll 4
    for (int j = 31; j >= 0; --j) {
      const uint4 rj = shfl4(r[g], j);
      const uint32_t dj = __shfl_sync(0xffffffffu, d[g], j);
#pragma unroll
      for (int h = 0; h <= g; ++h) {
        const uint32_t takes = d[h] & (h == g ? others : has[g]);
        xor4_if(r[h], rj, takes, j);
        d[h] ^= dj & (uint32_t)((int32_t)(takes << (31 - j)) >> 31);
      }
    }
  }

  // the T words of the rows that exist
#pragma unroll
  for (int g = 0; g < KW; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < KW && g < ngroups && 4 * q + c < ngroups)
        tbits[(size_t)(32 * g + lane) * tstride + 4 * q + c] = word_of(r[g], c);
}

}  // namespace gf2
