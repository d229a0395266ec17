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
//   1. the coefficient solve: one block runs both passes on [T | slice] rows
//      of 2*kw words and writes T.  It moves 24 KB; its time is the chain of
//      2K dependent steps, so the design shortens the chain's links;
//   2. pf = T . arows, the same GF(2) rank-K product as the panel update,
//      through the Four-Russians table kernel (launch_table_product in
//      update_table.cu), parallel over all words: on these 256 rows it takes
//      a sixth of the time of the mask-and-XOR tiles that ran it before.
//
// The coefficient solve is a blocked triangular solve (coeff_blocked_kernel).
// The forward decisions depend only on coeff, which is fixed, and the back
// decisions only on the slice, so a dependent step needs no block barrier: it
// is one warp-wide broadcast.
//   * a row's 2*kw words are cut into quads of four (16 bytes), and a warp
//     owns ONE quad of EVERY row: lane l of warp q holds quad q of rows
//     l, 32 + l, 64 + l, ... in registers (kw quads a thread), so a group of
//     32 consecutive rows is one register across the warp.  A block is nq =
//     ceil(2 kw / 4) warps (4 at K = 256), and a row operation never crosses
//     warps: quads are independent columns;
//   * forward, group g ascending, its 32 steps in order: at step t the quad of
//     row 32 g + t, which is final, is broadcast from lane t with shuffles,
//     and in the same step every later row whose coefficient bit is set takes
//     it: the later lanes of the group (the diagonal part) and all rows of the
//     later groups (the panel part, which needs only the row's ONE coefficient
//     word coeff[k][g]; its XORs do not wait on the next broadcast).  A row
//     without a pivot is never taken and is zeroed when its group is done:
//     nothing reads it before.  No shared memory, no barrier;
//   * back, group g descending, steps j = 31..0: the quad of row 32 g + j AS IT
//     IS AT STEP j is broadcast (the snapshot: a later step of the same group
//     may change row j again, since the window covers the whole group) and
//     taken by every row k != j of this and the lower groups whose slice bit j
//     is set at that moment;
//   * the back decisions read word g of a row's slice, which only one warp
//     holds.  Each thread carries a copy d of that word for each of its rows
//     and updates it with the snapshot's own (broadcast beside the quad), so
//     no warp asks another during a group; before each group the holding warp
//     publishes the words through shared memory: one block barrier a group.
// That is 2 K warp-level steps and kw + 1 block barriers of nq warps (9 at
// K = 256) where the step-by-step kernel below has 2 K = 512 block barriers.
//
// coeff_steps_kernel is that earlier design: one block of K threads (thread
// k owns row k in shared memory), one block barrier per step.  It is on no
// solve's path; gf2_reconstruct_coeff_steps keeps it callable so that both
// can be timed on the same inputs.
//
// The batched rebuild (gf2_reconstruct_batched) replaces
// gf2bv_tpu/ops/gauss_batched.py: _make_reconstruct_kernel_b (launched by
// _reconstruct_batched): the same contract over B systems, arows (B, K, wp),
// coeff (B, K, kw), prow (B, K) -> pf (B, K, wp), triangular window included.
// Launch 1 runs the coefficient solve with one block per system
// (gridDim.x = B); launch 2 is ONE batched product over all B
// (gridDim.z = B), so the two launches per panel do not grow with B.

#include "gf2_common.cuh"

namespace {

constexpr int kMaxKw = 8;  // K <= 256

__global__ void coeff_steps_kernel(const uint32_t* __restrict__ arows,
                                   const uint32_t* __restrict__ coeff,
                                   const int32_t* __restrict__ prow,
                                   uint32_t* __restrict__ tbits, int wp, int kw, int w0) {
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

// r ^= v where bit `bit` of `takes` is set: branch-free
__device__ __forceinline__ void xor4_if(uint4& r, const uint4 v, uint32_t takes, int bit) {
  const uint32_t m = (uint32_t)((int32_t)(takes << (31 - bit)) >> 31);
  r.x ^= v.x & m;
  r.y ^= v.y & m;
  r.z ^= v.z & m;
  r.w ^= v.w & m;
}

__device__ __forceinline__ uint4 shfl4(const uint4 r, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, r.x, src), __shfl_sync(0xffffffffu, r.y, src),
                    __shfl_sync(0xffffffffu, r.z, src), __shfl_sync(0xffffffffu, r.w, src));
}

__device__ __forceinline__ uint32_t word_of(const uint4 r, int c) {
  return c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w;
}

constexpr int blocked_quads(int kw) { return (2 * kw + 3) / 4; }

// Shared memory of coeff_blocked_kernel, in 32-bit words: cf[K][kw + 1], the
// coefficients padded against bank conflicts, and dpub[2][K], a row's decision
// word published before each back group (two buffers in turn).
constexpr int blocked_smem_words(int kw) { return 32 * kw * (kw + 1) + 2 * 32 * kw; }

// Block of 32 * nq threads: warp q = threadIdx.x / 32 holds quad q of every
// row, lane l the rows 32 g + l.  Nothing but the four base pointers depends
// on blockIdx.
template <int KW>
__global__ void __launch_bounds__(32 * blocked_quads(KW))
coeff_blocked_kernel(const uint32_t* __restrict__ arows, const uint32_t* __restrict__ coeff,
                     const int32_t* __restrict__ prow, uint32_t* __restrict__ tbits, int wp,
                     int w0) {
  extern __shared__ uint32_t smem[];
  constexpr int K = 32 * KW;
  uint32_t* cf = smem;                 // [K][KW + 1]
  uint32_t* dpub = cf + K * (KW + 1);  // [2][K]
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  arows += (size_t)blockIdx.x * K * wp;
  coeff += (size_t)blockIdx.x * K * KW;
  prow += (size_t)blockIdx.x * K;
  tbits += (size_t)blockIdx.x * K * KW;

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
      w[c] = i < KW ? (i == g ? 1u << lane : 0u)
                    : (i < 2 * KW ? arows[(size_t)k * wp + w0 + (i - KW)] : 0u);
    }
    r[g] = make_uint4(w[0], w[1], w[2], w[3]);
    has[g] = __ballot_sync(0xffffffffu, prow[k] >= 0);
  }
  for (int i = threadIdx.x; i < K * KW; i += blockDim.x)
    cf[(i / KW) * (KW + 1) + i % KW] = coeff[i];
  __syncthreads();

#pragma unroll
  for (int g = 0; g < KW; ++g) {  // forward: row 32 g + t is final at step t
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
    // d[h]: word g of the slice of row 32 h + lane, from the warp that holds it
    uint32_t* pub = dpub + (g & 1) * K;
    if (q == (KW + g) / 4) {
#pragma unroll
      for (int h = 0; h <= g; ++h) pub[32 * h + lane] = word_of(r[h], (KW + g) & 3);
    }
    __syncthreads();
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

#pragma unroll
  for (int g = 0; g < KW; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < KW) tbits[(size_t)(32 * g + lane) * KW + 4 * q + c] = word_of(r[g], c);
}

template <int KW>
cudaError_t launch_coeff_blocked_kw(const uint32_t* arows, const uint32_t* coeff,
                                    const int32_t* prow, uint32_t* tbits, int batch, int wp,
                                    int w0, cudaStream_t stream) {
  coeff_blocked_kernel<KW><<<batch, 32 * blocked_quads(KW),
                             blocked_smem_words(KW) * sizeof(uint32_t), stream>>>(
      arows, coeff, prow, tbits, wp, w0);
  return cudaGetLastError();
}

cudaError_t launch_coeff_blocked(const uint32_t* arows, const uint32_t* coeff,
                                 const int32_t* prow, uint32_t* tbits, int batch, int wp,
                                 int kw, int w0, cudaStream_t stream) {
  switch (kw) {
    case 1: return launch_coeff_blocked_kw<1>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 2: return launch_coeff_blocked_kw<2>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 3: return launch_coeff_blocked_kw<3>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 4: return launch_coeff_blocked_kw<4>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 5: return launch_coeff_blocked_kw<5>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 6: return launch_coeff_blocked_kw<6>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 7: return launch_coeff_blocked_kw<7>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    case 8: return launch_coeff_blocked_kw<8>(arows, coeff, prow, tbits, batch, wp, w0, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int batch, int wp, int kw, int w0) {
  return kw < 1 || kw > kMaxKw || batch < 1 || w0 < 0 || w0 + kw > wp;
}

}  // namespace

extern "C" int gf2_reconstruct(const uint32_t* arows, const uint32_t* coeff,
                               const int32_t* prow, uint32_t* tbits, uint32_t* pf,
                               int wp, int kw, int w0, cudaStream_t stream) {
  if (bad_shape(1, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_coeff_blocked(arows, coeff, prow, tbits, 1, wp, kw, w0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_table_product(pf, tbits, arows, 32 * kw, wp, kw, 1, 0, 0, 0, stream);
}

extern "C" int gf2_reconstruct_batched(const uint32_t* arows, const uint32_t* coeff,
                                       const int32_t* prow, uint32_t* tbits, uint32_t* pf,
                                       int batch, int wp, int kw, int w0,
                                       cudaStream_t stream) {
  if (bad_shape(batch, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  const int K = 32 * kw;
  cudaError_t err = launch_coeff_blocked(arows, coeff, prow, tbits, batch, wp, kw, w0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_table_product(pf, tbits, arows, K, wp, kw, batch, (size_t)K * wp,
                                   (size_t)K * kw, (size_t)K * wp, stream);
}

// The coefficient solve alone, T of each of `batch` systems: the first launch
// of the two entry points above.
extern "C" int gf2_reconstruct_coeff(const uint32_t* arows, const uint32_t* coeff,
                                     const int32_t* prow, uint32_t* tbits, int batch, int wp,
                                     int kw, int w0, cudaStream_t stream) {
  if (bad_shape(batch, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  return (int)launch_coeff_blocked(arows, coeff, prow, tbits, batch, wp, kw, w0, stream);
}

// The same by the step-by-step kernel (one block barrier per step): the
// earlier design, on no solve's path, kept callable so that both can be timed
// on the same inputs.
extern "C" int gf2_reconstruct_coeff_steps(const uint32_t* arows, const uint32_t* coeff,
                                           const int32_t* prow, uint32_t* tbits, int batch,
                                           int wp, int kw, int w0, cudaStream_t stream) {
  if (bad_shape(batch, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  const int K = 32 * kw;
  const size_t smem = (size_t)(K * 3 * kw) * sizeof(uint32_t) + (size_t)K * sizeof(int);
  coeff_steps_kernel<<<batch, K, smem, stream>>>(arows, coeff, prow, tbits, wp, kw, w0);
  return (int)cudaGetLastError();
}
