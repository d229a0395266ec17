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
// The coefficient solve is a blocked triangular solve (coeff_blocked_body in
// reconstruct_coeff.cuh, launched here as coeff_blocked_kernel; the fused
// phase 1 of phase1_fused.cu runs the same body inside its own launch).
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
// K = 256) where one block of K threads, a row a thread, would take 2 K = 512
// block barriers.
//
// The batched rebuild (gf2_reconstruct_batched) replaces
// gf2bv_tpu/ops/gauss_batched.py: _make_reconstruct_kernel_b (launched by
// _reconstruct_batched): the same contract over B systems, arows (B, K, wp),
// coeff (B, K, kw), prow (B, K) -> pf (B, K, wp), triangular window included.
// Launch 1 runs the coefficient solve with one block per system
// (gridDim.x = B); launch 2 is ONE batched product over all B
// (gridDim.z = B), so the two launches per panel do not grow with B.

#include "reconstruct_coeff.cuh"

namespace {

constexpr int kMaxKw = 8;  // K <= 256

using gf2::blocked_quads;
using gf2::blocked_smem_words;

// One block per system: block b takes system b, its four base pointers offset
// once; the body (reconstruct_coeff.cuh) runs on all 32 * blocked_quads(KW)
// threads.
template <int KW>
__global__ void __launch_bounds__(32 * blocked_quads(KW))
coeff_blocked_kernel(const uint32_t* __restrict__ arows, const uint32_t* __restrict__ coeff,
                     const int32_t* __restrict__ prow, uint32_t* __restrict__ tbits, int wp,
                     int w0) {
  extern __shared__ uint32_t smem[];
  constexpr int K = 32 * KW;
  const gf2::CoeffGathered<KW> src = {arows + (size_t)blockIdx.x * K * wp,
                                      coeff + (size_t)blockIdx.x * K * KW,
                                      prow + (size_t)blockIdx.x * K, wp, w0};
  gf2::coeff_blocked_body<KW>(src, tbits + (size_t)blockIdx.x * K * KW, KW, smem);
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
