// GF(2) rank-K panel update on the tensor cores: a ^= S . PF as a one-bit
// matrix product (mma.sync ... b1 and.popc), parity, repack.
//
// Replaces two TPU kernel families of gf2bv_tpu/ops/pallas_update.py:
//   * _mxu2_kernel / _mxu2_kernel_trailing (panel_update_mxu2, the "mxu2"
//     engine) -> mxu2_kernel: one product per tile, the 32 parity planes
//     packed back into words with shifts and ORs in registers.  Trailing: a
//     tile j >= 1 (tw = 128 words, or wp when 128 does not divide wp) with
//     (j+1)*tw <= w0 keeps its words; tile 0 always gets the whole update;
//   * _mxu4_kernel / _mxu4_kernel_trailing (panel_update_mxu4, "mxu4") ->
//     mxu4_kernel: the same product, and the repack ALSO as a matrix product,
//     parity bits (0/1 as u8) times power-of-two byte weights
//     (mma.sync m16n8k32 u8), four bytes assembled into the word.  Trailing
//     as the "mxu" engine: dead tiles kept, and tile 0 updates only word 0
//     once tw <= w0.
// In place; the TPU kernels copy their dead tiles through, which is the same
// values.
//
// The TPU form unpacks S and PF into int8 bit planes because its matrix unit
// takes nothing narrower, and its (K, 32*TW) int8 block (1 MiB at TW = 128)
// could never sit in an SM.  Hopper's mma.sync has one-bit operands:
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// computes a 16 x 8 tile of popcount(A_row & B_col) over 256 bits, and
// K = 256 is exactly one instruction deep.  A's operand layout (row-major,
// the 256 bits of a row contiguous) IS a packed selector row.  B wants, for
// each output bit column (word w, bit p), its K bits contiguous: PF
// transposed at bit level.  A small pre-kernel (bit_transpose_kernel: warp
// ballots, one 32 x 32 bit block per warp) writes that once per update into
// scratch, laid out so that a warp's B fragment loads hit 32 distinct banks.
// The update kernel then stages the B strips of 8 word columns in shared
// memory (8 KB) and each warp walks 16-row tiles: 4 mma per output word.
//
// Accumulator fragment: thread (g = lane >> 2, t = lane & 3) holds, per
// n-tile j, the counts of bit columns 8j + 2t and 8j + 2t + 1 for rows g and
// g + 8, so one output word is spread over the 4 threads of a quad.
//   * mxu2: each thread shifts its parities into place, the quad ORs them
//     together with two shuffles.
//   * mxu4: the accumulator fragments of two n-tiles, parities packed as
//     bytes, ARE an A fragment of m16n8k32 (bytes k = 4t .. 4t + 3 of rows g
//     and g + 8), under the column order k = 16(j >> 1) + 4(c >> 1) +
//     2(j & 1) + (c & 1) for bit p = 8j + c.  The weight matrix
//     B[k][n] = 2^(p & 7) where n == p >> 3 is built in registers with that
//     order, so no data moves between threads before the second product.
//     Its result has byte n of the word in column n: threads t = 0 and 1 of
//     the quad hold bytes 0, 1 and 2, 3; columns 4..7 are unused.
//
// Bound on the H100: the product is 2 * rows * K * 32 * wp one-bit
// operations.  The data sheet names no one-bit rate, so chip_smoke.py prices
// them at the int8 tensor-core peak; at the flagship shapes that takes
// longer than the traffic of a (read and written once), so operations give
// the bound it prints.  On top of the product the kernel pays the repack's
// integer instructions and the staging of the B strips.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMmaThreads = 256;                 // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaWords = 8;                     // word columns per block
constexpr int kMmaIter = 4;                      // 16-row tiles per warp
constexpr int kMmaRows = kMmaWarps * 16 * kMmaIter;  // 512 rows per block
constexpr int kBtWords = 256;  // transposed words per word column: [2][32][4]

// pfT[w][h][p][t] = bits j = 0..31: bit p of pf[32 * (4h + t) + j][w]; zero
// where 4h + t >= kw.  One block per word column, one warp per k-word.
__global__ void __launch_bounds__(kMmaThreads)
bit_transpose_kernel(uint32_t* __restrict__ pfT, const uint32_t* __restrict__ pf,
                     int wp, int kw) {
  const int w = blockIdx.x;
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t word = q < kw ? pf[(size_t)(32 * q + lane) * wp + w] : 0u;
  uint32_t mine = 0u;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, (word >> p) & 1u);
    if (lane == p) mine = bal;
  }
  pfT[(size_t)w * kBtWords + (q >> 2) * 128 + lane * 4 + (q & 3)] = mine;
}

__device__ __forceinline__ void mma_b1_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// The update of words [0, head_words) and [word_lo, wp) in strips of
// kMmaWords; kRepack picks the mxu4 repack.
template <bool kRepack>
__device__ __forceinline__ void
mma_update_body(uint32_t* a, const uint32_t* __restrict__ sel,
                const uint32_t* __restrict__ pfT, int rows, int wp, int kw,
                int head_words, int word_lo) {
  __shared__ uint32_t bt[kMmaWords * kBtWords];
  const int nhead = (head_words + kMmaWords - 1) / kMmaWords;
  int wbeg, wend;
  if ((int)blockIdx.x < nhead) {
    wbeg = blockIdx.x * kMmaWords;
    wend = min(head_words, wbeg + kMmaWords);
  } else {
    wbeg = word_lo + (blockIdx.x - nhead) * kMmaWords;
    wend = min(wp, wbeg + kMmaWords);
  }
  const int nw = wend - wbeg;
  for (int i = threadIdx.x; i < nw * kBtWords; i += kMmaThreads)
    bt[i] = pfT[(size_t)wbeg * kBtWords + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t wb[2] = {0u, 0u};
  if (kRepack) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g == 2 * h + (i >> 1)) wb[h] |= (1u << (2 * t + (i & 1))) << (8 * i);
  }

  const int row0 = blockIdx.y * kMmaRows;
  for (int it = 0; it < kMmaIter; ++it) {
    const int rbase = row0 + (it * kMmaWarps + warp) * 16;
    if (rbase >= rows) break;
    const int r_lo = rbase + g, r_hi = rbase + g + 8;
    uint32_t af[4];
    af[0] = (r_lo < rows && t < kw) ? sel[(size_t)r_lo * kw + t] : 0u;
    af[1] = (r_hi < rows && t < kw) ? sel[(size_t)r_hi * kw + t] : 0u;
    af[2] = (r_lo < rows && 4 + t < kw) ? sel[(size_t)r_lo * kw + 4 + t] : 0u;
    af[3] = (r_hi < rows && 4 + t < kw) ? sel[(size_t)r_hi * kw + 4 + t] : 0u;
    for (int wc = 0; wc < nw; ++wc) {
      const uint32_t* b = bt + wc * kBtWords;
      int c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_b1_and_popc(c[j], af, b[(8 * j + g) * 4 + t], b[128 + (8 * j + g) * 4 + t]);
      uint32_t lo = 0u, hi = 0u;
      if (kRepack) {
        uint32_t ra[4];
        ra[0] = (c[0][0] & 1) | ((c[0][1] & 1) << 8) | ((c[1][0] & 1) << 16) | ((c[1][1] & 1) << 24);
        ra[1] = (c[0][2] & 1) | ((c[0][3] & 1) << 8) | ((c[1][2] & 1) << 16) | ((c[1][3] & 1) << 24);
        ra[2] = (c[2][0] & 1) | ((c[2][1] & 1) << 8) | ((c[3][0] & 1) << 16) | ((c[3][1] & 1) << 24);
        ra[3] = (c[2][2] & 1) | ((c[2][3] & 1) << 8) | ((c[3][2] & 1) << 16) | ((c[3][3] & 1) << 24);
        int d[4];
        mma_u8(d, ra, wb[0], wb[1]);
        if (t < 2) {
          lo = (((uint32_t)d[0] & 0xFFu) | (((uint32_t)d[1] & 0xFFu) << 8)) << (16 * t);
          hi = (((uint32_t)d[2] & 0xFFu) | (((uint32_t)d[3] & 0xFFu) << 8)) << (16 * t);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo |= (((uint32_t)c[j][0] & 1u) | (((uint32_t)c[j][1] & 1u) << 1)) << (8 * j + 2 * t);
          hi |= (((uint32_t)c[j][2] & 1u) | (((uint32_t)c[j][3] & 1u) << 1)) << (8 * j + 2 * t);
        }
      }
      lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 1);
      hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 1);
      lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 2);
      hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 2);
      if (t == (wc & 3)) {
        const int w = wbeg + wc;
        if (r_lo < rows) a[(size_t)r_lo * wp + w] ^= lo;
        if (r_hi < rows) a[(size_t)r_hi * wp + w] ^= hi;
      }
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
mxu2_kernel(uint32_t* a, const uint32_t* __restrict__ sel, const uint32_t* __restrict__ pfT,
            int rows, int wp, int kw, int head_words, int word_lo) {
  mma_update_body<false>(a, sel, pfT, rows, wp, kw, head_words, word_lo);
}

__global__ void __launch_bounds__(kMmaThreads)
mxu4_kernel(uint32_t* a, const uint32_t* __restrict__ sel, const uint32_t* __restrict__ pfT,
            int rows, int wp, int kw, int head_words, int word_lo) {
  mma_update_body<true>(a, sel, pfT, rows, wp, kw, head_words, word_lo);
}

template <typename Kernel>
int launch_mma_update(Kernel kernel, uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                      uint32_t* pfT, int rows, int wp, int kw, int head_words, int word_lo,
                      cudaStream_t stream) {
  bit_transpose_kernel<<<wp, kMmaThreads, 0, stream>>>(pfT, pf, wp, kw);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int strips = (head_words + kMmaWords - 1) / kMmaWords +
                     (wp - word_lo + kMmaWords - 1) / kMmaWords;
  const dim3 grid(strips, (rows + kMmaRows - 1) / kMmaRows);
  kernel<<<grid, kMmaThreads, 0, stream>>>(a, sel, pfT, rows, wp, kw, head_words, word_lo);
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int wp, int kw, int w0) {
  return kw < 1 || kw > 8 || rows < 1 || wp < 1 || w0 >= wp;
}

}  // namespace

// a ^= S . PF, engine "mxu2".  pfT: scratch of wp * 256 words.  w0 < 0: every
// word; else tiles j >= 1 with (j+1)*tw <= w0 are kept, tile 0 never is.
extern "C" int gf2_update_mxu2(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                               uint32_t* pfT, int rows, int wp, int kw, int w0,
                               cudaStream_t stream) {
  if (bad_shape(rows, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  const int tw = (wp % 128 == 0) ? 128 : wp;
  const int dead = w0 < 0 ? 0 : w0 / tw;  // tiles 1 .. dead-1 are kept
  const int head_words = dead >= 2 ? tw : 0;
  const int word_lo = dead >= 2 ? dead * tw : 0;
  return launch_mma_update(mxu2_kernel, a, sel, pf, pfT, rows, wp, kw, head_words, word_lo,
                           stream);
}

// a ^= S . PF, engine "mxu4".  w0 < 0: every word; else, once tw <= w0, word
// 0 and the tiles from w0's on.
extern "C" int gf2_update_mxu4(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                               uint32_t* pfT, int rows, int wp, int kw, int w0,
                               cudaStream_t stream) {
  if (bad_shape(rows, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  const int tw = (wp % 128 == 0) ? 128 : wp;
  const bool const_only = w0 >= 0 && tw <= w0;
  const int head_words = const_only ? 1 : 0;
  const int word_lo = const_only ? (w0 / tw) * tw : 0;
  return launch_mma_update(mxu4_kernel, a, sel, pf, pfT, rows, wp, kw, head_words, word_lo,
                           stream);
}
