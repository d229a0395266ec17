// GF(2) rank-K panel update on the tensor cores: a ^= S . PF as a one-bit
// matrix product (mma.sync ... b1 and.popc), parity, repack.
//
// Replaces two TPU kernel families of gf2bv_tpu/ops/pallas_update.py, both
// by ONE kernel, mxu2_strip_kernel, under each engine's rule for the words it
// updates:
//   * _mxu2_kernel / _mxu2_kernel_trailing (panel_update_mxu2, the "mxu2"
//     engine): a tile j >= 1 (tw = 128 words, or wp when 128 does not divide
//     wp) with (j+1)*tw <= w0 keeps its words; tile 0 always gets the whole
//     update (mxu2_rule);
//   * _mxu4_kernel / _mxu4_kernel_trailing (panel_update_mxu4, "mxu4"): the
//     "mxu" engine's rule: dead tiles kept, and tile 0 updates only word 0
//     once tw <= w0 (mxu4_rule).
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
// transposed at bit level, 32 x 32 bits a warp at a time.
//
// Why the two engines are one kernel here.  The TPU's mxu4 packs the 32
// parity planes back into words by a SECOND product against power-of-two byte
// weights, because its matrix unit is the cheap way to move bits between its
// lanes.  That is a device of the TPU: on Hopper the same repack cost a second
// mma.sync (m16n8k32 u8), 4-byte read-modify-writes of a and a pre-kernel
// writing PF transposed into scratch (0.41 ms on 768 words, 11x the byte
// bound).  The strip kernel orders the bit columns so that each thread's
// counts already make whole words, so the repack is shifts and ORs, and both
// engines compute the same product; only their trailing rules differ.
//
// Fragments (PTX): thread (g = lane >> 2, t = lane & 3) holds A words t and
// 4 + t of rows g and g + 8, B k-words t and 4 + t of column g, and the
// counts of columns 2t and 2t + 1 for rows g and g + 8.
//
// mxu2_strip_kernel.  A block owns a strip of 32 words (one 128-byte line of
// a row) and a range of 16-row tiles, a warp one tile at a time.
//   * The bit columns are ordered so that a thread's counts make whole words:
//     column n of n-tile J (0..15) of word group G stands for word 4G + n / 2,
//     bit 2J + n % 2.  After the 16 products of a group, thread (g, t) holds
//     every bit of word 4G + t of rows g and g + 8, assembled with shifts and
//     ORs: no shuffle.
//   * The words go to a staging tile in shared memory (rows padded to 36
//     words: the stores hit 32 banks), then each lane reads 16 bytes of it and
//     XORs them into a with 16-byte accesses, eight lanes a 128-byte row
//     segment.  The tile of a is loaded before the products, so its latency
//     hides under them.
//   * Each block builds its strip's B in shared memory itself (warp k
//     transposes k-word k of the 32 words: a 32 x 32 bit block a word, in five
//     __shfl_xor_sync stages), laid out so that one 16-byte load gives a
//     thread the B fragments of two products and a warp's loads hit 32 banks.
//     One launch, no scratch.
//
// Bound on the H100: the product is 2 * rows * K * 32 * wp one-bit
// operations, for which the data sheet names no rate; priced at the int8
// tensor-core peak they would take 0.1286 ms on 20224 x 768 words, and the
// kernel takes less (0.102-0.110 ms), so that is no bound.  The bytes of a
// (read and written once), sel and pf bound it (0.0375 ms there).  Its time
// goes in about equal parts to the products, the traffic of a and the B build
// (measured by taking each out in turn).

#include <cstdint>
#include <cuda_runtime.h>

#include "gf2_common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void mma_b1_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// The A fragment of the 16-row tile at rbase: selector words t and 4 + t of
// rows g and g + 8, zero past the rows or the kw words.
__device__ __forceinline__ void load_a_fragment(uint32_t (&af)[4], const uint32_t* sel,
                                                int rbase, int rows, int kw, int g, int t) {
  const int r_lo = rbase + g, r_hi = rbase + g + 8;
  af[0] = (r_lo < rows && t < kw) ? sel[(size_t)r_lo * kw + t] : 0u;
  af[1] = (r_hi < rows && t < kw) ? sel[(size_t)r_hi * kw + t] : 0u;
  af[2] = (r_lo < rows && 4 + t < kw) ? sel[(size_t)r_lo * kw + 4 + t] : 0u;
  af[3] = (r_hi < rows && 4 + t < kw) ? sel[(size_t)r_hi * kw + 4 + t] : 0u;
}

// -- mxu2: strips of whole row segments, one launch ------------------------------

constexpr int kMx2Threads = 256;  // 8 warps: warp k transposes k-word k
constexpr int kMx2Warps = kMx2Threads / 32;
constexpr int kMx2Strip = 32;     // words of a block's strip: a 128-byte line of a row
constexpr int kMx2BWords = 256;   // B words of one output word: 32 bit columns x 8 k-words
constexpr int kMx2Stage = 36;     // words of a staged row: 32, padded for the stores' banks
constexpr int kMx2BlocksPerSm = 2;
constexpr size_t kMx2Smem =
    sizeof(uint32_t) * (kMx2Strip * kMx2BWords + kMx2Warps * 16 * kMx2Stage);

// Where B word (strip word w, bit column p = 2J + e, k-word k) lies: a thread's
// two k-words of products J and J + 1 (J even) are one 16-byte quad, and the
// quads of a warp's eight columns g (w = 4G + g / 2, e = g % 2) and four
// threads t cover 32 banks.
__device__ __forceinline__ int mx2_b_index(int w, int p, int k) {
  const int J = p >> 1, e = p & 1;
  return w * kMx2BWords + (J >> 1) * 32 + e * 16 + (k & 3) * 4 + (J & 1) * 2 + (k >> 2);
}

// The 32 x 32 bit block held by a warp, transposed: lane j holds row j (bit
// p: column p), and after five exchange stages lane p holds column p (bit j:
// row j's bit p).  Stage d swaps the off-diagonal d x d blocks of every 2d x 2d
// block: a lane with bit d clear takes its partner's low bits of each 2d-bit
// group into its high ones, the partner the other way.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kLow[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int d = 16 >> i;
    const uint32_t m = kLow[i];
    const uint32_t y = __shfl_xor_sync(kFull, x, d);
    x = (lane & d) ? (x & ~m) | ((y >> d) & m) : (x & m) | ((y & m) << d);
  }
  return x;
}

// 16 bytes of global memory in one access.
__device__ __forceinline__ uint4 load16(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store16(uint32_t* p, uint4 v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Words p[0 .. n) (0 < n <= 4): one 16-byte access when quad (n == 4 and p
// 16-byte aligned), else n 4-byte ones.
__device__ __forceinline__ uint4 load_words(const uint32_t* p, int n, bool quad) {
  if (quad) return load16(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) w[i] = p[i];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_words(uint32_t* p, int n, bool quad, uint4 x) {
  if (quad) {
    store16(p, x);
    return;
  }
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) p[i] = w[i];
}

// a ^= S . PF on the words [0, head_words) and [word_lo, wp), a strip of 32
// words a block along x, tiles_per_block 16-row tiles a block along y.  vec:
// wp % 4 == 0 and a 16-byte aligned, so every whole quad of a row is one
// 16-byte access (explicit v4 accesses: left to the compiler, the stores came
// out as four 4-byte ones).
__global__ void __launch_bounds__(kMx2Threads, kMx2BlocksPerSm)
mxu2_strip_kernel(uint32_t* a, const uint32_t* __restrict__ sel,
                  const uint32_t* __restrict__ pf, int rows, int wp, int kw, int head_words,
                  int word_lo, int tiles_per_block, bool vec) {
  extern __shared__ uint4 smem4[];
  uint32_t* bsm = reinterpret_cast<uint32_t*>(smem4);  // [kMx2Strip][kMx2BWords]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* stage = bsm + kMx2Strip * kMx2BWords + warp * 16 * kMx2Stage;  // this warp's [16][36]
  const int nhead = (head_words + kMx2Strip - 1) / kMx2Strip;
  const int bx = blockIdx.x;
  const int s = bx < nhead ? kMx2Strip * bx : word_lo + kMx2Strip * (bx - nhead);
  const int nw = min(kMx2Strip, (bx < nhead ? head_words : wp) - s);  // words of the strip

  // B of the strip: warp k transposes k-word k of its nw words
  const int k = warp;
  const uint32_t* src = pf + (size_t)(32 * k + lane) * wp + s;  // row 32k + lane of pf
#pragma unroll 4
  for (int w = 0; w < kMx2Strip; ++w) {
    const uint32_t x = (k < kw && w < nw) ? src[w] : 0u;
    // lane p: bit j = bit p of pf[32k + j][s + w]
    bsm[mx2_b_index(w, lane, k)] = transpose32(x, lane);
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int groups = (nw + 3) >> 2;
  const int tiles = (rows + 15) >> 4;
  const int tile_hi = min(tiles, ((int)blockIdx.y + 1) * tiles_per_block);
  // this lane's share of a tile's write-out: rows 4i + lane / 8, its quad of
  // words 4 (lane % 8) .. of the strip, nq of them in the strip (none for the
  // lanes past a narrow strip's end: they load and store nothing)
  const int cq = lane & 7;
  const int left = nw - 4 * cq;
  const int nq = left >= 4 ? 4 : left > 0 ? left : 0;
  const bool quad = vec && left >= 4;
  for (int tile = blockIdx.y * tiles_per_block + warp; tile < tile_hi; tile += kMx2Warps) {
    const int rbase = tile * 16;
    uint32_t af[4];
    load_a_fragment(af, sel, rbase, rows, kw, g, t);
    uint4 old[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rbase + 4 * i + (lane >> 3);
      old[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && nq > 0)
        old[i] = load_words(a + (size_t)r * wp + s + 4 * cq, nq, quad);
    }
    for (int G = 0; G < groups; ++G) {
      const uint4* bq = reinterpret_cast<const uint4*>(
          bsm + (4 * G + (g >> 1)) * kMx2BWords + (g & 1) * 16 + 4 * t);
      uint32_t lo = 0u, hi = 0u;  // word 4G + t of rows g and g + 8
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {  // products J = 2 jp and 2 jp + 1: bits 4 jp .. 4 jp + 3
        const uint4 b = bq[8 * jp];
        int c0[4], c1[4];
        mma_b1_and_popc(c0, af, b.x, b.y);
        mma_b1_and_popc(c1, af, b.z, b.w);
        lo |= (((uint32_t)c0[0] & 1u) | (((uint32_t)c0[1] & 1u) << 1) |
               (((uint32_t)c1[0] & 1u) << 2) | (((uint32_t)c1[1] & 1u) << 3)) << (4 * jp);
        hi |= (((uint32_t)c0[2] & 1u) | (((uint32_t)c0[3] & 1u) << 1) |
               (((uint32_t)c1[2] & 1u) << 2) | (((uint32_t)c1[3] & 1u) << 3)) << (4 * jp);
      }
      stage[g * kMx2Stage + 4 * G + t] = lo;
      stage[(g + 8) * kMx2Stage + 4 * G + t] = hi;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * i + (lane >> 3), r = rbase + rl;
      if (r >= rows || nq == 0) continue;
      const uint4 d = *reinterpret_cast<const uint4*>(stage + rl * kMx2Stage + 4 * cq);
      store_words(a + (size_t)r * wp + s + 4 * cq, nq, quad, gf2::xor4(old[i], d));
    }
    __syncwarp();
  }
}

cudaError_t launch_mxu2(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows, int wp,
                        int kw, int head_words, int word_lo, cudaStream_t stream) {
  static bool attributes_set = false;
  auto kernel = mxu2_strip_kernel;
  if (!attributes_set) {
    cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMx2Smem);
    if (rc != cudaSuccess) return rc;
    attributes_set = true;
  }
  int nsm = 0;
  cudaError_t rc = gf2::sm_count(&nsm);
  if (rc != cudaSuccess) return rc;
  const int strips = (head_words + kMx2Strip - 1) / kMx2Strip +
                     (wp - word_lo + kMx2Strip - 1) / kMx2Strip;
  const int tiles = (rows + 15) / 16;
  // row chunks: at most one wave of kMx2BlocksPerSm blocks an SM (rounded up,
  // 20 strips of 640 words made 280 blocks where 264 run at once: a second
  // wave of 16), a tile a warp at least
  const int want = max(1, min(kMx2BlocksPerSm * nsm / strips,
                              (tiles + kMx2Warps - 1) / kMx2Warps));
  const int per_block = (tiles + want - 1) / want;
  const int chunks = (tiles + per_block - 1) / per_block;
  const bool vec = wp % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  kernel<<<dim3(strips, chunks), kMx2Threads, kMx2Smem, stream>>>(
      a, sel, pf, rows, wp, kw, head_words, word_lo, per_block, vec);
  return cudaGetLastError();
}

bool bad_shape(int rows, int wp, int kw, int w0) {
  return kw < 1 || kw > 8 || rows < 1 || wp < 1 || w0 >= wp;
}

// The mxu2 rule as (head_words, word_lo): tiles 1 .. dead-1 are kept.
void mxu2_rule(int wp, int w0, int* head_words, int* word_lo) {
  const int tw = (wp % 128 == 0) ? 128 : wp;
  const int dead = w0 < 0 ? 0 : w0 / tw;
  *head_words = dead >= 2 ? tw : 0;
  *word_lo = dead >= 2 ? dead * tw : 0;
}

// The mxu4 rule (the "mxu" engine's) as (head_words, word_lo): once tw <= w0
// word 0 alone of tile 0 and the tiles from w0's on.
void mxu4_rule(int wp, int w0, int* head_words, int* word_lo) {
  const int tw = (wp % 128 == 0) ? 128 : wp;
  const bool const_only = w0 >= 0 && tw <= w0;
  *head_words = const_only ? 1 : 0;
  *word_lo = const_only ? (w0 / tw) * tw : 0;
}

}  // namespace

// a ^= S . PF, engine "mxu2", in one launch.  w0 < 0: every word; else tiles
// j >= 1 with (j+1)*tw <= w0 are kept, tile 0 never is.
extern "C" int gf2_update_mxu2(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                               int wp, int kw, int w0, cudaStream_t stream) {
  if (bad_shape(rows, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  int head_words, word_lo;
  mxu2_rule(wp, w0, &head_words, &word_lo);
  return (int)launch_mxu2(a, sel, pf, rows, wp, kw, head_words, word_lo, stream);
}

// a ^= S . PF, engine "mxu4", in one launch.  w0 < 0: every word; else, once
// tw <= w0, word 0 and the tiles from w0's on.
extern "C" int gf2_update_mxu4(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                               int wp, int kw, int w0, cudaStream_t stream) {
  if (bad_shape(rows, wp, kw, w0)) return (int)cudaErrorInvalidValue;
  int head_words, word_lo;
  mxu4_rule(wp, w0, &head_words, &word_lo);
  return (int)launch_mxu2(a, sel, pf, rows, wp, kw, head_words, word_lo, stream);
}
