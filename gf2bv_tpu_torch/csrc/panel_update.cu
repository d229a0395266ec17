// GF(2) rank-K panel update for Hopper: a ^= S . PF.
//
// Replaces three TPU kernels of gf2bv_tpu/ops/pallas_update.py:
//   * _mxu_kernel (panel_update_mxu, w0=None): the full-width update;
//   * _mxu_kernel_seg (panel_update_mxu_seg): the segmented trailing update,
//     where 128-word tile 0 updates only its const word (word 0), tiles
//     [1, dead_tiles) are never touched and tiles [dead_tiles, nj) get the
//     full update;
//   * _mxu_kernel_trailing (panel_update_mxu with w0): the same shape of
//     update with the dead tiles derived from the panel start w0 at run time
//     (tiles of tw = 128 words, or one tile of wp words when 128 does not
//     divide wp).  The TPU kernel copies its dead tiles through; updating in
//     place leaves them as they were, the same values.
// One CUDA kernel serves all three through (word_lo, const_word); each TPU
// kernel keeps its own C entry point, Python wrapper and launch count.  The
// same kernel, with gridDim.z over a batch, is the product pf = T . arows
// of the batched pivot-row rebuild (reconstruct.cu).
//
// What bounds it on the H100: the TPU form (int8 bit planes through the MXU)
// exists for the TPU's matrix unit.  Here every output word takes K
// branch-free mask-and-XOR steps (about 4 INT32 instructions each), so at
// K = 256 a full flagship update (20224 x 640 words) is ~13 G integer
// instructions against ~104 MB of device-memory traffic: it is bound by
// INT32 issue, not by HBM.  The design keeps that issue rate high and the
// memory side cheap:
//   * a block owns a 128-row x 32-word tile; PF's 32-word column strip
//     (K x 32 words, 32 KB at K = 256) and the block's selector rows are
//     staged once in shared memory;
//   * each thread owns one word column and 16 rows, so one shared-memory
//     load of a PF word feeds 16 mask-and-XORs held in registers;
//   * the matrix is read and written exactly once per update.
// Four-Russians tables or an int8 tensor-core bit-plane GEMM are later
// optimisations, to be chosen by measurement.

#include "gf2_common.cuh"

namespace {

constexpr int kTileWords = 32;            // word columns per block (one warp)
constexpr int kThreadRows = 8;            // thread rows per block
constexpr int kRowsPerThread = 16;        // rows held in registers per thread
constexpr int kTileRows = kThreadRows * kRowsPerThread;  // 128 rows per block

__global__ void __launch_bounds__(kTileWords * kThreadRows)
rank_k_kernel(uint32_t* out, const uint32_t* a,
              const uint32_t* __restrict__ sel, const uint32_t* __restrict__ pf,
              int rows, int wp, int kw, int word_lo, int const_word,
              size_t mat_stride, size_t sel_stride, size_t pf_stride) {
  extern __shared__ uint32_t smem[];
  out += blockIdx.z * mat_stride;
  if (a) a += blockIdx.z * mat_stride;
  sel += blockIdx.z * sel_stride;
  pf += blockIdx.z * pf_stride;
  const int K = 32 * kw;
  uint32_t* pf_s = smem;                         // [K][kTileWords]
  uint32_t* sel_s = smem + K * kTileWords;       // [kTileRows][kw]
  const int tid = threadIdx.y * kTileWords + threadIdx.x;
  const int nthreads = kTileWords * kThreadRows;
  const int row0 = blockIdx.y * kTileRows;

  for (int i = tid; i < kTileRows * kw; i += nthreads) {
    const int r = row0 + i / kw;
    sel_s[i] = r < rows ? sel[(size_t)r * kw + (i % kw)] : 0u;
  }

  if (const_word && blockIdx.x == gridDim.x - 1) {
    // const-word block: word 0 only, one row per thread
    for (int t = tid; t < K; t += nthreads) pf_s[t] = pf[(size_t)t * wp];
    __syncthreads();
    const int r = row0 + tid;
    if (tid < kTileRows && r < rows) {
      uint32_t acc = a ? a[(size_t)r * wp] : 0u;
      for (int g = 0; g < kw; ++g) {
        const uint32_t s = sel_s[tid * kw + g];
#pragma unroll
        for (int b = 0; b < 32; ++b) acc ^= pf_s[32 * g + b] & (0u - ((s >> b) & 1u));
      }
      out[(size_t)r * wp] = acc;
    }
    return;
  }

  const int wbase = word_lo + blockIdx.x * kTileWords;
  for (int i = tid; i < K * kTileWords; i += nthreads) {
    const int w = wbase + (i % kTileWords);
    pf_s[i] = w < wp ? pf[(size_t)(i / kTileWords) * wp + w] : 0u;
  }
  __syncthreads();

  const int w = wbase + threadIdx.x;
  uint32_t acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + threadIdx.y + kThreadRows * r;
    acc[r] = (a && row < rows && w < wp) ? a[(size_t)row * wp + w] : 0u;
  }
  for (int g = 0; g < kw; ++g) {
    uint32_t s[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      s[r] = sel_s[(threadIdx.y + kThreadRows * r) * kw + g];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t p = pf_s[(32 * g + b) * kTileWords + threadIdx.x];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] ^= p & (0u - ((s[r] >> b) & 1u));
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + threadIdx.y + kThreadRows * r;
    if (row < rows && w < wp) out[(size_t)row * wp + w] = acc[r];
  }
}

}  // namespace

cudaError_t launch_rank_k_batched(uint32_t* out, const uint32_t* a, const uint32_t* sel,
                                  const uint32_t* pf, int rows, int wp, int kw,
                                  int word_lo, int const_word, int batch,
                                  size_t mat_stride, size_t sel_stride,
                                  size_t pf_stride, cudaStream_t stream) {
  const int live = wp - word_lo;
  const int gx = (live + kTileWords - 1) / kTileWords + (const_word ? 1 : 0);
  const int gy = (rows + kTileRows - 1) / kTileRows;
  if (gx <= 0 || gy <= 0 || batch <= 0) return cudaGetLastError();
  const size_t smem = (size_t)(32 * kw * kTileWords + kTileRows * kw) * sizeof(uint32_t);
  rank_k_kernel<<<dim3(gx, gy, batch), dim3(kTileWords, kThreadRows), smem, stream>>>(
      out, a, sel, pf, rows, wp, kw, word_lo, const_word, mat_stride, sel_stride,
      pf_stride);
  return cudaGetLastError();
}

cudaError_t launch_rank_k(uint32_t* out, const uint32_t* a, const uint32_t* sel,
                          const uint32_t* pf, int rows, int wp, int kw,
                          int word_lo, int const_word, cudaStream_t stream) {
  return launch_rank_k_batched(out, a, sel, pf, rows, wp, kw, word_lo, const_word, 1,
                               0, 0, 0, stream);
}

// a ^= S . PF over every word (replaces pallas_update._mxu_kernel).
extern "C" int gf2_update_full(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                               int rows, int wp, int kw, cudaStream_t stream) {
  return (int)launch_rank_k(a, a, sel, pf, rows, wp, kw, 0, 0, stream);
}

// Segmented trailing update (replaces pallas_update._mxu_kernel_seg): word 0
// and the words of tiles [dead_tiles, wp / 128) are updated; words 1..127
// and tiles [1, dead_tiles) are left as they are.
extern "C" int gf2_update_seg(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                              int rows, int wp, int kw, int dead_tiles,
                              cudaStream_t stream) {
  return (int)launch_rank_k(a, a, sel, pf, rows, wp, kw, 128 * dead_tiles, 1, stream);
}

// Trailing update with a runtime panel start w0 (replaces
// pallas_update._mxu_kernel_trailing): with tw = 128 when 128 divides wp, else
// tw = wp, and tw <= w0, word 0 and the tiles from w0's tile on are updated;
// otherwise every word is.
extern "C" int gf2_update_trailing(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                   int rows, int wp, int kw, int w0,
                                   cudaStream_t stream) {
  if (w0 < 0 || w0 >= wp) return (int)cudaErrorInvalidValue;
  const int tw = (wp % 128 == 0) ? 128 : wp;
  const int const_only = tw <= w0;
  const int word_lo = const_only ? (w0 / tw) * tw : 0;
  return (int)launch_rank_k(a, a, sel, pf, rows, wp, kw, word_lo, const_only, stream);
}

extern "C" const char* gf2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
