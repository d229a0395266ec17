// GF(2) rank-K panel updates for Hopper: a ^= S . PF.
//
// The C entry points of four TPU kernels of gf2bv_tpu/ops/pallas_update.py:
//   * _mxu_kernel (panel_update_mxu, w0=None): the full-width update
//     (gf2_update_full);
//   * _mxu_kernel_seg (panel_update_mxu_seg): the segmented trailing update,
//     where 128-word tile 0 updates only its const word (word 0), tiles
//     [1, dead_tiles) are never touched and tiles [dead_tiles, nj) get the
//     full update (gf2_update_seg);
//   * _mxu_kernel_trailing (panel_update_mxu with w0): the same shape of
//     update with the dead tiles derived from the panel start w0 at run time
//     (tiles of tw = 128 words, or one tile of wp words when 128 does not
//     divide wp; gf2_update_trailing).  The TPU kernel copies its dead tiles
//     through; updating in place leaves them as they were, the same values;
//   * _make_mxu_scan_kernel (panel_update_mxu_scan, the "mxu_la" engine): the
//     trailing or full update of panel t fused with the 1-pivot scan of
//     panel t+1 (gf2_update_scan, below).
// Each entry point turns its rule into (word_lo, const_word): the live words
// are [word_lo, wp), plus word 0 alone when const_word is set.
//
// What bounds the update on the H100, and the two bodies here.  The TPU form
// (int8 bit planes through the MXU) exists for the TPU's matrix unit.  Written
// for the CUDA cores as it stands, every output word takes K branch-free
// mask-and-XOR steps (about 4 INT32 operations each): at K = 256 a full
// flagship update (20224 x 640 words) is ~13 G integer operations against
// ~104 MB of device-memory traffic, bound by the INT32 pipes at 21-23x its
// byte bound.  So the first three entry points run the Four-Russians table kernel
// of update_table.cu (launch_table_update: one shared-memory table read per 8
// selector bits), under their own rules, and so does the product
// pf = T . arows of the pivot-row rebuilds (reconstruct.cu: measured on its 256
// rows the tables take a sixth of the tiles' time), and so do the update
// clusters of the fused update + scan.  The mask-and-XOR tile body
// (rank_k_tile, below) stays for:
//   * gf2_update_rank_k, which launches it on a panel update's arguments so
//     that the two bodies can be timed on the same inputs;
//   * the update tiles of gf2_update_scan_block, the fused kernel's earlier
//     design, where they hide under the one-block scan's time.
// In rank_k_tile a block owns a 128-row x 32-word tile; PF's 32-word column
// strip (32 KB at K = 256) and the block's selector rows are staged once in
// shared memory, and each thread owns one word column and 16 rows, so one
// shared-memory load of a PF word feeds 16 mask-and-XORs held in registers.
//
// The fused update + scan (gf2_update_scan): on the TPU the two phases could
// only overlap inside one kernel, since its kernels run one after another on
// one core.  Here ONE launch holds both, as blocks of 512 threads in clusters
// of nb blocks, nb the cluster size the scan's route picks for (rows, kw):
//   * cluster 0 (blocks 0 .. nb-1: the lowest indices, so it is dispatched
//     first) runs the cluster scan of scan_cluster.cuh on the next panel's
//     slice bTn, its state in shared memory, 0.85 us a step on 20224 rows;
//   * every other cluster's blocks run the table body of update_table.cuh,
//     block u of them on strip u % nstrips and row chunk u / nstrips of the
//     live words: the strips launch_table_update would launch, their rows cut
//     into chunks for the SMs left beside the scan cluster (the clusters the
//     card holds at once, less one).  The grid is padded to a whole number of
//     clusters; a surplus block returns at once.
// The two parts share no data (the scan reads the separate, already-updated
// next slice; the update writes a), so no block waits on another: only
// cluster 0 touches a cluster barrier or another block's shared memory, and
// an update block may exit whenever it is done.  Every block asks for the
// larger of the two bodies' shared memory (the tables' 132 KB at K = 256
// against the scan block's 43 KB at the flagship shape), so one block runs on
// an SM.  What bounds it: the scan's chain of K steps (0.20 ms at the
// flagship shape), under which the update (0.11-0.12 ms on the SMs that are
// left) hides.
//
// The kernel and its launch live in update_scan.cuh, which the chained
// kernel's first link (fused_chunked.cu) shares for slices taller than one
// cluster.  gf2_update_scan_block is that kernel's earlier design under its
// own name, on no solve's path since the chained kernel took those slices,
// kept to be timed beside it: block 0 runs the one-block scan with its state
// in global memory (scan_system.cuh), blocks 1.. run 256-row x 32-word
// mask-and-XOR tiles.

#include "scan_cluster.cuh"
#include "scan_system.cuh"
#include "update_scan.cuh"
#include "update_table.cuh"

namespace {

constexpr int kTileWords = 32;            // word columns per block (one warp)
constexpr int kThreadRows = 8;            // thread rows per block
constexpr int kRowsPerThread = 16;        // rows held in registers per thread
constexpr int kTileRows = kThreadRows * kRowsPerThread;  // 128 rows per block

// One 32-word x (kThreadRowsT * kRowsPerThreadT)-row tile of the product:
// thread (tx, ty) owns word column tx and rows ty + kThreadRowsT * r.  The
// const block updates word 0 only, one row per thread.  smem holds PF's
// column strip [K][kTileWords] and the tile's selector rows.
template <int kThreadRowsT, int kRowsPerThreadT>
__device__ __forceinline__ void
rank_k_tile(uint32_t* out, const uint32_t* a, const uint32_t* __restrict__ sel,
            const uint32_t* __restrict__ pf, int rows, int wp, int kw, int word_lo,
            bool const_block, int bx, int by, int tx, int ty, uint32_t* smem) {
  constexpr int kTileRowsT = kThreadRowsT * kRowsPerThreadT;
  constexpr int nthreads = kTileWords * kThreadRowsT;
  const int K = 32 * kw;
  uint32_t* pf_s = smem;                         // [K][kTileWords]
  uint32_t* sel_s = smem + K * kTileWords;       // [kTileRowsT][kw]
  const int tid = ty * kTileWords + tx;
  const int row0 = by * kTileRowsT;

  for (int i = tid; i < kTileRowsT * kw; i += nthreads) {
    const int r = row0 + i / kw;
    sel_s[i] = r < rows ? sel[(size_t)r * kw + (i % kw)] : 0u;
  }

  if (const_block) {
    // const-word block: word 0 only, one row per thread
    for (int t = tid; t < K; t += nthreads) pf_s[t] = pf[(size_t)t * wp];
    __syncthreads();
    const int r = row0 + tid;
    if (tid < kTileRowsT && r < rows) {
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

  const int wbase = word_lo + bx * kTileWords;
  for (int i = tid; i < K * kTileWords; i += nthreads) {
    const int w = wbase + (i % kTileWords);
    pf_s[i] = w < wp ? pf[(size_t)(i / kTileWords) * wp + w] : 0u;
  }
  __syncthreads();

  const int w = wbase + tx;
  uint32_t acc[kRowsPerThreadT];
#pragma unroll
  for (int r = 0; r < kRowsPerThreadT; ++r) {
    const int row = row0 + ty + kThreadRowsT * r;
    acc[r] = (a && row < rows && w < wp) ? a[(size_t)row * wp + w] : 0u;
  }
  for (int g = 0; g < kw; ++g) {
    uint32_t s[kRowsPerThreadT];
#pragma unroll
    for (int r = 0; r < kRowsPerThreadT; ++r)
      s[r] = sel_s[(ty + kThreadRowsT * r) * kw + g];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t p = pf_s[(32 * g + b) * kTileWords + tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThreadT; ++r) acc[r] ^= p & (0u - ((s[r] >> b) & 1u));
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThreadT; ++r) {
    const int row = row0 + ty + kThreadRowsT * r;
    if (row < rows && w < wp) out[(size_t)row * wp + w] = acc[r];
  }
}

__global__ void __launch_bounds__(kTileWords * kThreadRows)
rank_k_kernel(uint32_t* out, const uint32_t* a,
              const uint32_t* __restrict__ sel, const uint32_t* __restrict__ pf,
              int rows, int wp, int kw, int word_lo, int const_word) {
  extern __shared__ uint32_t smem[];
  rank_k_tile<kThreadRows, kRowsPerThread>(
      out, a, sel, pf, rows, wp, kw, word_lo, const_word && blockIdx.x == gridDim.x - 1,
      blockIdx.x, blockIdx.y, threadIdx.x, threadIdx.y, smem);
}

// The fused update + scan's earlier design (gf2_update_scan_block):
// 1024-thread blocks, so the update tiles are 32 words x 256 rows (8 rows per
// thread keeps the tile under the 64 registers a thread of a 1024-thread
// block may use).
constexpr int kUsThreadRows = gf2::kScanThreads / kTileWords;  // 32
constexpr int kUsRowsPerThread = 8;
constexpr int kUsTileRows = kUsThreadRows * kUsRowsPerThread;   // 256

__global__ void __launch_bounds__(gf2::kScanThreads)
update_scan_block_kernel(uint32_t* a, const uint32_t* __restrict__ sel,
                         const uint32_t* __restrict__ pf, int rows, int wp, int kw,
                         int word_lo, int const_word, int gx,
                         const uint32_t* __restrict__ bTn, const int32_t* __restrict__ used_in,
                         int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                         int w0n, int cols) {
  if (blockIdx.x == 0) {  // the scan block: first in the grid, so it starts first
    gf2::scan_system(bTn, used_in, prow, used, cT, bT, rows, kw, w0n, cols);
    return;
  }
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x - 1;
  const int bx = b % gx, by = b / gx;
  rank_k_tile<kUsThreadRows, kUsRowsPerThread>(
      a, a, sel, pf, rows, wp, kw, word_lo, const_word && bx == gx - 1, bx, by,
      threadIdx.x % kTileWords, threadIdx.x / kTileWords, smem);
}

}  // namespace

// out[i] = (a ? a[i] : 0) ^ XOR_{t : bit t of sel[i]} pf[t] on the words
// {0 if const_word} U [word_lo, wp), by the mask-and-XOR tiles; out may equal a.
static cudaError_t launch_rank_k(uint32_t* out, const uint32_t* a, const uint32_t* sel,
                                 const uint32_t* pf, int rows, int wp, int kw,
                                 int word_lo, int const_word, cudaStream_t stream) {
  const int live = wp - word_lo;
  const int gx = (live + kTileWords - 1) / kTileWords + (const_word ? 1 : 0);
  const int gy = (rows + kTileRows - 1) / kTileRows;
  if (gx <= 0 || gy <= 0) return cudaGetLastError();
  const size_t smem = (size_t)(32 * kw * kTileWords + kTileRows * kw) * sizeof(uint32_t);
  rank_k_kernel<<<dim3(gx, gy), dim3(kTileWords, kThreadRows), smem, stream>>>(
      out, a, sel, pf, rows, wp, kw, word_lo, const_word);
  return cudaGetLastError();
}

// a ^= S . PF over every word (replaces pallas_update._mxu_kernel).
extern "C" int gf2_update_full(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                               int rows, int wp, int kw, cudaStream_t stream) {
  return (int)launch_table_update(a, sel, pf, rows, wp, kw, 0, 0, stream);
}

// Segmented trailing update (replaces pallas_update._mxu_kernel_seg): word 0
// and the words of tiles [dead_tiles, wp / 128) are updated; words 1..127
// and tiles [1, dead_tiles) are left as they are.
extern "C" int gf2_update_seg(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                              int rows, int wp, int kw, int dead_tiles,
                              cudaStream_t stream) {
  if (dead_tiles < 1 || 128 * dead_tiles > wp) return (int)cudaErrorInvalidValue;
  return (int)launch_table_update(a, sel, pf, rows, wp, kw, 128 * dead_tiles, 1, stream);
}

// Trailing update with a runtime panel start w0 (replaces
// pallas_update._mxu_kernel_trailing): with tw = 128 when 128 divides wp, else
// tw = wp, and tw <= w0, word 0 and the tiles from w0's tile on are updated;
// otherwise every word is.
static void trailing_range(int wp, int w0, int* word_lo, int* const_only) {
  const int tw = (wp % 128 == 0) ? 128 : wp;
  *const_only = tw <= w0;
  *word_lo = *const_only ? (w0 / tw) * tw : 0;
}

extern "C" int gf2_update_trailing(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                   int rows, int wp, int kw, int w0,
                                   cudaStream_t stream) {
  if (w0 < 0 || w0 >= wp) return (int)cudaErrorInvalidValue;
  int word_lo, const_only;
  trailing_range(wp, w0, &word_lo, &const_only);
  return (int)launch_table_update(a, sel, pf, rows, wp, kw, word_lo, const_only, stream);
}

// The mask-and-XOR body on a panel update's arguments, in place on the words
// {0 if const_word} U [word_lo, wp): the earlier design of the three updates
// above, kept callable so that both can be timed on the same inputs.
extern "C" int gf2_update_rank_k(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                 int rows, int wp, int kw, int word_lo, int const_word,
                                 cudaStream_t stream) {
  if (word_lo < 0 || word_lo > wp) return (int)cudaErrorInvalidValue;
  return (int)launch_rank_k(a, a, sel, pf, rows, wp, kw, word_lo,
                            const_word && word_lo > 0, stream);
}

// The update of panel t fused with the scan of panel t+1 (replaces
// pallas_update._make_mxu_scan_kernel, launched by panel_update_mxu_scan):
// the update of a on the words {0 if const_word} U [word_lo, wp) (the
// wrapper's trailing or full rule), and in the same launch the 1-pivot scan
// (gf2_scan) of bTn, the next panel's slice already carrying this update, at
// word w0n, on a cluster of nblocks blocks (the scan's route).  Returns an
// error, and launches nothing, when the slice does not fit the cluster or the
// card cannot place it.
extern "C" int gf2_update_scan(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                               int rows, int wp, int kw, int word_lo, int const_word,
                               const uint32_t* bTn, const int32_t* used_in, int32_t* prow,
                               int32_t* used_out, uint32_t* cT, int w0n, int cols,
                               int nblocks, cudaStream_t stream) {
  gf2::ScanGeometry g;
  if (!gf2::scan_geometry(rows, kw, nblocks, &g)) return (int)cudaErrorInvalidValue;
  const gf2::UpdatePart up = {a, sel, pf, rows, wp, kw, word_lo, {}};
  const gf2::ScanPart sc = {bTn, used_in, prow, used_out, cT, w0n, cols,
                            g.rpb, g.rpb_pad, nblocks, rows};
  return (int)gf2::launch_update_scan_by_slots<false>(up, const_word, sc, g, gf2::ScanChain{},
                                                      stream);
}

// The same function by the earlier design: block 0 the one-block scan with
// its state in global memory (bT_work (kw, rows) its working copy), blocks 1..
// the mask-and-XOR tiles.
extern "C" int gf2_update_scan_block(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                     int rows, int wp, int kw, int word_lo, int const_word,
                                     const uint32_t* bTn, const int32_t* used_in,
                                     int32_t* prow, int32_t* used_out, uint32_t* cT,
                                     uint32_t* bT_work, int w0n, int cols,
                                     cudaStream_t stream) {
  if (kw < 1 || kw > gf2::kMaxKw || word_lo < 0 || word_lo > wp || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int const_only = const_word && word_lo > 0;
  const int gx = (wp - word_lo + kTileWords - 1) / kTileWords + const_only;
  const int gy = (rows + kUsTileRows - 1) / kUsTileRows;
  const size_t smem = (size_t)(32 * kw * kTileWords + kUsTileRows * kw) * sizeof(uint32_t);
  update_scan_block_kernel<<<1 + gx * gy, gf2::kScanThreads, smem, stream>>>(
      a, sel, pf, rows, wp, kw, word_lo, const_only, gx, bTn, used_in, prow, used_out, cT,
      bT_work, w0n, cols);
  return (int)cudaGetLastError();
}

extern "C" const char* gf2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
