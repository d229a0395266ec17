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
// What bounds the update on the H100, and the body here.  The TPU form
// (int8 bit planes through the MXU) exists for the TPU's matrix unit.  Written
// for the CUDA cores as it stands, every output word takes K branch-free
// mask-and-XOR steps (about 4 INT32 operations each): at K = 256 a full
// flagship update (20224 x 640 words) is ~13 G integer operations against
// ~104 MB of device-memory traffic, bound by the INT32 pipes at 21-23x its
// byte bound.  So the first three entry points run the Four-Russians table
// kernel of update_table.cu (launch_table_update: one shared-memory table read
// per 8 selector bits), under their own rules, and so does the product
// pf = T . arows of the pivot-row rebuilds (reconstruct.cu: measured on its
// 256 rows the tables take a sixth of the time of mask-and-XOR tiles), and so
// do the update clusters of the fused update + scan.
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
// cluster.

#include "scan_cluster.cuh"
#include "update_scan.cuh"
#include "update_table.cuh"

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

extern "C" const char* gf2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
