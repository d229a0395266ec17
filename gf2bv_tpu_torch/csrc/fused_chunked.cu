// The two fused kernels for slices taller than the largest cluster holds
// (65536 rows at K = 256), each a chain of cluster launches over row chunks
// built on the chained scan (scan_chunked.cu, where the chain and why it is
// exact are described): one launch a chunk, in order on the stream, with a
// record of the columns the earlier chunks took.  Each fuses its other stage
// into one link of the chain, so a panel takes as many launches as chunks.
//
// gf2_phase1_fused_chunked replaces gf2bv_tpu/ops/pallas_phase1.py:
// _make_kernel (phase1_panel, the "pallas" engine) past one cluster.  Same
// contract as gf2_phase1_fused: in a (rows, wp), bT (kw, rows), used (rows,),
// w0, cols; out pf (K, wp) the panel's RREF pivot rows, prow (K,), used'
// (rows,), cT (kw, rows).
//   * Launches 0 .. C-2 are the chained scan's plain links.
//   * The last launch is the link followed by the fused phase 1's product
//     stages (phase1_product_body: the blocked coefficient solve in every
//     block, then pf = T . a[prow] with pf's 4-word strips spread over the
//     link's blocks).  Those stages read prow and cT through prow, and the
//     pivots may lie in any chunk: an earlier chunk's prow and cT entries were
//     written by an earlier launch, which the stream orders before this one;
//     the last link's own are published by the scan body's closing cluster
//     barrier (release and acquire at cluster scope), or a __syncthreads with
//     one block, as in the cluster kernel.  So no barrier is added.  The
//     product stages start after the chained header (election header and
//     record), so nothing the link used is overwritten before that barrier.
//
// gf2_update_scan_chunked replaces gf2bv_tpu/ops/pallas_update.py:
// _make_mxu_scan_kernel (panel_update_mxu_scan, the "mxu_la" engine) past one
// cluster.  Same contract as
// gf2_update_scan: the rank-K update of a on the words {0 if const_word} U
// [word_lo, wp), and the 1-pivot scan of the next slice bTn at w0n.  The two
// parts share no data (the scan reads the separate, already-updated bTn), so
// every launch is the fused update + scan's layout (update_scan.cuh): cluster
// 0 runs link c of the chain, the other clusters the table update of a share
// of the matrix's rows on the SMs beside it (a link with no share is a plain
// link).  Link 0 is the chain's long one (its columns are all elected; the
// later links mostly sweep the record's pivots), so it takes the most rows:
// first_rows (the wrapper's rule: three quarters), the rest in equal parts
// beside the later links.  At the very tall panel the whole update on the SMs
// beside a 16-block cluster (0.38-0.44 ms: those clusters of 16 are placed a
// GPC at a time) outlasts link 0 (0.28 ms), so all of it beside link 0 took
// 0.475 ms where three quarters take 0.423 (full width).
//
// What bounds both on the H100: latency, as the chained scan: K dependent
// steps of chunk 0's election (~1.1 us a step on 16 blocks with 5 rows a
// thread), then the later links; the phase 1 adds the solve and the product
// of the cluster kernel (~0.08 ms on 16 blocks).  The bytes (the slice, the K
// pivot rows and pf; for the update the matrix read and written once) take
// 0.002 ms and 0.05 ms at the very tall shape.
//
// No fallback: every chunk's geometry (and the product's shared memory) is
// checked before the first launch; a refused launch returns its code.

#include "phase1_product.cuh"
#include "scan_chunked.cuh"
#include "scan_cluster.cuh"
#include "update_scan.cuh"

namespace {

// The last link of the fused phase 1: chunk [base, base + nrows) of the
// (kw, rows) slice on one cluster of nb = gridDim.x blocks (plain when
// nb == 1), then the product stages.
template <bool kCluster, int kSlots>
__global__ void __launch_bounds__(gf2::kClusterThreads, 1)
phase1_last_link_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bT_in,
                        const int32_t* __restrict__ used_in, int32_t* prow, int32_t* used_out,
                        uint32_t* cT, int32_t* record, uint32_t* __restrict__ pf, int rows,
                        int wp, int kw, int w0, int cols, int base, int nrows, int rpb,
                        int rpb_pad, int nstrips, int aligned) {
  extern __shared__ uint4 smem4[];
  const int nb = (int)gridDim.x, rank = (int)blockIdx.x;
  gf2::ScanChain chain;
  chain.record = record;
  chain.ld = rows;
  chain.base = base;
  chain.first = base == 0;
  gf2::scan_cluster_body<kCluster, kSlots, false, true>(
      bT_in + base, used_in + base, prow, used_out + base, cT + base, nrows, kw, w0, cols, rpb,
      rpb_pad, smem4, rank, nb, chain);
  if (!kCluster) __syncthreads();
  gf2::phase1_product_body(a, cT, prow, pf, rows, wp, kw, w0, nstrips, aligned,
                           smem4 + gf2::kChainHeaderQuads, rank, nb);
}

size_t last_link_smem(const gf2::ScanGeometry& g, int kw) {
  const size_t product = sizeof(uint4) * gf2::kChainHeaderQuads + gf2::fused_product_bytes(kw);
  return g.smem > product ? g.smem : product;
}

template <bool kCluster, int kSlots>
cudaError_t launch_last_link(const gf2::ChunkCall& c, const uint32_t* a, uint32_t* pf, int wp,
                             int base, int nrows, int nb, const gf2::ScanGeometry& g) {
  static gf2::ClusterLaunchState state;
  auto kernel = phase1_last_link_kernel<kCluster, kSlots>;
  const size_t smem = last_link_smem(g, c.kw);
  cudaError_t rc = gf2::prepare_cluster_launch(kernel, &state, nb, smem, c.stream);
  if (rc != cudaSuccess) return rc;
  const int nstrips = (wp + gf2::kStrip - 1) / gf2::kStrip;
  const int aligned = wp % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(pf) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gf2::cluster_config(&cfg, &attr, nb, nb, smem, c.stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, a, c.bT_in, c.used_in, c.prow, c.used_out, c.cT,
                          c.record, pf, c.rows, wp, c.kw, c.w0, c.cols, base, nrows, g.rpb,
                          g.rpb_pad, nstrips, aligned);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

cudaError_t phase1_fused_chunked(const gf2::ChunkCall& c, const uint32_t* a, uint32_t* pf,
                                 int wp) {
  if (c.w0 < 0 || c.w0 + c.kw > wp || !gf2::chain_fits(c)) return cudaErrorInvalidValue;
  const int last = gf2::last_chunk_base(c);
  int nrows, nb;
  gf2::ScanGeometry g;
  gf2::chunk_geometry(c, last, &nrows, &nb, &g);
  if (last_link_smem(g, c.kw) > gf2::kMaxBlockSmem) return cudaErrorInvalidValue;
  for (int base = 0; base < last; base += c.chunk_rows) {
    const cudaError_t rc = gf2::launch_chain_link(c, base);
    if (rc != cudaSuccess) return rc;
  }
#define GF2_LAST_SLOTS(n)                                                     \
  if (g.slots <= n)                                                           \
    return nb == 1 ? launch_last_link<false, n>(c, a, pf, wp, last, nrows, nb, g) \
                   : launch_last_link<true, n>(c, a, pf, wp, last, nrows, nb, g);
  GF2_LAST_SLOTS(1)
  GF2_LAST_SLOTS(2)
  GF2_LAST_SLOTS(3)
  GF2_LAST_SLOTS(5)
  GF2_LAST_SLOTS(gf2::kMaxSlots)
#undef GF2_LAST_SLOTS
  return cudaErrorInvalidValue;
}

// Link i runs beside the update of rows [lo_i, lo_{i+1}) of the matrix:
// lo_1 = first_rows, the rest in equal parts over the later links; a link
// with no rows of the update is a plain link.
cudaError_t update_scan_chunked(const gf2::ChunkCall& c, const gf2::UpdatePart& up,
                                int const_word, int first_rows) {
  if (!gf2::chain_fits(c) || first_rows < 1 || first_rows > c.rows || up.word_lo < 0 ||
      up.word_lo > up.wp)
    return cudaErrorInvalidValue;
  const int links = (c.rows + c.chunk_rows - 1) / c.chunk_rows;
  if (links == 1) first_rows = c.rows;
  cudaError_t rc = cudaSuccess;
  int lo = 0;
  for (int i = 0, base = 0; rc == cudaSuccess && base < c.rows; ++i, base += c.chunk_rows) {
    const int hi =
        i == 0 ? first_rows
               : first_rows + (int)((long long)(c.rows - first_rows) * i / (links - 1));
    if (hi == lo) {
      rc = gf2::launch_chain_link(c, base);
      continue;
    }
    int nrows, nb;
    gf2::ScanGeometry g;
    gf2::chunk_geometry(c, base, &nrows, &nb, &g);
    gf2::UpdatePart part = up;
    part.a = up.a + (size_t)lo * up.wp;
    part.sel = up.sel + (size_t)lo * up.kw;
    part.rows = hi - lo;
    const gf2::ScanPart sc = {c.bT_in + base, c.used_in + base, c.prow, c.used_out + base,
                              c.cT + base, c.w0, c.cols, g.rpb, g.rpb_pad, nb, nrows};
    gf2::ScanChain chain;
    chain.record = c.record;
    chain.ld = c.rows;
    chain.base = base;
    chain.first = base == 0;
    rc = gf2::launch_update_scan_by_slots<true>(part, const_word, sc, g, chain, c.stream);
    lo = hi;
  }
  return rc;
}

}  // namespace

// The fused phase 1 as a chain over chunks of chunk_rows rows, each on a
// cluster of nblocks blocks but the last, on nblocks_last (the wrapper's
// route).  cT (kw, rows) receives the scan's coefficients; record: scratch of
// 9 K words.  Returns an error, and launches nothing, when a chunk does not
// fit its cluster.
extern "C" int gf2_phase1_fused_chunked(const uint32_t* a, const uint32_t* bT_in,
                                        const int32_t* used_in, int32_t* prow,
                                        int32_t* used_out, uint32_t* cT, int32_t* record,
                                        uint32_t* pf, int rows, int wp, int kw, int w0,
                                        int cols, int chunk_rows, int nblocks,
                                        int nblocks_last, cudaStream_t stream) {
  return (int)phase1_fused_chunked({bT_in, used_in, prow, used_out, cT, record, 1, rows, kw,
                                    w0, cols, chunk_rows, nblocks, nblocks_last, stream},
                                   a, pf, wp);
}

// The update of a on the words {0 if const_word} U [word_lo, wp) (the
// wrapper's trailing or full rule) fused with the chained scan of bTn, the
// next panel's slice already carrying this update, at word w0n: rows
// [0, first_rows) of the update beside the first link, the rest spread over
// the later links (first_rows = rows: all of it beside the first).  record:
// scratch of 9 K words.  Returns an error, and launches nothing, when a chunk
// does not fit its cluster.
extern "C" int gf2_update_scan_chunked(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                       int rows, int wp, int kw, int word_lo, int const_word,
                                       const uint32_t* bTn, const int32_t* used_in,
                                       int32_t* prow, int32_t* used_out, uint32_t* cT,
                                       int32_t* record, int w0n, int cols, int chunk_rows,
                                       int nblocks, int nblocks_last, int first_rows,
                                       cudaStream_t stream) {
  const gf2::UpdatePart up = {a, sel, pf, rows, wp, kw, word_lo, {}};
  return (int)update_scan_chunked({bTn, used_in, prow, used_out, cT, record, 1, rows, kw, w0n,
                                   cols, chunk_rows, nblocks, nblocks_last, stream},
                                  up, const_word, first_rows);
}
