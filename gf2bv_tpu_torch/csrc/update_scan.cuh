// The fused update + scan's launch as two sources call it: the cluster kernel
// (panel_update.cu: gf2_update_scan, where the design is described) and the
// first link of the chained kernel (fused_chunked.cu: gf2_update_scan_chunked),
// whose scan cluster runs link 0 of the chained scan on the first chunk of the
// next slice while the other clusters update the matrix.  Blocks [0, nb) are
// the scan cluster, block nb + u for u < nupdate is update block u (strip
// u % nstrips, row chunk u / nstrips), the rest pad the last cluster.
#pragma once

#include "scan_cluster.cuh"
#include "update_table.cuh"

namespace gf2 {

static_assert(kClusterThreads == kTabThreads, "one block size for both bodies");

struct UpdatePart {  // the update, cut into blocks as launch_table_update would
  uint32_t* a;
  const uint32_t* sel;
  const uint32_t* pf;
  int rows, wp, kw, word_lo;
  TableGrid grid;
};

struct ScanPart {  // the scan as gf2_scan (or a link of gf2_scan_chunked) would launch it
  const uint32_t* bTn;
  const int32_t* used_in;
  int32_t* prow;
  int32_t* used_out;
  uint32_t* cT;
  int w0n, cols, rpb, rpb_pad, nb;
  int rows;  // the rows it scans: the update's, or the chain's first chunk's
};

// kChain: the scan cluster runs the chained scan's first link (chain.first,
// chain.base = 0, chain.ld the update's rows); else the cluster scan.
template <bool kCluster, int kSlots, bool kChain>
__global__ void __launch_bounds__(kClusterThreads, 1)
update_scan_kernel(const UpdatePart up, const ScanPart sc, const ScanChain chain) {
  extern __shared__ uint4 smem4[];
  if ((int)blockIdx.x < sc.nb) {
    scan_cluster_body<kCluster, kSlots, false, kChain>(
        sc.bTn, sc.used_in, sc.prow, sc.used_out, sc.cT, sc.rows, up.kw, sc.w0n, sc.cols,
        sc.rpb, sc.rpb_pad, smem4, (int)blockIdx.x, sc.nb, chain);
    return;
  }
  const TableGrid& g = up.grid;
  const int u = (int)blockIdx.x - sc.nb;
  if (u >= g.nstrips * g.nchunks) return;
  table_update_body<false>(up.a, up.sel, up.pf, up.rows, up.wp, up.kw, up.word_lo,
                           g.const_word, g.chunk_rows, g.aligned, g.sel_vec, u % g.nstrips,
                           u / g.nstrips, smem4);
}

// const_word: the caller's; up.grid is filled here.  g: the scan's geometry
// on sc.nb blocks (with the chain's header when kChain).
template <bool kCluster, int kSlots, bool kChain>
cudaError_t launch_update_scan(UpdatePart up, int const_word, const ScanPart& sc,
                               const ScanGeometry& g, const ScanChain& chain,
                               cudaStream_t stream) {
  static ClusterLaunchState state;
  auto kernel = update_scan_kernel<kCluster, kSlots, kChain>;
  const size_t table = table_smem_bytes(up.kw);
  const size_t smem = g.smem > table ? g.smem : table;
  cudaError_t rc = prepare_cluster_launch(kernel, &state, sc.nb, smem, stream);
  int nsm = 0;
  if (rc == cudaSuccess) rc = sm_count(&nsm);
  if (rc != cudaSuccess) return rc;
  // the update's blocks run beside the scan cluster: on the blocks the card
  // holds at once in clusters of nb (at most one per SM), less the scan's
  int beside = state.max_clusters[sc.nb] * sc.nb;
  if (beside > nsm) beside = nsm;
  beside -= sc.nb;
  if (beside < 1) beside = sc.nb;  // nothing beside it: they run after it
  if (!table_grid(up.a, up.sel, up.pf, up.rows, up.wp, up.kw, up.word_lo, const_word, 1,
                  beside, &up.grid))
    return cudaErrorInvalidValue;
  const int nupdate = up.grid.nstrips * up.grid.nchunks;
  const int grid = sc.nb + (nupdate + sc.nb - 1) / sc.nb * sc.nb;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, grid, sc.nb, smem, stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, up, sc, chain);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// The launch by the scan's slot count and cluster flag.
template <bool kChain>
cudaError_t launch_update_scan_by_slots(const UpdatePart& up, int const_word,
                                        const ScanPart& sc, const ScanGeometry& g,
                                        const ScanChain& chain, cudaStream_t stream) {
#define GF2_UPDATE_SCAN_SLOTS(n)                                                          \
  if (g.slots <= n)                                                                       \
    return sc.nb == 1                                                                     \
               ? launch_update_scan<false, n, kChain>(up, const_word, sc, g, chain, stream) \
               : launch_update_scan<true, n, kChain>(up, const_word, sc, g, chain, stream);
  GF2_UPDATE_SCAN_SLOTS(1)
  GF2_UPDATE_SCAN_SLOTS(2)
  GF2_UPDATE_SCAN_SLOTS(3)
  GF2_UPDATE_SCAN_SLOTS(5)
  GF2_UPDATE_SCAN_SLOTS(kMaxSlots)
#undef GF2_UPDATE_SCAN_SLOTS
  return cudaErrorInvalidValue;
}

}  // namespace gf2
