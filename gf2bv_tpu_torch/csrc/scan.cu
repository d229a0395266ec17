// Forward pivot scans of one K-column panel (phase 1, first half).
//
// gf2_scan replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel
// (launched by _call_scan_kernel, variant "", from phase1_panel_split).  The
// contract every scan here keeps is in scan_cluster.cuh: in bT (kw, rows),
// used (rows,), w0, cols; out prow (K,), used' (rows,), cT (kw, rows); the
// pivot of a column is the lowest unused row with the bit set.
//
// gf2_scan is a thread-block cluster that holds the whole state in shared
// memory: the body, what bounds a scan on the H100 and what the design does
// about it are in scan_cluster.cuh.  The wrapper picks the cluster's size (1,
// 2, 4, 8 or 16 blocks) from (rows, kw); slices taller than the largest
// cluster holds take the chained scan (scan_chunked.cu).
//
// The batched scan (gf2_scan_batched) replaces
// gf2bv_tpu/ops/gauss_batched.py: _make_scan_kernel_b (launched by
// _scan_batched): the same scan over B independent systems, bT (B, kw, rows),
// used (B, rows) -> prow (B, K), used' (B, rows), cT (B, kw, rows).  The TPU
// kernel advances all B systems in each sequential step to share the cost of
// a step's cross-lane reductions.  Here the systems share nothing, so each
// gets a cluster of its own in ONE launch: a grid of B x nb blocks in
// clusters of nb, cluster blockIdx.x / nb taking system b and offsetting the
// global pointers once (the state lives in shared memory, so the offsets have
// no loop to land in).  Clusters never meet, so any number may be resident
// and the rest wait their turn; the wrapper picks nb from (B, rows, kw) so
// that the B clusters fit the card's SMs at once where they can.  gf2_scan is
// the same kernel with B = 1.
//
// The two-pivot scan (gf2_scan2) lives in scan2.cu, built by an nvcc of its
// own beside this file.
//
// gf2_scan_minkey replaces pallas_phase1.py: _make_scan_kernel_minkey
// (variant "m"): election and extraction in one reduction round.  Each thread
// forms int32 keys (row << 16 | 16-bit half) of its first candidate for every
// live slice word; the 2*(kw - sw) minima, independent __reduce_min_sync
// reductions issued together, all land on the lowest candidate row and carry
// its words.  The pivot row's words then come out of the reduction instead of
// a dependent load after it.  The no-candidate sentinel rows << 16 needs
// rows < 2^15; the wrapper sends taller systems to gf2_scan, as the
// reference's _call_scan_kernel does.  It is the kernel of gf2_scan with the
// min-key election (scan_cluster_body's kMinKey): a block's lowest
// candidate, as its 16 keys, is the block's slot of the exchange, and the
// least keys over the slots elect the pivot and carry its words in every
// block.  Every slice it takes (rows < 2^15) fits a cluster.

#include "scan_cluster.cuh"

namespace {

// The cluster scan over `batch` systems: the grid is batch clusters of nb
// blocks (plain blocks when nb == 1), and cluster blockIdx.x / nb scans system
// blockIdx.x / nb.  kMinKey: the min-key election.  skip_if: null, or a word
// that makes the launch return at once where it is nonzero.
template <bool kCluster, int kSlots, bool kMinKey>
__global__ void __launch_bounds__(gf2::kClusterThreads, 1)
scan_cluster_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                    int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                    uint32_t* __restrict__ cT, int rows, int kw, int w0, int cols, int rpb,
                    int rpb_pad, int nb, const int32_t* __restrict__ skip_if) {
  // the subset-first scan's fallback: every block reads the same word, so the
  // whole grid returns before the body's first cluster barrier
  if (skip_if != nullptr && *skip_if != 0) return;
  extern __shared__ uint4 smem4[];
  const int b = blockIdx.x / nb;
  const size_t slice = (size_t)kw * rows;  // words of one system's bT / cT
  gf2::scan_cluster_body<kCluster, kSlots, kMinKey>(
      bT_in + b * slice, used_in + (size_t)b * rows, prow + b * 32 * kw,
      used_out + (size_t)b * rows, cT + b * slice, rows, kw, w0, cols, rpb, rpb_pad, smem4,
      (int)blockIdx.x - b * nb, nb);
}

// One call of the cluster scan: `batch` systems on clusters of nblocks blocks
// each, by the 1-pivot or the min-key election.  max_clusters set: launch
// nothing, only report how many such clusters the card holds at once.
// skip_if: as scan_cluster_kernel's.
struct ScanCall {
  const uint32_t* bT_in;
  const int32_t* used_in;
  int32_t* prow;
  int32_t* used_out;
  uint32_t* cT;
  int batch, rows, kw, w0, cols, nblocks;
  cudaStream_t stream;
  int* max_clusters;
  bool minkey;
  const int32_t* skip_if = nullptr;
};

template <bool kCluster, int kSlots, bool kMinKey>
cudaError_t launch_scan_cluster(const ScanCall& c, const gf2::ScanGeometry& g) {
  static gf2::ClusterLaunchState state;
  auto kernel = scan_cluster_kernel<kCluster, kSlots, kMinKey>;
  cudaError_t rc = gf2::prepare_cluster_launch(kernel, &state, c.nblocks, g.smem, c.stream);
  if (rc != cudaSuccess) return rc;
  if (c.max_clusters) {
    *c.max_clusters = state.max_clusters[c.nblocks];
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gf2::cluster_config(&cfg, &attr, c.batch * c.nblocks, c.nblocks, g.smem, c.stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, c.bT_in, c.used_in, c.prow, c.used_out, c.cT, c.rows,
                          c.kw, c.w0, c.cols, g.rpb, g.rpb_pad, c.nblocks, c.skip_if);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// Returns an error, and launches nothing, when the state does not fit the
// blocks or the card cannot place such a cluster.
template <bool kMinKey>
cudaError_t scan_clusters_by(const ScanCall& c) {
  gf2::ScanGeometry g;
  if (c.batch < 1 ||
      !gf2::scan_geometry(c.rows, c.kw, c.nblocks, &g, gf2::scan_header_quads<kMinKey>()))
    return cudaErrorInvalidValue;
#define GF2_SCAN_SLOTS(n)                                                \
  if (g.slots <= n)                                                      \
    return c.nblocks == 1 ? launch_scan_cluster<false, n, kMinKey>(c, g) \
                          : launch_scan_cluster<true, n, kMinKey>(c, g);
  GF2_SCAN_SLOTS(1)
  GF2_SCAN_SLOTS(2)
  GF2_SCAN_SLOTS(3)
  GF2_SCAN_SLOTS(5)
  GF2_SCAN_SLOTS(gf2::kMaxSlots)
#undef GF2_SCAN_SLOTS
  return cudaErrorInvalidValue;
}

cudaError_t scan_clusters(const ScanCall& c) {
  return c.minkey ? scan_clusters_by<true>(c) : scan_clusters_by<false>(c);
}

}  // namespace

// The cluster scan on nblocks blocks (1, 2, 4, 8 or 16; the wrapper's route).
extern "C" int gf2_scan(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                        int32_t* used_out, uint32_t* cT, int rows, int kw, int w0, int cols,
                        int nblocks, cudaStream_t stream) {
  return (int)scan_clusters({bT_in, used_in, prow, used_out, cT, 1, rows, kw, w0, cols,
                             nblocks, stream, nullptr, false});
}

cudaError_t gf2::scan_cluster_gated(const uint32_t* bT_in, const int32_t* used_in,
                                    int32_t* prow, int32_t* used_out, uint32_t* cT, int rows,
                                    int kw, int w0, int cols, int nblocks,
                                    const int32_t* skip_if, cudaStream_t stream) {
  ScanCall c{bT_in, used_in, prow, used_out, cT, 1, rows, kw, w0, cols, nblocks, stream,
             nullptr, false};
  c.skip_if = skip_if;
  return scan_clusters(c);
}

// The batched scan: `batch` clusters of nblocks blocks in one launch.
extern "C" int gf2_scan_batched(const uint32_t* bT_in, const int32_t* used_in,
                                int32_t* prow, int32_t* used_out, uint32_t* cT, int batch,
                                int rows, int kw, int w0, int cols, int nblocks,
                                cudaStream_t stream) {
  return (int)scan_clusters({bT_in, used_in, prow, used_out, cT, batch, rows, kw, w0, cols,
                             nblocks, stream, nullptr, false});
}

// How many clusters of nblocks blocks, each holding a (kw, rows) slice, the
// card can have resident at once (cudaOccupancyMaxActiveClusters; for one
// block, blocks per SM x SMs), written to *out.
extern "C" int gf2_scan_occupancy(int rows, int kw, int nblocks, int* out) {
  return (int)scan_clusters({nullptr, nullptr, nullptr, nullptr, nullptr, 1, rows, kw, 0, 0,
                             nblocks, nullptr, out, false});
}

// The min-key scan on a cluster of nblocks blocks (1, 2, 4, 8 or 16; the
// wrapper's route); rows < 2^15.
extern "C" int gf2_scan_minkey(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                               int32_t* used_out, uint32_t* cT, int rows, int kw, int w0,
                               int cols, int nblocks, cudaStream_t stream) {
  if (rows >= (1 << 15)) return (int)cudaErrorInvalidValue;
  return (int)scan_clusters({bT_in, used_in, prow, used_out, cT, 1, rows, kw, w0, cols,
                             nblocks, stream, nullptr, true});
}
