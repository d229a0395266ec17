// Forward pivot scans of one K-column panel (phase 1, first half).
//
// gf2_scan replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel
// (launched by _call_scan_kernel, variant "", from phase1_panel_split).  The
// contract every scan here keeps is in scan_system.cuh: in bT (kw, rows),
// used (rows,), w0, cols; out prow (K,), used' (rows,), cT (kw, rows); the
// pivot of a column is the lowest unused row with the bit set.
//
// gf2_scan is a thread-block cluster that holds the whole state in shared
// memory: the body, what bounds a scan on the H100 and what the design does
// about it are in scan_cluster.cuh.  The wrapper picks the cluster's size (1,
// 2, 4, 8 or 16 blocks) from (rows, kw).
//
// gf2_scan_block is the earlier design under its own name: ONE block of 1024
// threads striding over the rows with the state in global memory (scan_system
// in scan_system.cuh; 7.5 us per step on 20224 rows where the cluster takes
// 0.85).  It takes the systems whose rows exceed what the largest cluster
// holds in shared memory.
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
// the same kernel with B = 1.  gf2_scan_batched_block is the earlier design:
// one block of 1024 threads per system with the state in global memory, for
// rows past the largest cluster.
//
// The two-pivot scan (gf2_scan2, gf2_scan2_block) lives in scan2.cu, built by
// an nvcc of its own beside this file.
//
// gf2_scan_minkey replaces pallas_phase1.py: _make_scan_kernel_minkey
// (variant "m"): election and extraction in one reduction round.  Each thread
// forms int32 keys (row << 16 | 16-bit half) of its first candidate for every
// live slice word; the 2*(kw - sw) minima, independent __reduce_min_sync
// reductions issued together, all land on the lowest candidate row and carry
// its words.  The pivot row's words then come out of the reduction instead of
// a dependent load after it.  The no-candidate sentinel rows << 16 needs
// rows < 2^15; the wrapper sends taller systems to gf2_scan, as the
// reference's _call_scan_kernel does.  Since the min-key scan became a
// cluster kernel it is the kernel of gf2_scan with the min-key election
// (scan_cluster_body's kMinKey): a block's lowest candidate, as its 16 keys,
// is the block's slot of the exchange, and the least keys over the slots
// elect the pivot and carry its words in every block.  Every slice it takes (rows < 2^15)
// fits a cluster.  gf2_scan_minkey_block is the earlier one-block kernel with
// its state in global memory: on no solve's path, kept so that both can be
// timed on the same inputs.

#include "scan_cluster.cuh"
#include "scan_system.cuh"

namespace {

using gf2::kMaxKw;
using gf2::kScanThreads;

// One system, one block, state in global memory; the pointers stay kernel
// parameters.  (Offsetting them by blockIdx.x here as well cost 17% per
// step: 2.25 against 1.93 ms per flagship panel on the H100.)
__global__ void __launch_bounds__(kScanThreads)
scan_block_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                  int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                  int rows, int kw, int w0, int cols) {
  gf2::scan_system(bT_in, used_in, prow, used, cT, bT, rows, kw, w0, cols);
}

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

// B systems, one block each with its state in global memory; block b takes
// system b.
__global__ void __launch_bounds__(kScanThreads)
scan_batched_block_kernel(const uint32_t* __restrict__ bT_in,
                          const int32_t* __restrict__ used_in, int32_t* __restrict__ prow,
                          int32_t* used, uint32_t* cT, uint32_t* bT, int rows, int kw, int w0,
                          int cols) {
  const size_t slice = (size_t)kw * rows;  // words of one system's bT / cT
  const size_t b = blockIdx.x;
  gf2::scan_system(bT_in + b * slice, used_in + b * rows, prow + b * 32 * kw,
                   used + b * rows, cT + b * slice, bT + b * slice, rows, kw, w0, cols);
}

__global__ void __launch_bounds__(kScanThreads)
scan_minkey_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                   int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                   int rows, int kw, int w0, int cols) {
  __shared__ int warp_keys[kScanThreads / 32][2 * kMaxKw];
  __shared__ int keys_s[2 * kMaxKw];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x / 32;
  const int none = rows << 16;  // sentinel above every candidate's key
  gf2::scan_init(bT_in, used_in, used, cT, bT, rows, kw);

  const int K = 32 * kw;
  for (int jj = 0; jj < K; ++jj) {
    const long long gbit = 32LL * w0 + jj;
    if (gbit < 1 || gbit > cols) {  // block-uniform: no pivot, no barrier
      if (tid == 0) prow[jj] = -1;
      continue;
    }
    const int sw = jj >> 5;
    const uint32_t bit = 1u << (jj & 31);
    const uint32_t* col = bT + (size_t)sw * rows;

    const int mine = gf2::first_candidate(col, used, bit, rows);
    // keys of this thread's candidate, one lo and one hi per live word
    const bool cand = mine < rows;
    int key[2 * kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g) {
      const uint32_t v = (cand && g >= sw && g < kw) ? bT[(size_t)g * rows + mine] : 0u;
      key[2 * g] = cand ? (mine << 16) | (int)(v & 0xFFFFu) : none;
      key[2 * g + 1] = cand ? (mine << 16) | (int)(v >> 16) : none;
    }
#pragma unroll
    for (int i = 0; i < 2 * kMaxKw; ++i) {
      if (i >= 2 * sw && i < 2 * kw) {  // warp-uniform
        const int m = __reduce_min_sync(0xffffffffu, key[i]);
        if (lane == 0) warp_keys[warp][i] = m;
      }
    }
    __syncthreads();
    // warp i reduces key i over the warps' minima
    if (warp >= 2 * sw && warp < 2 * kw) {
      int m = lane < nwarps ? warp_keys[lane][warp] : none;
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) keys_s[warp] = m;
    }
    __syncthreads();
    const int piv = keys_s[2 * sw] >> 16;  // rows when there is no candidate
    if (tid == 0) prow[jj] = piv < rows ? piv : -1;
    if (piv >= rows) continue;  // block-uniform

    uint32_t bp[kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g)
      bp[g] = (g >= sw && g < kw)
                  ? ((uint32_t)(keys_s[2 * g + 1] & 0xFFFF) << 16) |
                        (uint32_t)(keys_s[2 * g] & 0xFFFF)
                  : 0u;
    gf2::eliminate(col, used, cT, bT, bp, bit, sw, piv, rows, kw);
  }
}

}  // namespace

namespace {

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

// The one-block scan with its state in global memory; bT_work (kw, rows) is
// its working copy of the slice.
extern "C" int gf2_scan_block(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                              int32_t* used_out, uint32_t* cT, uint32_t* bT_work, int rows,
                              int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw) return (int)cudaErrorInvalidValue;
  scan_block_kernel<<<1, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT,
                                                    bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}

// The batched scan: `batch` clusters of nblocks blocks in one launch.
extern "C" int gf2_scan_batched(const uint32_t* bT_in, const int32_t* used_in,
                                int32_t* prow, int32_t* used_out, uint32_t* cT, int batch,
                                int rows, int kw, int w0, int cols, int nblocks,
                                cudaStream_t stream) {
  return (int)scan_clusters({bT_in, used_in, prow, used_out, cT, batch, rows, kw, w0, cols,
                             nblocks, stream, nullptr, false});
}

// The batched scan by one block per system with the state in global memory;
// bT_work (batch, kw, rows) is the working copy of the slices.
extern "C" int gf2_scan_batched_block(const uint32_t* bT_in, const int32_t* used_in,
                                      int32_t* prow, int32_t* used_out, uint32_t* cT,
                                      uint32_t* bT_work, int batch, int rows, int kw, int w0,
                                      int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || batch < 1) return (int)cudaErrorInvalidValue;
  scan_batched_block_kernel<<<batch, kScanThreads, 0, stream>>>(
      bT_in, used_in, prow, used_out, cT, bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
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

// The min-key scan by one block with its state in global memory; bT_work
// (kw, rows) is its working copy of the slice.
extern "C" int gf2_scan_minkey_block(const uint32_t* bT_in, const int32_t* used_in,
                                     int32_t* prow, int32_t* used_out, uint32_t* cT,
                                     uint32_t* bT_work, int rows, int kw, int w0, int cols,
                                     cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || rows >= (1 << 15)) return (int)cudaErrorInvalidValue;
  scan_minkey_kernel<<<1, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT,
                                                     bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}
