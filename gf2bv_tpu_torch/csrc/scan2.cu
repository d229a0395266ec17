// The two-pivot scan of one K-column panel (phase 1, first half).
//
// gf2_scan2 replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel2
// (variant "2" of _call_scan_kernel): two pivots per sequential step.  It is a
// thread-block cluster of 1, 2, 4, 8 or 16 blocks (the wrapper's route, the
// 1-pivot scan's cluster size) with the slice in shared memory, and elects
// both pivots of a pair in one round of reductions and one exchange: the body
// and why that is enough are in scan2_cluster.cuh, what bounds a scan on the
// H100 in scan_cluster.cuh.
//
// gf2_scan2_block is the earlier design under its own name: ONE block of 1024
// threads with the state in global memory, each pair walking the rows through
// L2 twice (the two elections, then the sweep).  It is on no path: the slices
// taller than the largest cluster holds take the chained two-pivot scan
// (scan2_chunked.cu), and it is kept to be timed beside it.  The second
// pivot's row is never rewritten in the working slice (it is used from this
// step on and never read again), so the loads of its words race with no
// write.

#include "scan2_cluster.cuh"
#include "scan_system.cuh"

namespace {

using gf2::kMaxKw;
using gf2::kScanThreads;

template <bool kCluster, int kSlots>
__global__ void __launch_bounds__(gf2::kClusterThreads, 1)
scan2_cluster_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                     int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                     uint32_t* __restrict__ cT, int rows, int kw, int w0, int cols, int rpb,
                     int rpb_pad, int nb) {
  extern __shared__ uint4 smem4[];
  gf2::scan2_cluster_body<kCluster, kSlots>(bT_in, used_in, prow, used_out, cT, rows, kw, w0,
                                            cols, rpb, rpb_pad, smem4, (int)blockIdx.x, nb);
}

__global__ void __launch_bounds__(kScanThreads)
scan2_block_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                   int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                   int rows, int kw, int w0, int cols) {
  __shared__ int warp_min[kScanThreads / 32];
  __shared__ int piv_s;
  const int tid = threadIdx.x;
  gf2::scan_init(bT_in, used_in, used, cT, bT, rows, kw);

  const int K = 32 * kw;
  for (int jj0 = 0; jj0 < K; jj0 += 2) {
    const long long g0 = 32LL * w0 + jj0;
    const bool valid0 = g0 >= 1 && g0 <= cols;
    const bool valid1 = g0 + 1 >= 1 && g0 + 1 <= cols;
    const int sw = jj0 >> 5;
    const int sh0 = jj0 & 31;  // even: both columns share the word sw
    const uint32_t bit0 = 1u << sh0, bit1 = 2u << sh0;
    const uint32_t* col = bT + (size_t)sw * rows;

    // first column
    int piv0 = rows;
    if (valid0)  // block-uniform
      piv0 = gf2::block_min(gf2::first_candidate(col, used, bit0, rows), rows, warp_min, &piv_s);
    const bool has0 = piv0 < rows;
    uint32_t bp0[kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g)
      bp0[g] = (has0 && g >= sw && g < kw) ? bT[(size_t)g * rows + piv0] : 0u;
    const bool p0b1 = has0 && (col[piv0] & bit1);  // pivot 0's bit in column 1

    // second column, with pivot 0's elimination applied virtually
    int piv1 = rows;
    if (valid1) {  // block-uniform
      int mine = rows;
      for (int r = tid; r < rows; r += blockDim.x) {
        if (used[r] || r == piv0) continue;
        const uint32_t w = col[r];
        const bool elim0 = valid0 && (w & bit0);  // r is a column-0 candidate, not its pivot
        if (((w & bit1) != 0) != (elim0 && p0b1)) {
          mine = r;
          break;
        }
      }
      piv1 = gf2::block_min(mine, rows, warp_min, &piv_s);
    }
    const bool has1 = piv1 < rows;
    if (tid == 0) {
      prow[jj0] = has0 ? piv0 : -1;
      prow[jj0 + 1] = has1 ? piv1 : -1;
    }
    if (!has0 && !has1) continue;  // block-uniform

    // pivot 1's row, corrected by pivot 0 where pivot 0 eliminates it
    uint32_t bp1[kMaxKw];
    const bool e0p1 = has1 && valid0 && (col[has1 ? piv1 : 0] & bit0);
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g)
      bp1[g] = (has1 && g >= sw && g < kw)
                   ? bT[(size_t)g * rows + piv1] ^ (e0p1 ? bp0[g] : 0u)
                   : 0u;

    // one fused sweep: both eliminations, both coefficient bits
    for (int r = tid; r < rows; r += blockDim.x) {
      if (used[r] || r == piv0) {
        if (r == piv0) used[r] = 1;
        continue;
      }
      const uint32_t w = col[r];
      const bool e0 = valid0 && (w & bit0);
      if (r == piv1) {  // used from here on: only its coefficient bit matters
        if (e0) cT[(size_t)sw * rows + r] ^= bit0;
        used[r] = 1;
        continue;
      }
      const bool e1 = valid1 && (((w & bit1) != 0) != (e0 && p0b1));
      if (!e0 && !e1) continue;
#pragma unroll
      for (int g = 0; g < kMaxKw; ++g)
        if (g >= sw && g < kw)
          bT[(size_t)g * rows + r] ^= (e0 ? bp0[g] : 0u) ^ (e1 ? bp1[g] : 0u);
      cT[(size_t)sw * rows + r] ^= (e0 ? bit0 : 0u) | (e1 ? bit1 : 0u);
    }
  }
}

struct Scan2Call {
  const uint32_t* bT_in;
  const int32_t* used_in;
  int32_t* prow;
  int32_t* used_out;
  uint32_t* cT;
  int rows, kw, w0, cols, nblocks;
  cudaStream_t stream;
};

template <bool kCluster, int kSlots>
cudaError_t launch_scan2_cluster(const Scan2Call& c, const gf2::ScanGeometry& g) {
  static gf2::ClusterLaunchState state;
  auto kernel = scan2_cluster_kernel<kCluster, kSlots>;
  cudaError_t rc = gf2::prepare_cluster_launch(kernel, &state, c.nblocks, g.smem, c.stream);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gf2::cluster_config(&cfg, &attr, c.nblocks, c.nblocks, g.smem, c.stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, c.bT_in, c.used_in, c.prow, c.used_out, c.cT, c.rows,
                          c.kw, c.w0, c.cols, g.rpb, g.rpb_pad, c.nblocks);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// Returns an error, and launches nothing, when the state does not fit the
// blocks or the card cannot place such a cluster.
cudaError_t scan2_cluster(const Scan2Call& c) {
  gf2::ScanGeometry g;
  if (!gf2::scan_geometry(c.rows, c.kw, c.nblocks, &g, gf2::kScan2HeaderQuads))
    return cudaErrorInvalidValue;
#define GF2_SCAN2_SLOTS(n)                                      \
  if (g.slots <= n)                                             \
    return c.nblocks == 1 ? launch_scan2_cluster<false, n>(c, g) \
                          : launch_scan2_cluster<true, n>(c, g);
  GF2_SCAN2_SLOTS(1)
  GF2_SCAN2_SLOTS(2)
  GF2_SCAN2_SLOTS(3)
  GF2_SCAN2_SLOTS(5)
  GF2_SCAN2_SLOTS(gf2::kMaxSlots)
#undef GF2_SCAN2_SLOTS
  return cudaErrorInvalidValue;
}

}  // namespace

// The two-pivot cluster scan on nblocks blocks (1, 2, 4, 8 or 16; the
// wrapper's route).
extern "C" int gf2_scan2(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                         int32_t* used_out, uint32_t* cT, int rows, int kw, int w0, int cols,
                         int nblocks, cudaStream_t stream) {
  return (int)scan2_cluster(
      {bT_in, used_in, prow, used_out, cT, rows, kw, w0, cols, nblocks, stream});
}

// The one-block two-pivot scan with its state in global memory; bT_work
// (kw, rows) is its working copy of the slice.
extern "C" int gf2_scan2_block(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                               int32_t* used_out, uint32_t* cT, uint32_t* bT_work, int rows,
                               int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw) return (int)cudaErrorInvalidValue;
  scan2_block_kernel<<<1, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT,
                                                     bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}
