// The two-pivot scan of one K-column panel (phase 1, first half).
//
// gf2_scan2 replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel2
// (variant "2" of _call_scan_kernel): two pivots per sequential step.  It is a
// thread-block cluster of 1, 2, 4, 8 or 16 blocks (the wrapper's route, the
// 1-pivot scan's cluster size) with the slice in shared memory, and elects
// both pivots of a pair in one round of reductions and one exchange: the body
// and why that is enough are in scan2_cluster.cuh, what bounds a scan on the
// H100 in scan_cluster.cuh.  Slices taller than the largest cluster holds
// take the chained two-pivot scan (scan2_chunked.cu).

#include "scan2_cluster.cuh"

namespace {

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
