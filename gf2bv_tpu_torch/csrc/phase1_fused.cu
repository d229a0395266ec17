// Fused phase 1 of one panel: scan, pivot-row rebuild and back pass in ONE
// kernel (the "pallas" phase-1 engine).
//
// Replaces gf2bv_tpu/ops/pallas_phase1.py: _make_kernel (launched by
// phase1_panel).  Same contract:
//   in : a (rows, wp) the matrix at the panel's start, bT (kw, rows) its
//        panel slice transposed, used (rows,), w0 (panel word offset), cols
//   out: pf (K, wp) the panel's intra-panel RREF pivot rows, prow (K,),
//        used' (rows,)
// Per pivot step the TPU kernel scans one column (kernel 1's step), DMAs the
// pivot's row a[piv] and rebuilds the forward pivot row at full width,
// pf[jj] = a[piv] ^ XOR{pf[t] : t < jj, bit t of C[piv]}; after the K steps a
// triangular back pass turns the forward rows into the panel's RREF rows.
//
// What bounds it on the H100: the scan's chain of K dependent steps (0.85 us a
// step on 20224 rows in the cluster scan; the bytes, 1.5 MB of slice and 0.66
// MB of pivot rows, take under a microsecond).  The per-step rebuild is the
// TPU's way to avoid a second pass over the pivot rows; the RREF is unique, so
// nothing needs it here.  gf2_phase1_fused is ONE launch of one thread-block
// cluster (nb blocks of 512 threads, nb the 1-pivot scan's route for (rows,
// kw)) in four stages:
//   1. the cluster scan (scan_cluster_body in scan_cluster.cuh), its state
//      in shared memory, writing prow, used' and the coefficients cT to
//      global memory;
//   2. the body's closing cluster barrier, whose arrive releases and whose
//      wait acquires at cluster scope, makes every block's prow and cT
//      visible to every block (with nb = 1, a __syncthreads);
//   3. every block solves T (pf = T . a[prow]) by itself with the rebuild's
//      blocked coefficient solve, reading the pivot rows through prow;
//   4. block r forms the strips r, r + nb, ... of pf's 4-word strips with the
//      table body, reading the pivot rows of each strip from a through prow.
// Stages 3-4 are phase1_product_body (phase1_product.cuh), which the chained
// kernel's last link (fused_chunked.cu) calls too.  The block's shared memory
// is the larger of the scan's and the scan header plus T and the larger of the
// solve's words and the tables; the product stages start after the scan's
// header, so nothing the exchange used is written again.  The coefficient
// solve is compiled for K = 256 and takes every kw, so the kernel has the
// scan's ten instantiations and no more.  Slices taller than the largest
// cluster holds take the chained kernel (fused_chunked.cu).

#include "phase1_product.cuh"
#include "scan_cluster.cuh"

namespace {

static_assert(gf2::kClusterThreads == gf2::kTabThreads, "one block size for the scan and tables");

// The grid is ONE cluster of nb = gridDim.x blocks (plain when nb == 1);
// block b has rank b.  nstrips: pf's 4-word strips; aligned: a, pf and wp
// allow 16-byte accesses.
template <bool kCluster, int kSlots>
__global__ void __launch_bounds__(gf2::kClusterThreads, 1)
phase1_fused_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bT_in,
                    const int32_t* __restrict__ used_in, int32_t* prow, int32_t* used_out,
                    uint32_t* cT, uint32_t* __restrict__ pf, int rows, int wp, int kw, int w0,
                    int cols, int rpb, int rpb_pad, int nstrips, int aligned) {
  extern __shared__ uint4 smem4[];
  const int nb = (int)gridDim.x, rank = (int)blockIdx.x;
  // 1-2. the scan; with nb > 1 its closing cluster barrier publishes prow and cT
  gf2::scan_cluster_body<kCluster, kSlots>(bT_in, used_in, prow, used_out, cT, rows, kw, w0,
                                           cols, rpb, rpb_pad, smem4, rank, nb);
  if (!kCluster) __syncthreads();

  // 3-4. T, then this block's strips of pf, after the scan's header
  gf2::phase1_product_body(a, cT, prow, pf, rows, wp, kw, w0, nstrips, aligned,
                           smem4 + gf2::kScanHeaderQuads, rank, nb);
}

struct FusedCall {
  const uint32_t* a;
  const uint32_t* bT_in;
  const int32_t* used_in;
  int32_t* prow;
  int32_t* used_out;
  uint32_t* cT;
  uint32_t* pf;
  int rows, wp, kw, w0, cols, nblocks;
  cudaStream_t stream;
};

template <bool kCluster, int kSlots>
cudaError_t launch_fused(const FusedCall& c, const gf2::ScanGeometry& g) {
  static gf2::ClusterLaunchState state;
  auto kernel = phase1_fused_kernel<kCluster, kSlots>;
  const size_t product = sizeof(uint4) * gf2::kScanHeaderQuads + gf2::fused_product_bytes(c.kw);
  const size_t smem = g.smem > product ? g.smem : product;
  cudaError_t rc = gf2::prepare_cluster_launch(kernel, &state, c.nblocks, smem, c.stream);
  if (rc != cudaSuccess) return rc;
  const int nstrips = (c.wp + gf2::kStrip - 1) / gf2::kStrip;
  const int aligned = c.wp % 4 == 0 && reinterpret_cast<uintptr_t>(c.a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(c.pf) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gf2::cluster_config(&cfg, &attr, c.nblocks, c.nblocks, smem, c.stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, c.a, c.bT_in, c.used_in, c.prow, c.used_out, c.cT, c.pf,
                          c.rows, c.wp, c.kw, c.w0, c.cols, g.rpb, g.rpb_pad, nstrips, aligned);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

}  // namespace

// The fused phase 1 on a cluster of nblocks blocks (1, 2, 4, 8 or 16; the
// wrapper's route).  cT (kw, rows) receives the scan's coefficients.  Returns
// an error, and launches nothing, when the slice does not fit the cluster or
// the card cannot place it.
extern "C" int gf2_phase1_fused(const uint32_t* a, const uint32_t* bT_in,
                                const int32_t* used_in, int32_t* prow, int32_t* used_out,
                                uint32_t* cT, uint32_t* pf, int rows, int wp, int kw, int w0,
                                int cols, int nblocks, cudaStream_t stream) {
  gf2::ScanGeometry g;
  if (w0 < 0 || w0 + kw > wp || !gf2::scan_geometry(rows, kw, nblocks, &g))
    return (int)cudaErrorInvalidValue;
  const FusedCall c = {a, bT_in, used_in, prow, used_out, cT, pf, rows, wp, kw, w0, cols,
                       nblocks, stream};
#define GF2_FUSED_SLOTS(n)                                            \
  if (g.slots <= n)                                                   \
    return (int)(nblocks == 1 ? launch_fused<false, n>(c, g) : launch_fused<true, n>(c, g));
  GF2_FUSED_SLOTS(1)
  GF2_FUSED_SLOTS(2)
  GF2_FUSED_SLOTS(3)
  GF2_FUSED_SLOTS(5)
  GF2_FUSED_SLOTS(gf2::kMaxSlots)
#undef GF2_FUSED_SLOTS
  return (int)cudaErrorInvalidValue;
}
