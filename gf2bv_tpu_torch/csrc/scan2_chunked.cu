// The chained two-pivot scan: the two-pivot scan of slices taller than the
// largest cluster holds, as a chain of two-pivot cluster scans over row chunks.
//
// gf2_scan2_chunked replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel2
// (variant "2" of _call_scan_kernel) for slices past the largest cluster
// (65536 rows at K = 256).  The contract is the 1-pivot scan's
// (scan_cluster.cuh), to the bit: in bT (kw, rows), used (rows,), w0, cols;
// out prow (K,), used' (rows,), cT (kw, rows).
//
// It is the 1-pivot chain (scan_chunked.cu: why a chain is exact, the record,
// the equal chunks of the route) with the two-pivot body: launch c scans chunk
// c on one cluster with scan2_cluster_body's kChain form (scan2_cluster.cuh:
// the four cases of a pair against the record), the launches ordered on the
// stream.  The chain's call and its checks are scan_chunked.cuh's, with the
// two-pivot header (seven-quad slots) before the record in shared memory.
//
// What bounds it on the H100: as the 1-pivot chain, latency: the first chunk's
// K / 2 pair steps (one election and one exchange a pair), then later chunks
// whose columns the first has almost all taken, swept with no barrier.  The
// bytes (the slice read once, cT and used' written once, the 9 KB record) are
// negligible.

#include "scan2_cluster.cuh"
#include "scan_chunked.cuh"

namespace {

// The shared memory of a link before its state: the two-pivot header and the
// record.
constexpr int kScan2ChainHeaderQuads = gf2::kScan2HeaderQuads + gf2::kRecordQuads;

// Chunk [base, base + nrows) of one (kw, rows) slice on one cluster of nb
// blocks (a plain block when nb == 1).  record: 9 K words.
template <bool kCluster, int kSlots>
__global__ void __launch_bounds__(gf2::kClusterThreads, 1)
scan2_chunk_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                   int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                   uint32_t* __restrict__ cT, int32_t* __restrict__ record, int rows, int kw,
                   int w0, int cols, int base, int nrows, int rpb, int rpb_pad, int nb) {
  extern __shared__ uint4 smem4[];
  gf2::ScanChain chain;
  chain.record = record;
  chain.ld = rows;
  chain.base = base;
  chain.first = base == 0;
  gf2::scan2_cluster_body<kCluster, kSlots, true>(bT_in + base, used_in + base, prow,
                                                  used_out + base, cT + base, nrows, kw, w0,
                                                  cols, rpb, rpb_pad, smem4, (int)blockIdx.x,
                                                  nb, chain);
}

template <bool kCluster, int kSlots>
cudaError_t launch_chunk2(const gf2::ChunkCall& c, int base, int nrows, int nb,
                          const gf2::ScanGeometry& g) {
  static gf2::ClusterLaunchState state;
  auto kernel = scan2_chunk_kernel<kCluster, kSlots>;
  cudaError_t rc = gf2::prepare_cluster_launch(kernel, &state, nb, g.smem, c.stream);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gf2::cluster_config(&cfg, &attr, nb, nb, g.smem, c.stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, c.bT_in, c.used_in, c.prow, c.used_out, c.cT,
                          c.record, c.rows, c.kw, c.w0, c.cols, base, nrows, g.rpb, g.rpb_pad,
                          nb);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

cudaError_t launch_link2(const gf2::ChunkCall& c, int base) {
  int nrows, nb;
  gf2::ScanGeometry g;
  if (!gf2::chunk_geometry(c, base, &nrows, &nb, &g, kScan2ChainHeaderQuads))
    return cudaErrorInvalidValue;
#define GF2_CHUNK2_SLOTS(n)                                          \
  if (g.slots <= n)                                                  \
    return nb == 1 ? launch_chunk2<false, n>(c, base, nrows, nb, g)  \
                   : launch_chunk2<true, n>(c, base, nrows, nb, g);
  GF2_CHUNK2_SLOTS(1)
  GF2_CHUNK2_SLOTS(2)
  GF2_CHUNK2_SLOTS(3)
  GF2_CHUNK2_SLOTS(5)
  GF2_CHUNK2_SLOTS(gf2::kMaxSlots)
#undef GF2_CHUNK2_SLOTS
  return cudaErrorInvalidValue;
}

// Every chunk's geometry is checked before the first launch, so that a call
// the kernel cannot take launches nothing.
cudaError_t scan2_chunked(const gf2::ChunkCall& c) {
  if (!gf2::chain_fits(c, kScan2ChainHeaderQuads)) return cudaErrorInvalidValue;
  for (int base = 0; base < c.rows; base += c.chunk_rows) {
    const cudaError_t rc = launch_link2(c, base);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

// The chained two-pivot scan of one system; record: scratch of 9 K words.
extern "C" int gf2_scan2_chunked(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                                 int32_t* used_out, uint32_t* cT, int32_t* record, int rows,
                                 int kw, int w0, int cols, int chunk_rows, int nblocks,
                                 int nblocks_last, cudaStream_t stream) {
  return (int)scan2_chunked({bT_in, used_in, prow, used_out, cT, record, 1, rows, kw, w0, cols,
                             chunk_rows, nblocks, nblocks_last, stream});
}
