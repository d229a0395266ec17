// The chained scan: the forward pivot scan of slices taller than the largest
// cluster holds, as a chain of cluster scans over row chunks.
//
// gf2_scan_chunked replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel,
// and gf2_scan_batched_chunked gf2bv_tpu/ops/gauss_batched.py:
// _make_scan_kernel_b, for slices past the largest cluster (65536 rows at
// K = 256).  The contract is scan_cluster.cuh's, to the bit: in bT (kw,
// rows), used (rows,), w0, cols; out prow (K,), used' (rows,), cT (kw, rows);
// the pivot of a column is the lowest unused row with the bit set.
//
// Why a chain is exact.  Cut the rows into chunks of ascending index.  At
// step jj the pivot is the lowest unused row with bit jj set: if chunk 0 has
// a candidate, it is chunk 0's lowest; if not, the pivot lies in a later
// chunk, and elimination only touches candidates, so it changes nothing in
// chunk 0.  So chunk 0 evolves exactly as if it were alone, and by induction
// chunk c evolves as if alone except that it applies, at their steps, the
// pivots that the chunks before it elected.  The chain therefore needs no
// co-residency, no spin-wait and no grid barrier: launch c scans chunk c on
// one cluster (scan_cluster_body with kChain, scan_cluster.cuh) and the
// launches are ordered on the stream.  A per-system record of the columns
// taken so far (9 K words: each pivot's global row, or -1, and its slice
// words as they stood at that step) carries the earlier chunks' pivots: each
// launch loads it into shared memory, sweeps the record's pivots into its
// candidates at their columns with no election and no barrier, elects at the
// valid columns not taken, and adds its own pivots to the record and to prow.
// The first launch writes prow and the record's rows at every column; every
// launch writes only its own rows' used' and cT.
//
// What bounds it on the H100: as the cluster scan, latency: K dependent
// steps of the first chunk's election (about 1 us a step on 16 blocks with
// 5 rows a thread), then later chunks whose columns the first chunk has
// almost all taken, each such step a sweep of a thread's own rows in shared
// memory with no barrier.  The bytes (the slice read once, cT and used'
// written once, the 9 KB record) are negligible.
//
// Batches: launch c covers chunk c of all B systems, one cluster per system
// (the kernel of gf2_scan_chunked with B = 1), each system with its own
// record.  The wrapper picks the chunk rows and the clusters' size from the
// shape (phase1.scan_chunked_route); every chunk takes one cluster size but
// the last, which may be smaller.

#include "scan_chunked.cuh"
#include "scan_cluster.cuh"

namespace {

// Chunk [base, base + nrows) of `batch` systems of a (kw, rows) slice: the
// grid is batch clusters of nb blocks (plain blocks when nb == 1), cluster
// blockIdx.x / nb taking system blockIdx.x / nb.  record: (batch, 9 K) words.
// skip_if: ChunkCall's.
template <bool kCluster, int kSlots>
__global__ void __launch_bounds__(gf2::kClusterThreads, 1)
scan_chunk_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                  int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                  uint32_t* __restrict__ cT, int32_t* __restrict__ record, int rows, int kw,
                  int w0, int cols, int base, int nrows, int rpb, int rpb_pad, int nb,
                  const int32_t* __restrict__ skip_if) {
  if (skip_if != nullptr && *skip_if != 0) return;  // the whole grid, before any barrier
  extern __shared__ uint4 smem4[];
  const int b = blockIdx.x / nb;
  const int K = 32 * kw;
  const size_t slice = (size_t)kw * rows;  // words of one system's bT / cT
  gf2::ScanChain chain;
  chain.record = record + (size_t)b * 9 * K;
  chain.ld = rows;
  chain.base = base;
  chain.first = base == 0;
  gf2::scan_cluster_body<kCluster, kSlots, false, true>(
      bT_in + b * slice + base, used_in + (size_t)b * rows + base, prow + (size_t)b * K,
      used_out + (size_t)b * rows + base, cT + b * slice + base, nrows, kw, w0, cols, rpb,
      rpb_pad, smem4, (int)blockIdx.x - b * nb, nb, chain);
}

template <bool kCluster, int kSlots>
cudaError_t launch_chunk(const gf2::ChunkCall& c, int base, int nrows, int nb,
                         const gf2::ScanGeometry& g) {
  static gf2::ClusterLaunchState state;
  auto kernel = scan_chunk_kernel<kCluster, kSlots>;
  cudaError_t rc = gf2::prepare_cluster_launch(kernel, &state, nb, g.smem, c.stream);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gf2::cluster_config(&cfg, &attr, c.batch * nb, nb, g.smem, c.stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, c.bT_in, c.used_in, c.prow, c.used_out, c.cT,
                          c.record, c.rows, c.kw, c.w0, c.cols, base, nrows, g.rpb, g.rpb_pad,
                          nb, c.skip_if);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// Every chunk's geometry is checked before the first launch, so that a call
// the kernel cannot take launches nothing.
cudaError_t scan_chunked(const gf2::ChunkCall& c) {
  if (!gf2::chain_fits(c)) return cudaErrorInvalidValue;
  for (int base = 0; base < c.rows; base += c.chunk_rows) {
    const cudaError_t rc = gf2::launch_chain_link(c, base);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

cudaError_t gf2::launch_chain_link(const ChunkCall& c, int base) {
  int nrows, nb;
  ScanGeometry g;
  if (!chunk_geometry(c, base, &nrows, &nb, &g)) return cudaErrorInvalidValue;
#define GF2_CHUNK_SLOTS(n)                                                 \
  if (g.slots <= n)                                                        \
    return nb == 1 ? launch_chunk<false, n>(c, base, nrows, nb, g)         \
                   : launch_chunk<true, n>(c, base, nrows, nb, g);
  GF2_CHUNK_SLOTS(1)
  GF2_CHUNK_SLOTS(2)
  GF2_CHUNK_SLOTS(3)
  GF2_CHUNK_SLOTS(5)
  GF2_CHUNK_SLOTS(kMaxSlots)
#undef GF2_CHUNK_SLOTS
  return cudaErrorInvalidValue;
}

// The chained scan of one system; record: scratch of 9 K words.
extern "C" int gf2_scan_chunked(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                                int32_t* used_out, uint32_t* cT, int32_t* record, int rows,
                                int kw, int w0, int cols, int chunk_rows, int nblocks,
                                int nblocks_last, cudaStream_t stream) {
  return (int)scan_chunked({bT_in, used_in, prow, used_out, cT, record, 1, rows, kw, w0, cols,
                            chunk_rows, nblocks, nblocks_last, stream});
}

// The chained scan of `batch` systems, one cluster per system in each launch;
// record: scratch of batch x 9 K words.
extern "C" int gf2_scan_batched_chunked(const uint32_t* bT_in, const int32_t* used_in,
                                        int32_t* prow, int32_t* used_out, uint32_t* cT,
                                        int32_t* record, int batch, int rows, int kw, int w0,
                                        int cols, int chunk_rows, int nblocks,
                                        int nblocks_last, cudaStream_t stream) {
  return (int)scan_chunked({bT_in, used_in, prow, used_out, cT, record, batch, rows, kw, w0,
                            cols, chunk_rows, nblocks, nblocks_last, stream});
}
