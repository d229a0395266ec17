// The chained scan's host side as other sources call it: one call's
// arguments, the geometry of each of its links, and the launch of one plain
// link (scan_chunked.cu, where the chain and why it is exact are described).
// fused_chunked.cu runs the links of the fused phase 1 and of the fused
// update + scan through it, all but the one link each fuses with its other
// stage; scan2_chunked.cu runs the two-pivot chain on the same call.
#pragma once

#include <algorithm>

#include "scan_cluster.cuh"

namespace gf2 {

// One call of the chained scan: `batch` systems, chunks of chunk_rows rows
// from row 0, each on clusters of nblocks blocks but the last, on
// nblocks_last.  record: scratch of batch x 9 K words.  skip_if: null, or a
// word that makes every plain link return at once where it is nonzero (the
// subset-first scan's fallback, scan_subset.cu).
struct ChunkCall {
  const uint32_t* bT_in;
  const int32_t* used_in;
  int32_t* prow;
  int32_t* used_out;
  uint32_t* cT;
  int32_t* record;
  int batch, rows, kw, w0, cols, chunk_rows, nblocks, nblocks_last;
  cudaStream_t stream;
  const int32_t* skip_if = nullptr;
};

// Shared memory of a link before its state, in quads: the election's header
// and the record.
constexpr int kChainHeaderQuads = scan_header_quads<false, true>();

// The geometry of the chunk at `base`; false when no cluster holds it.
// header_quads: a link's shared memory before its state (the two-pivot
// chain's is larger).
inline bool chunk_geometry(const ChunkCall& c, int base, int* nrows, int* nb,
                           ScanGeometry* g, int header_quads = kChainHeaderQuads) {
  *nrows = std::min(c.chunk_rows, c.rows - base);
  *nb = base + c.chunk_rows >= c.rows ? c.nblocks_last : c.nblocks;
  return scan_geometry(*nrows, c.kw, *nb, g, header_quads);
}

// The arguments and every chunk's geometry, checked before the first launch
// so that a call the kernels cannot take launches nothing.
inline bool chain_fits(const ChunkCall& c, int header_quads = kChainHeaderQuads) {
  if (c.batch < 1 || c.rows < 1 || c.chunk_rows < 1 || c.kw < 1 ||
      c.kw > kMaxRecordCols / 32)
    return false;
  int nrows, nb;
  ScanGeometry g;
  for (int base = 0; base < c.rows; base += c.chunk_rows)
    if (!chunk_geometry(c, base, &nrows, &nb, &g, header_quads)) return false;
  return true;
}

// The first row of the last chunk.
inline int last_chunk_base(const ChunkCall& c) {
  return (c.rows - 1) / c.chunk_rows * c.chunk_rows;
}

// Launches the plain link of the chunk at `base` (the chain must fit).
// Defined in scan_chunked.cu.
cudaError_t launch_chain_link(const ChunkCall& c, int base);

}  // namespace gf2
