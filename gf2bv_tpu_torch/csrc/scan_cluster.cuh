// The forward pivot scan of one system by a thread-block cluster with its
// state in shared memory, as a body other kernels call: the 1-pivot scan and
// the batched scan (scan.cu: one cluster, or one cluster per system) and the
// scan cluster of the fused update + scan (panel_update.cu: cluster 0 of a
// grid whose other clusters update the matrix).
//
// The contract of every scan of this directory (pallas_phase1.py:
// _make_scan_kernel):
//   in : bT (kw, rows) transposed panel slice, used (rows,) 0/1, w0, cols
//   out: prow (K,) pivot row per panel column (-1 = free or invalid),
//        used' (rows,), cT (kw, rows) elimination coefficients
// For each panel column jj (packed bit 32*w0 + jj, valid in 1..cols) the
// pivot is the LOWEST unused row index with the bit set (the reference's
// rule: any other rule permutes rows and breaks bit-exact comparisons).  Its
// slice words >= jj's word are XORed into every other candidate, the
// candidate's coefficient bit jj is set in cT, and the pivot is marked used.
//
// What bounds a scan on the H100: latency.  K = 256 dependent steps per panel,
// each an election of the lowest candidate row followed by an elimination
// sweep; the arithmetic and the 1.5 MB moved are negligible.  With the state
// in global memory and one block of 1024 threads a step costs each thread a
// serial walk over its ~20 rows through L2 latency, twice: 7.5 us per step on
// 20224 rows against 0.58 us on 768.
//
// What this body does about it: the rows are cut into nb contiguous ranges,
// one per block of the cluster (nb = 1, 2, 4, 8 or 16, chosen by the wrapper
// from the shape); a block keeps its rows' kw slice words in shared memory as
// 16-byte halves ([half][row], so a warp's accesses are conflict-free), and
// each thread owns the rows tid, tid + 512, ... of the range with their used
// flags in a register mask and their coefficient word in registers.  A step:
//   1. each thread loads its unused rows' half that holds the column's word
//      and tests the bit; __reduce_min_sync gives the warp's lowest candidate,
//      one __syncthreads and a second reduction, made by every warp for
//      itself, the block's;
//   2. the block's first warp reads that row's halves from shared memory and
//      lane b sends (words, row) into slot [parity][rank] of block b with
//      st.async through distributed shared memory, counted on block b's
//      mbarrier;
//   3. each block waits on its own mbarrier for the nb slots (no cluster
//      barrier: data flow alone keeps the blocks within one step of each
//      other, which is what makes two slot buffers enough);
//   4. every warp reads the nb slots, takes the lowest row (the ranges ascend
//      with the rank, so it is the first block that has a candidate), has the
//      pivot's words from the slot without a dependent load, and each thread
//      sweeps its own rows in shared memory.
// Both skips of a step are cluster-uniform: an invalid column depends on the
// arguments alone, and "no pivot" is decided after the exchange, from the same
// slots in every block.  bT is read once at the start; a coefficient word is
// written once, after its 32 columns; used' is written once at the end.  There
// is no working copy in global memory.  With nb = 1 there is no exchange:
// every thread reads the pivot's words straight from the block's shared
// memory and a step has one __syncthreads.
//
// A template flag swaps steps 1-2 for the min-key scan's election (below,
// at scan_cluster_body).
//
// A second flag, kChain, makes the body one link of the chained scan
// (scan_chunked.cu): the cluster scans one chunk of a slice too tall for any
// cluster, its rows [base, base + rows) of a slice of ld rows, and applies
// the pivots that the chunks before it elected.  Those come in a record of
// the columns taken so far (struct ScanChain), loaded into shared memory at
// the start: at a column the record marks as taken, each thread XORs the
// pivot's words from the column's word up into its live candidates and sets
// their coefficient bit, with no election, no exchange and no barrier (the
// record is the same in every block, so the skip is cluster-uniform and the
// slot parity and mbarrier phases advance only on exchange steps).  A pivot
// the chunk elects at a column not taken is the global one: the writer
// stores it in prow and, with its words as they stood at that step, in the
// record.  The first chunk loads no record and writes prow and the record's
// rows at every column.  The record's load and the sweep of a run of taken
// columns are helpers (below) that the two-pivot body's chained form
// (scan2_cluster.cuh) calls too.
//
// The body takes the block's rank and the cluster's size as arguments: the
// caller's grid may hold many clusters (one per system of a batch) or other
// work beside the one scan cluster.  Its two cluster barriers (before the
// first exchange and before exit) are the calling cluster's own.
#pragma once

#include <cooperative_groups.h>

#include "gf2_common.cuh"

namespace gf2 {

constexpr int kClusterThreads = 512;  // threads per block: up to 128 registers each
constexpr int kMaxSlots = 8;          // rows a thread can own (kernels for 1, 2, 3, 5, 8)
constexpr int kMaxCluster = 16;       // blocks per cluster (above 8: non-portable size)
constexpr int kSlotQuads = 3;         // one slot: words 0-3, words 4-7, (row, -, -, -)
constexpr int kMinKeySlotQuads = 4;   // a min-key slot: the block's 16 key minima
// Shared memory of a scanning block, in 16-byte quads: the exchange slots
// [2][kMaxCluster][kSlotQuads], the warp minima [2][32] ints, the two
// mbarriers of the exchange (one quad), then the state [halves][rpb_pad]
// (half h of a row: its slice words 4h .. 4h+3).
constexpr int kScanHeaderQuads = 2 * kMaxCluster * kSlotQuads + 2 * 32 / 4 + 1;
// The min-key election's header: slots [2][kMaxCluster][kMinKeySlotQuads],
// the warps' records [2][16 warps][4 quads] (words 0-3, words 4-7, row), the
// mbarriers.
constexpr int kMinKeyHeaderQuads =
    2 * kMaxCluster * kMinKeySlotQuads + 2 * (kClusterThreads / 32) * 16 / 4 + 1;
constexpr size_t kMaxBlockSmem = 232448;  // 227 KB
// The record of a chained scan in shared memory, after the election's header:
// the pivots' slice words [K][2] quads, then their rows [K] ints, for K <= 256.
constexpr int kMaxRecordCols = 256;
constexpr int kRecordQuads = 2 * kMaxRecordCols + kMaxRecordCols / 4;

template <bool kMinKey, bool kChain = false>
__host__ __device__ constexpr int scan_header_quads() {
  return (kMinKey ? kMinKeyHeaderQuads : kScanHeaderQuads) + (kChain ? kRecordQuads : 0);
}

// One link of the chained scan.  record: the system's record in global
// memory, 9 K words: the pivots' slice words [K][2] quads (column jj's at
// quads 2 jj, 2 jj + 1), then their global rows [K] (-1: not taken).  ld: the
// rows of the whole slice (the stride of bT_in and cT); base: the chunk's
// first row; first: the chunk is the first (it loads no record).
struct ScanChain {
  int32_t* record = nullptr;
  int ld = 0;
  int base = 0;
  bool first = true;
};

// The exchange's primitives (PTX: mbarrier, mapa, st.async).  Addresses are
// 32-bit shared-memory addresses; a remote one is the same offset mapped into
// the window of another block of the cluster.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t remote_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
}

// One arrival that also announces `bytes` of st.async traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes into another block's shared memory; their arrival is counted on
// that block's mbarrier.
__device__ __forceinline__ void store_async16(uint32_t dst, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// The min-key fold of n rows of 16 keys (four quads at src + 4 l; a row is a
// candidate's keys, or the sentinel throughout): the least key of every half
// lies on the row with the least key of half 2 sw (the lowest candidate row,
// which every live half's key starts with), so lane l < n reads that one key
// of row l, one reduction elects the row, and every lane reads its 16 keys
// into out (four broadcast loads).  Returns the least key of half 2 sw.
__device__ __forceinline__ int min_keys(const uint4* src, int n, int sw, int none, int lane,
                                        uint4 (&out)[4]) {
  const int kp = lane < n ? reinterpret_cast<const int*>(src)[16 * lane + 2 * sw] : none;
  const int m = __reduce_min_sync(0xffffffffu, kp);
  const int wl = __ffs(__ballot_sync(0xffffffffu, kp == m)) - 1;  // lane 0 when m == none
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = src[4 * wl + j];
  return m;
}

// -- the chained scan's record, as both scan bodies use it ----------------------

// Loads the record of the earlier chunks (K columns) into shared memory: the
// pivots' words rec_w [K][2] quads and their rows rec_row [K].
__device__ __forceinline__ void load_chain_record(const ScanChain& chain, uint4* rec_w,
                                                  int* rec_row, int K, int tid, int nthreads) {
  const uint4* gw = reinterpret_cast<const uint4*>(chain.record);
  for (int j = tid; j < 2 * K; j += nthreads) rec_w[j] = gw[j];
  for (int j = tid; j < K; j += nthreads) rec_row[j] = chain.record[8 * K + j];
}

// The end of the run of taken columns from jj (taken itself) within its word
// and the valid columns [.., jhi).
__device__ __forceinline__ int taken_run_end(const int* rec_row, int jj, int jhi) {
  const int wend = min(jhi, (jj | 31) + 1);
  int jend = jj + 1;
  while (jend < wend && rec_row[jend] >= 0) ++jend;
  return jend;
}

// The columns [jj, jend) of one word, all taken by earlier chunks: each
// pivot's recorded words swept into this thread's live candidates, with their
// coefficient bits, with no election, no exchange and no barrier.  The rows
// are swept in registers (all of a thread's rows, or four at a time of
// eight): each row is read and written once a run instead of once a column.
template <int kSlots>
__device__ __forceinline__ void sweep_taken_run(uint4* bT_s, const uint4* rec_w, int rpb_pad,
                                                int halves, uint32_t live,
                                                uint32_t (&c)[kSlots], int jj, int jend,
                                                int tid, int nthreads) {
  const int sw = jj >> 5, hs = sw >> 2, q = sw & 3;
  const bool upper = hs == 0 && halves == 2;
  constexpr int kGroup = kSlots % 4 ? kSlots : 4;  // divides kSlots
#pragma unroll
  for (int g0 = 0; g0 < kSlots; g0 += kGroup) {
    uint4 v[kGroup], u[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int loc = (g0 + i) * nthreads + tid;
      v[i] = u[i] = make_uint4(0u, 0u, 0u, 0u);
      if ((live >> (g0 + i)) & 1u) {
        v[i] = bT_s[hs * rpb_pad + loc];
        if (upper) u[i] = bT_s[rpb_pad + loc];
      }
    }
    for (int j = jj; j < jend; ++j) {
      const uint32_t bj = 1u << (j & 31);
      const uint4 r1 = rec_w[2 * j + 1];
      uint4 bph = hs ? r1 : rec_w[2 * j];
      if (q > 0) bph.x = 0u;
      if (q > 1) bph.y = 0u;
      if (q > 2) bph.z = 0u;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (!((live >> (g0 + i)) & 1u) || !(word_of(v[i], q) & bj)) continue;
        v[i] = xor4(v[i], bph);
        if (upper) u[i] = xor4(u[i], r1);
        c[g0 + i] ^= bj;
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int loc = (g0 + i) * nthreads + tid;
      if ((live >> (g0 + i)) & 1u) {
        bT_s[hs * rpb_pad + loc] = v[i];
        if (upper) bT_s[rpb_pad + loc] = u[i];
      }
    }
  }
}

// The scan of one system by the calling cluster.  kCluster: the block is one
// of nb > 1 blocks of a cluster and `rank` its rank there; else nb == 1 and
// rank == 0 (no exchange, no cluster barrier).  kSlots: rows a thread owns at
// most (its loops over them are unrolled, so a thread pays for kSlots rows
// whatever it has).  rpb: rows per block, at most kSlots * kClusterThreads;
// rpb_pad: rpb rounded up to a multiple of 32.  smem4: the block's
// scan_header_quads<kMinKey>() + halves * rpb_pad quads of shared memory.
// Every thread of every block of the cluster must call it.
//
// kMinKey: the election is the min-key scan's (pallas_phase1.py:
// _make_scan_kernel_minkey; rows < 2^15): a candidate row is known by its
// keys, global row << 16 | 16-bit half for every live half of the slice, and
// the least key of each half lands on the lowest candidate row and carries its
// words.  All 16 least keys of a set of rows lie on one row, so no level needs
// 16 reductions: a warp elects its lowest candidate with one reduction and
// that lane stores its row and words as the warp's record; one
// __syncthreads; the block's lowest candidate is one reduction over the 16
// records, its words read from the winning record.  With nb = 1 that is the
// pivot.  With nb > 1 warp 0 turns it into the block's 16 keys (the sentinel
// rows << 16 for a dead half or no candidate), which are the block's slot of
// the exchange (steps 2-3 above, four quads), and every warp folds the nb
// slots (min_keys): one reduction on the key of half 2 sw elects the slot,
// whose 16 keys give the pivot row and its words.  Measured on the H100 at
// 20224 rows, random slices: the TPU kernel's form, 16 independent reductions
// at each level, 2.13 us a step (2.83 with each reduction behind a branch);
// one reduction a level carrying all 16 keys, 1.75-1.91; keys formed once a
// block (this form), 1.56; the 1-pivot election 0.92.
//
// kChain: one link of the chained scan (above); bT_in, used_in, used_out and
// cT point at the chunk's first row, rows is the chunk's, chain.ld the
// slice's, and smem4 holds scan_header_quads<false, true>() quads of header.
template <bool kCluster, int kSlots, bool kMinKey = false, bool kChain = false>
__device__ __forceinline__ void
scan_cluster_body(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                  int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                  uint32_t* __restrict__ cT, int rows, int kw, int w0, int cols, int rpb,
                  int rpb_pad, uint4* smem4, int rank, int nb, ScanChain chain = {}) {
  static_assert(!(kMinKey && kChain), "the chained scan elects by the 1-pivot rule");
  constexpr int slot_quads = kMinKey ? kMinKeySlotQuads : kSlotQuads;
  constexpr int header = scan_header_quads<kMinKey>();
  uint4* slots = smem4;                                        // [2][kMaxCluster][slot_quads]
  // [2][32] warp minima; min-key: [2][16 warps] records of four quads
  int* warp_min = reinterpret_cast<int*>(smem4 + 2 * kMaxCluster * slot_quads);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem4 + header - 1);  // [2]
  uint4* rec_w = smem4 + header;                               // kChain: [K][2]
  int* rec_row = reinterpret_cast<int*>(rec_w + 2 * kMaxRecordCols);  // kChain: [K]
  uint4* bT_s = smem4 + scan_header_quads<kMinKey, kChain>();  // [halves][rpb_pad]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nthreads = kClusterThreads, nwarps = kClusterThreads / 32;
  const unsigned full = 0xffffffffu;
  const int halves = (kw + 3) >> 2;
  const int row0 = rank * rpb;
  const int nloc = max(0, min(rpb, rows - row0));       // rows of this block
  const bool writer = rank == 0 && tid == 0;
  const int ld = kChain ? chain.ld : rows;       // the stride of bT_in and cT
  const int base = kChain ? chain.base : 0;      // global row of local row 0
  const bool chained = kChain && !chain.first;   // earlier chunks took columns

  // Thread tid owns the rows row0 + i * nthreads + tid, i < kSlots.  Bit i of
  // live: that row exists and is unused; c[i]: its coefficient word for the
  // current 32 columns.
  uint32_t live = 0u;
  uint32_t c[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    c[i] = 0u;
    const int loc = i * nthreads + tid;
    if (loc < nloc) {
      const int r = row0 + loc;
      if (!used_in[r]) live |= 1u << i;
      for (int h = 0; h < halves; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = 4 * h + q < kw ? bT_in[(size_t)(4 * h + q) * ld + r] : 0u;
        bT_s[h * rpb_pad + loc] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  const int K = 32 * kw;
  if (chained) {  // the record of the earlier chunks; read-only from here on
    load_chain_record(chain, rec_w, rec_row, K, tid, nthreads);
    if (!kCluster) __syncthreads();  // a cluster's barrier below orders it
  }
  // no block writes into another's shared memory before that block runs and
  // has its mbarriers ready (one arrival each: the thread that arms it)
  uint32_t wait_parity = 0u;  // bit p: the parity mbarrier p's next phase completes with
  if (kCluster) {
    if (tid == 0) {
      mbar_init(smem_addr(&mbar[0]), 1);
      mbar_init(smem_addr(&mbar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cooperative_groups::this_cluster().sync();
  }

  // the valid columns of the panel are the steps [jlo, jhi): arguments only
  const long long first = 1LL - 32LL * w0, last = (long long)cols - 32LL * w0;
  const int jlo = (int)max(0LL, min((long long)K, first));
  const int jhi = (int)max(0LL, min((long long)K, last + 1));
  int p = 0;  // parity of the exchange steps: which slots and warp minima are in use
  for (int jj = 0; jj < K; ++jj) {
    const int sw = jj >> 5, hs = sw >> 2, q = sw & 3;
    const uint32_t bit = 1u << (jj & 31);
    int piv = rows;
    // a column an earlier chunk took: its pivot's words swept into this
    // thread's candidates, nothing else (cluster-uniform: the record).  The
    // run of taken columns from jj to the end of word sw is swept with the
    // rows in registers (all of a thread's rows, or four at a time of eight):
    // each row is read and written once a run instead of once a column.
    const bool taken = chained && jj >= jlo && jj < jhi && rec_row[jj] >= 0;
    if (taken) {
      const int jend = taken_run_end(rec_row, jj, jhi);
      sweep_taken_run<kSlots>(bT_s, rec_w, rpb_pad, halves, live, c, jj, jend, tid, nthreads);
      jj = jend - 1;  // the step's tail below: the coefficients at the word's end
    }
    if (jj >= jlo && jj < jhi && !taken) {  // cluster-uniform
      // this thread's rows: the half that holds the column's word, and for
      // the candidates the half above it, all kept in registers for the sweep
      uint4 v[kSlots], u[kSlots];
      uint32_t cm = 0u;  // bit i: row i of this thread is a candidate
      int mine = rows;
#pragma unroll
      for (int i = kSlots - 1; i >= 0; --i) {
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        if ((live >> i) & 1u) v[i] = bT_s[hs * rpb_pad + i * nthreads + tid];
      }
      const bool upper = hs == 0 && halves == 2;
#pragma unroll
      for (int i = kSlots - 1; i >= 0; --i) {
        const uint32_t w = q == 0 ? v[i].x : q == 1 ? v[i].y : q == 2 ? v[i].z : v[i].w;
        if (w & bit) {
          cm |= 1u << i;
          mine = row0 + i * nthreads + tid;  // rows ascend with i: the last hit is lowest
        }
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        if (upper && ((cm >> i) & 1u)) u[i] = bT_s[rpb_pad + i * nthreads + tid];
      uint4 bp0 = make_uint4(0u, 0u, 0u, 0u), bp1 = bp0;  // the pivot row's halves
      if constexpr (kMinKey) {
        const int none = rows << 16;  // above every key: rows < 2^15
        // this thread's lowest candidate (mine) and its words from sw on
        uint4 c0 = bp0, c1 = bp0;  // its half hs and, when upper, half 1
#pragma unroll
        for (int i = kSlots - 1; i >= 0; --i) {
          if ((cm >> i) & 1u) {
            c0 = v[i];
            if (upper) c1 = u[i];
          }
        }
        // the warp's lowest candidate: its row, and its words from half hs on
        // (half 0 is dead when hs == 1), stored by that lane as the warp's record
        const int wmin = __reduce_min_sync(full, mine);
        const int wl = __ffs(__ballot_sync(full, mine == wmin)) - 1;  // lane 0 when none
        uint4* wr = reinterpret_cast<uint4*>(warp_min) + (p * nwarps + warp) * 4;
        if (lane == wl) {
          wr[0] = hs ? bp0 : c0;
          wr[1] = hs ? c0 : c1;
          wr[2] = make_uint4((uint32_t)mine, 0u, 0u, 0u);
        }
        __syncthreads();
        // the block's lowest candidate: one reduction over the warps' rows, then
        // the winning record's words by broadcast loads
        const uint4* recs = reinterpret_cast<const uint4*>(warp_min) + p * nwarps * 4;
        if (!kCluster) {
          const int r = lane < nwarps ? (int)recs[4 * lane + 2].x : rows;
          piv = __reduce_min_sync(full, r);
          const int wb = __ffs(__ballot_sync(full, r == piv)) - 1;
          bp0 = recs[4 * wb];
          bp1 = recs[4 * wb + 1];
        } else {
          const uint32_t bar = smem_addr(&mbar[p]);
          if (tid == 0) mbar_arrive_expect(bar, (uint32_t)(nb * slot_quads * sizeof(uint4)));
          if (warp == 0) {
            const int r = lane < nwarps ? (int)recs[4 * lane + 2].x : rows;
            const int brow = __reduce_min_sync(full, r);
            const int wb = __ffs(__ballot_sync(full, r == brow)) - 1;
            const uint4 h0 = recs[4 * wb], h1 = recs[4 * wb + 1];
            // the block's slot: the 16 keys of its lowest candidate, row << 16 |
            // 16-bit half, the sentinel for a dead half or no candidate
            int key[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const uint32_t w = word_of(i < 8 ? h0 : h1, (i >> 1) & 3);
              const bool keyed = brow < rows && i >= 2 * sw && i < 2 * kw;
              key[i] = keyed ? (brow << 16) | (int)((i & 1) ? w >> 16 : w & 0xFFFFu) : none;
            }
            if (lane < nb) {
              const uint32_t dst = remote_addr(
                  smem_addr(slots + (p * kMaxCluster + rank) * slot_quads), lane);
              const uint32_t rbar = remote_addr(bar, lane);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                store_async16(dst + 16 * j, make_uint4(key[4 * j], key[4 * j + 1],
                                                       key[4 * j + 2], key[4 * j + 3]), rbar);
            }
          }
          mbar_wait(bar, (wait_parity >> p) & 1u);
          wait_parity ^= 1u << p;
          // the least key of each half over the cluster; piv is rows when no
          // block has a candidate
          uint4 km[4];
          piv = min_keys(slots + p * kMaxCluster * slot_quads, nb, sw, none, lane, km) >> 16;
          uint32_t bw[8];
#pragma unroll
          for (int g = 0; g < 8; ++g)
            bw[g] = (g >= sw && g < kw) ? (word_of(km[g >> 1], (2 * g + 1) & 3) << 16) |
                                              (word_of(km[g >> 1], (2 * g) & 3) & 0xFFFFu)
                                        : 0u;
          bp0 = make_uint4(bw[0], bw[1], bw[2], bw[3]);
          bp1 = make_uint4(bw[4], bw[5], bw[6], bw[7]);
        }
      } else {
        mine = __reduce_min_sync(full, mine);
        if (lane == 0) warp_min[p * 32 + warp] = mine;
        __syncthreads();
        int bmin = lane < nwarps ? warp_min[p * 32 + lane] : rows;
        bmin = __reduce_min_sync(full, bmin);  // every warp reduces for itself

        if (!kCluster) {
          piv = bmin;
          if (piv < rows) {
            bp0 = bT_s[piv - row0];
            if (halves == 2) bp1 = bT_s[rpb_pad + piv - row0];
          }
        } else {
          // this block expects a slot of kSlotQuads quads from every block
          const uint32_t bar = smem_addr(&mbar[p]);
          if (tid == 0) mbar_arrive_expect(bar, (uint32_t)(nb * kSlotQuads * sizeof(uint4)));
          if (warp == 0) {
            uint4 w0q = bp0, w1q = bp0;
            if (bmin < rows) {
              w0q = bT_s[bmin - row0];
              if (halves == 2) w1q = bT_s[rpb_pad + bmin - row0];
            }
            if (lane < nb) {
              const uint32_t dst = remote_addr(
                  smem_addr(slots + (p * kMaxCluster + rank) * kSlotQuads), lane);
              const uint32_t rbar = remote_addr(bar, lane);
              store_async16(dst, w0q, rbar);
              store_async16(dst + 16, w1q, rbar);
              store_async16(dst + 32, make_uint4((uint32_t)bmin, 0u, 0u, 0u), rbar);
            }
          }
          mbar_wait(bar, (wait_parity >> p) & 1u);
          wait_parity ^= 1u << p;
          const uint4* sl = slots + p * kMaxCluster * kSlotQuads;
          const int r = lane < nb ? (int)sl[lane * kSlotQuads + 2].x : rows;
          const unsigned has = __ballot_sync(full, r < rows);
          if (has) {  // the ranges ascend with the rank: the first block with a candidate
            const int wb = __ffs(has) - 1;
            piv = __shfl_sync(full, r, wb);
            bp0 = sl[wb * kSlotQuads];
            bp1 = sl[wb * kSlotQuads + 1];
          }
        }
      }
      p ^= 1;
      if (kChain && writer && piv < rows) {  // the pivot's words as they stand now
        uint4* gw = reinterpret_cast<uint4*>(chain.record);
        gw[2 * jj] = bp0;
        gw[2 * jj + 1] = bp1;
      }

      if (piv < rows) {  // cluster-uniform: decided from the exchanged slots
        // only the words from sw on change: clear the pivot's words below it
        uint4 bph = hs ? bp1 : bp0;
        if (q > 0) bph.x = 0u;
        if (q > 1) bph.y = 0u;
        if (q > 2) bph.z = 0u;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (!((cm >> i) & 1u)) continue;
          const int loc = i * nthreads + tid;
          if (row0 + loc == piv) {
            live &= ~(1u << i);
            continue;
          }
          bT_s[hs * rpb_pad + loc] = xor4(v[i], bph);
          if (upper) bT_s[rpb_pad + loc] = xor4(u[i], bp1);
          c[i] ^= bit;
        }
      }
    }
    // a later chunk writes only the columns it elects: the first wrote the rest
    if (writer && (!chained || piv < rows)) {
      const int g = piv < rows ? base + piv : -1;
      prow[jj] = g;
      if (kChain) chain.record[8 * K + jj] = g;
    }
    if ((jj & 31) == 31) {  // word sw of the coefficients is final
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int loc = i * nthreads + tid;
        if (loc < nloc) cT[(size_t)sw * ld + row0 + loc] = c[i];
        c[i] = 0u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int loc = i * nthreads + tid;
    if (loc < nloc) used_out[row0 + loc] = (int32_t)(((live >> i) & 1u) ^ 1u);
  }
  // no block exits while another may still write into its shared memory.  The
  // barrier's arrive has release and its wait acquire semantics at cluster
  // scope (the PTX defaults of barrier.cluster), so after it every block of
  // the cluster sees every block's prow, cT and used' in global memory: the
  // fused phase 1 (phase1_fused.cu) reads them there with no barrier of its own
  if (kCluster) cooperative_groups::this_cluster().sync();
}

// -- host side: the geometry of a cluster scan and its launch ------------------

// How a (kw, rows) slice lies on nblocks blocks.
struct ScanGeometry {
  int rpb;      // rows per block
  int rpb_pad;  // rounded up to a multiple of 32
  int slots;    // rows a thread owns at most
  size_t smem;  // shared memory of one block, bytes
};

// False when no cluster of nblocks blocks holds the slice (shared memory,
// kMaxSlots rows a thread) or the arguments are none a kernel takes.
// header_quads: scan_header_quads<kMinKey>() of the body's election.
inline bool scan_geometry(int rows, int kw, int nblocks, ScanGeometry* g,
                          int header_quads = kScanHeaderQuads) {
  if (kw < 1 || kw > 8 || rows < 1 || nblocks < 1 || nblocks > kMaxCluster ||
      (nblocks & (nblocks - 1)))
    return false;
  g->rpb = (rows + nblocks - 1) / nblocks;
  g->rpb_pad = (g->rpb + 31) & ~31;
  g->smem = sizeof(uint4) * (header_quads + (size_t)((kw + 3) / 4) * g->rpb_pad);
  g->slots = (g->rpb + kClusterThreads - 1) / kClusterThreads;
  return g->smem <= kMaxBlockSmem && g->slots <= kMaxSlots;
}

// What one kernel instantiation remembers between launches (the port drives
// one device per process: ops/_cuda.py requires the current device).
struct ClusterLaunchState {
  bool attributes_set = false;
  // per cluster size: the largest shared-memory size found placeable, and
  // how many such clusters the card holds at once
  size_t placeable[kMaxCluster + 1] = {};
  int max_clusters[kMaxCluster + 1] = {};
};

// cfg for `grid` blocks of kClusterThreads threads in clusters of `cluster`
// blocks (1: no cluster attribute); attr must outlive cfg's use.
inline void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid,
                           int cluster, size_t smem, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1 ? 1 : 0;
}

// Before a kernel's launches in clusters of `cluster` blocks with `smem` bytes
// each: its function attributes, set once per instantiation (shared memory up
// to the block's 227 KB, the non-portable cluster size 16), and, once per
// cluster size and largest shared-memory size, whether the card can place such
// a cluster at all.  Leaves the number of clusters the card holds at once in
// st->max_clusters[cluster].  A card that cannot place one is an error.
template <typename Kernel>
cudaError_t prepare_cluster_launch(Kernel kernel, ClusterLaunchState* st, int cluster,
                                   size_t smem, cudaStream_t stream) {
  cudaError_t rc;
  if (!st->attributes_set) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kMaxBlockSmem);
    if (rc != cudaSuccess) return rc;
    if (cluster > 1) {  // an instantiation is launched either always or never in clusters
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (rc != cudaSuccess) return rc;
    }
    st->attributes_set = true;
  }
  if (smem > st->placeable[cluster]) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, cluster, cluster, smem, stream);
    int nclusters = 0;
    if (cluster > 1) {
      rc = cudaOccupancyMaxActiveClusters(&nclusters, kernel, &cfg);
    } else {
      int per_sm = 0, nsm = 0;
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kClusterThreads,
                                                         smem);
      if (rc == cudaSuccess) rc = sm_count(&nsm);
      nclusters = per_sm * nsm;
    }
    if (rc != cudaSuccess) return rc;
    if (nclusters < 1) return cudaErrorLaunchOutOfResources;
    st->placeable[cluster] = smem;
    st->max_clusters[cluster] = nclusters;
  }
  return cudaSuccess;
}

// The 1-pivot cluster scan of one system on nblocks blocks (gf2_scan's launch)
// that returns at once where *skip_if is nonzero: the subset-first scan's
// fallback (scan_subset.cu).  Defined in scan.cu.
cudaError_t scan_cluster_gated(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                               int32_t* used_out, uint32_t* cT, int rows, int kw, int w0,
                               int cols, int nblocks, const int32_t* skip_if,
                               cudaStream_t stream);

}  // namespace gf2
