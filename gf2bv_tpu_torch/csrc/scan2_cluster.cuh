// The two-pivot scan of one system by a thread-block cluster with its state
// in shared memory (scan2.cu: gf2_scan2).  The contract is the 1-pivot
// scan's (scan_cluster.cuh), two columns at a time as pallas_phase1.py:
// _make_scan_kernel2 takes them: for each even jj0, pivot 0 is the lowest
// unused row with bit jj0 set; column jj0 + 1 is seen through pivot 0's
// elimination done virtually; pivot 1 is its lowest candidate other than
// pivot 0; pivot 1's row is corrected by pivot 0 where pivot 0 eliminates it;
// one sweep applies both eliminations and both coefficient bits.
//
// The state, its loads and the exchange are scan_cluster.cuh's (read its
// header for what bounds a scan here): rows cut into nb contiguous ranges, a
// block's slice words in shared memory as 16-byte halves, used flags in a
// register mask, coefficient words in registers, slots sent with st.async and
// counted on an mbarrier.  What the pair changes:
//
//   * Both columns lie in the same word sw (jj0 is even), so ONE load of a
//     thread's half serves both candidacy tests and the sweep.
//   * ONE election and ONE exchange per pair.  A row's column-1 candidacy
//     needs pivot 0 only through pivot 0's own bit jj0 + 1, h:
//         cand1_h(r) = valid1 & free(r) & (bit1(r) ^ (cand0(r) & h)).
//     Applied to pivot 0 itself this is h ^ h = 0, so the formula excludes
//     pivot 0 with no test of its row: pivot 1 is the lowest row of
//     cand1_h over the cluster.  Each block therefore elects, in the same
//     round of three independent reductions, m0 (its lowest column-0
//     candidate), P0 (its lowest row of cand1_0) and P1 (of cand1_1), and
//     sends (m0, P0, P1, m0's bit jj0 + 1) with m0's words.  After the
//     exchange every warp takes pivot 0 as the first block's m0, h as its
//     bit, and pivot 1 as the first block's P_h (the ranges ascend with the
//     rank).
//   * Pivot 1's words travel in the slot: every block sends the words of its
//     P0 and P1 rows beside m0's (seven quads a slot against three), so no
//     warp waits on a load after the election.  The other form, the slot with
//     m0's words alone and every warp reading pivot 1's halves from the
//     owner's shared memory through distributed shared memory after the
//     election (safe: a row is never rewritten once it pivots, and the
//     owner's previous sweep is complete before it sends its slot), was
//     measured on the H100 at 20224 random rows on 16 blocks: 1.83 against
//     1.74 us a pair, the dependent remote load costing more than four more
//     st.async a lane (it won by 2-11% on 2 and 4 blocks, which no flagship
//     slice takes).
//
// Invalid columns stay cluster-uniform and depend on the arguments alone: a
// pair with no valid column costs nothing; a pair with one valid column (the
// first column 0 at w0 = 0, or a last valid column on either parity) runs the
// same code with the other column's candidates empty.
//
// kChain makes the body one link of the chained two-pivot scan
// (scan2_chunked.cu), as it makes scan_cluster_body one link of the 1-pivot
// chain (read scan_chunked.cu for why a chain is exact): the cluster scans the
// rows [base, base + rows) of a slice of ld rows and applies the pivots the
// chunks before it elected, from the record of the columns taken (ScanChain;
// the same layout, loaded into shared memory after the two-pivot header).  A
// pair (jj0, jj0 + 1) then falls in one of four cases, each cluster-uniform
// because the record is the same in every block:
//   1. both taken: both recorded pivots swept in order, with no election;
//   2. jj0 taken, jj0 + 1 not: pivot 0 swept from the record, then the pair's
//      election with column 0 empty (the sweep cleared bit jj0 of every
//      candidate, so pivot 1 needs no correction);
//   3. jj0 not taken, jj0 + 1 taken: the election with column 1 empty, then
//      pivot 1 swept from the record.  Its words need no correction by this
//      chunk's pivot 0: that row lies in an earlier chunk, which had no free
//      row with bit jj0 (column jj0 is not taken), so its bit jj0 was 0;
//   4. neither taken: the pair's election as above.
// So the loop walks columns, not pairs: a run of taken columns within a word
// is swept with the thread's rows in registers (sweep_taken_run, as the
// 1-pivot chain does), and may end on either parity; an election takes the
// pair of the column it starts at, with the column before it empty when a run
// swept that one.  An elected pivot is the global one: the writer stores it in
// prow and in the record, pivot 1 with its words after pivot 0's correction
// (the slot carries them uncorrected).  The first chunk loads no record and
// writes prow and the record's rows at every column.
#pragma once

#include "scan_cluster.cuh"

namespace gf2 {

// One slot of the exchange, in quads: the halves of m0, of P0 and of P1,
// then (m0, P0, P1, m0's bit jj0 + 1).
constexpr int kScan2SlotQuads = 7;
// The two-pivot header: slots [2][kMaxCluster][kScan2SlotQuads], the warps'
// records [2][16 warps] (one quad each: m0, P0, P1), the mbarriers.
constexpr int kScan2HeaderQuads =
    2 * kMaxCluster * kScan2SlotQuads + 2 * (kClusterThreads / 32) + 1;

// Words of quad x below word q zeroed: a pivot changes the words from sw on.
__device__ __forceinline__ uint4 from_word(uint4 x, int q) {
  if (q > 0) x.x = 0u;
  if (q > 1) x.y = 0u;
  if (q > 2) x.z = 0u;
  return x;
}

// Every word of x ANDed with m.
__device__ __forceinline__ uint4 and4(uint4 x, uint32_t m) {
  return make_uint4(x.x & m, x.y & m, x.z & m, x.w & m);
}

// The two-pivot scan of one system by the calling cluster; arguments,
// kCluster and kSlots as scan_cluster_body's, smem4 sized with
// kScan2HeaderQuads (and kRecordQuads after it with kChain).  K = 32 kw is
// even.  kChain: bT_in, used_in, used_out and cT point at the chunk's first
// row, rows is the chunk's, chain.ld the slice's.
template <bool kCluster, int kSlots, bool kChain = false>
__device__ __forceinline__ void
scan2_cluster_body(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                   int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                   uint32_t* __restrict__ cT, int rows, int kw, int w0, int cols, int rpb,
                   int rpb_pad, uint4* smem4, int rank, int nb, ScanChain chain = {}) {
  constexpr int slot_quads = kScan2SlotQuads, header = kScan2HeaderQuads;
  constexpr int nthreads = kClusterThreads, nwarps = kClusterThreads / 32;
  uint4* slots = smem4;  // [2][kMaxCluster][slot_quads]
  int4* recs = reinterpret_cast<int4*>(smem4 + 2 * kMaxCluster * slot_quads);  // [2][nwarps]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem4 + header - 1);           // [2]
  uint4* rec_w = smem4 + header;                                      // kChain: [K][2]
  int* rec_row = reinterpret_cast<int*>(rec_w + 2 * kMaxRecordCols);  // kChain: [K]
  uint4* bT_s = smem4 + header + (kChain ? kRecordQuads : 0);        // [halves][rpb_pad]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int halves = (kw + 3) >> 2;
  const int row0 = rank * rpb;
  const int nloc = max(0, min(rpb, rows - row0));
  const bool writer = rank == 0 && tid == 0;
  const int ld = kChain ? chain.ld : rows;      // the stride of bT_in and cT
  const int base = kChain ? chain.base : 0;     // global row of local row 0
  const bool chained = kChain && !chain.first;  // earlier chunks took columns

  uint32_t live = 0u;  // bit i: row row0 + i * nthreads + tid exists and is unused
  uint32_t c[kSlots];  // its coefficient word for the current 32 columns
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
  uint32_t wait_parity = 0u;
  if (kCluster) {
    if (tid == 0) {
      mbar_init(smem_addr(&mbar[0]), 1);
      mbar_init(smem_addr(&mbar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cooperative_groups::this_cluster().sync();
  }

  const long long first = 1LL - 32LL * w0, last = (long long)cols - 32LL * w0;
  const int jlo = (int)max(0LL, min((long long)K, first));
  const int jhi = (int)max(0LL, min((long long)K, last + 1));
  int p = 0;
  for (int jj = 0; jj < K;) {  // a step: a run of taken columns, or a pair's election
    const int sw = jj >> 5, hs = sw >> 2, q = sw & 3;
    const int jj0 = jj & ~1;
    int next;  // the first column after this step; a step never leaves word sw
    if (chained && jj >= jlo && jj < jhi && rec_row[jj] >= 0) {  // cluster-uniform: the record
      next = taken_run_end(rec_row, jj, jhi);
      sweep_taken_run<kSlots>(bT_s, rec_w, rpb_pad, halves, live, c, jj, next, tid, nthreads);
    } else {
      // the pair (jj0, jj0 + 1): column jj0 is empty when a run swept it (jj
      // odd), column jj0 + 1 when it is taken (the next step's run sweeps it)
      const bool taken1 = chained && jj0 + 1 >= jlo && jj0 + 1 < jhi && rec_row[jj0 + 1] >= 0;
      const bool valid0 = jj == jj0 && jj0 >= jlo && jj0 < jhi;
      const bool valid1 = !taken1 && jj0 + 1 >= jlo && jj0 + 1 < jhi;
      next = taken1 ? jj0 + 1 : jj0 + 2;
      const uint32_t bit0 = 1u << (jj0 & 31), bit1 = bit0 << 1;
      int piv0 = rows, piv1 = rows;
      if (valid0 || valid1) {  // cluster-uniform
        // this thread's rows: the half that holds word sw, and for the rows a
        // pivot may eliminate the half above it, kept in registers for the sweep
        uint4 v[kSlots], u[kSlots];
        uint32_t c0m = 0u, b1m = 0u;  // bit i: row i has bit jj0, bit jj0 + 1 (unused rows)
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          v[i] = zero;
          if ((live >> i) & 1u) v[i] = bT_s[hs * rpb_pad + i * nthreads + tid];
          const uint32_t w = word_of(v[i], q);
          c0m |= ((w >> (jj0 & 31)) & 1u) << i;
          b1m |= ((w >> ((jj0 & 31) + 1)) & 1u) << i;
        }
        if (!valid0) c0m = 0u;               // cand0
        if (!valid1) b1m = 0u;               // cand1_0
        const uint32_t x1m = b1m ^ (valid1 ? c0m : 0u);  // cand1_1
        const bool upper = hs == 0 && halves == 2;
#pragma unroll
        for (int i = 0; i < kSlots; ++i)
          if (upper && (((c0m | b1m) >> i) & 1u)) u[i] = bT_s[rpb_pad + i * nthreads + tid];
        // rows ascend with i: a mask's lowest bit is the thread's lowest row
        const int m0 = c0m ? row0 + (__ffs(c0m) - 1) * nthreads + tid : rows;
        const int pa = b1m ? row0 + (__ffs(b1m) - 1) * nthreads + tid : rows;
        const int pb = x1m ? row0 + (__ffs(x1m) - 1) * nthreads + tid : rows;

        // the block's m0, P0, P1: three independent reductions a level
        {
          const int a0 = __reduce_min_sync(full, m0), a1 = __reduce_min_sync(full, pa),
                    a2 = __reduce_min_sync(full, pb);
          if (lane == 0) recs[p * nwarps + warp] = make_int4(a0, a1, a2, 0);
        }
        __syncthreads();
        // the block's m0, P0, P1 over the warps' records: with nb > 1 only the
        // warp that sends the slot needs them
        int bm0 = rows, bpa = rows, bpb = rows;
        if (!kCluster || warp == 0) {
          const int4 rec =
              lane < nwarps ? recs[p * nwarps + lane] : make_int4(rows, rows, rows, 0);
          bm0 = __reduce_min_sync(full, rec.x);
          bpa = __reduce_min_sync(full, rec.y);
          bpb = __reduce_min_sync(full, rec.z);
        }

        uint4 x0l = zero, x0h = zero, x1l = zero, x1h = zero;  // the pivots' halves 0 and 1
        bool h = false;  // pivot 0's bit jj0 + 1
        if (!kCluster) {
          piv0 = bm0;
          if (piv0 < rows) {
            x0l = bT_s[piv0 - row0];
            if (halves == 2) x0h = bT_s[rpb_pad + piv0 - row0];
            h = word_of(hs ? x0h : x0l, q) & bit1;
          }
          piv1 = h ? bpb : bpa;
          if (piv1 < rows) {
            x1l = bT_s[piv1 - row0];
            if (halves == 2) x1h = bT_s[rpb_pad + piv1 - row0];
          }
        } else {
          const uint32_t bar = smem_addr(&mbar[p]);
          if (tid == 0) mbar_arrive_expect(bar, (uint32_t)(nb * slot_quads * sizeof(uint4)));
          if (warp == 0) {
            uint4 wq[6];  // halves of m0, P0, P1
            const int sent[3] = {bm0, bpa, bpb};
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              wq[2 * k] = wq[2 * k + 1] = zero;
              if (sent[k] < rows) {
                wq[2 * k] = bT_s[sent[k] - row0];
                if (halves == 2) wq[2 * k + 1] = bT_s[rpb_pad + sent[k] - row0];
              }
            }
            if (lane < nb) {
              const uint32_t dst =
                  remote_addr(smem_addr(slots + (p * kMaxCluster + rank) * slot_quads), lane);
              const uint32_t rbar = remote_addr(bar, lane);
#pragma unroll
              for (int k = 0; k < slot_quads - 1; ++k) store_async16(dst + 16 * k, wq[k], rbar);
              // m0's bit jj0 + 1 rides along, so h needs no load of m0's words
              const uint32_t hb = (word_of(hs ? wq[1] : wq[0], q) >> ((jj0 & 31) + 1)) & 1u;
              store_async16(dst + 16 * (slot_quads - 1),
                            make_uint4((uint32_t)bm0, (uint32_t)bpa, (uint32_t)bpb, hb), rbar);
            }
          }
          mbar_wait(bar, (wait_parity >> p) & 1u);
          wait_parity ^= 1u << p;
          const uint4* sl = slots + p * kMaxCluster * slot_quads;
          const uint4 info = lane < nb ? sl[lane * slot_quads + slot_quads - 1]
                                       : make_uint4(rows, rows, rows, 0u);
          const unsigned has0 = __ballot_sync(full, (int)info.x < rows);
          if (has0) {  // the ranges ascend with the rank: the first block with a candidate
            const int wb = __ffs(has0) - 1;
            piv0 = __shfl_sync(full, (int)info.x, wb);
            h = __shfl_sync(full, info.w, wb);
            x0l = sl[wb * slot_quads];
            x0h = sl[wb * slot_quads + 1];
          }
          const int cand = h ? (int)info.z : (int)info.y;
          const unsigned has1 = __ballot_sync(full, cand < rows);
          if (has1) {
            const int wb = __ffs(has1) - 1;
            piv1 = __shfl_sync(full, cand, wb);
            x1l = sl[wb * slot_quads + (h ? 4 : 2)];
            x1h = sl[wb * slot_quads + (h ? 5 : 3)];
          }
        }
        p ^= 1;

        if (piv0 < rows || piv1 < rows) {  // cluster-uniform
          // pivot 1's row, corrected by pivot 0 where pivot 0 eliminates it
          if (valid0 && (word_of(hs ? x1h : x1l, q) & bit0)) {
            x1l = xor4(x1l, x0l);
            x1h = xor4(x1h, x0h);
          }
          if (kChain && writer) {  // the pivots' words as they stand at their steps
            uint4* gw = reinterpret_cast<uint4*>(chain.record);
            if (piv0 < rows) {
              gw[2 * jj0] = x0l;
              gw[2 * jj0 + 1] = x0h;
            }
            if (piv1 < rows) {
              gw[2 * jj0 + 2] = x1l;
              gw[2 * jj0 + 3] = x1h;
            }
          }
          const uint4 y0 = from_word(hs ? x0h : x0l, q), y1 = from_word(hs ? x1h : x1l, q);
          uint32_t e0m = c0m, e1m = h ? x1m : b1m;  // the rows each pivot eliminates
          // the pivots' own rows are used from here on: pivot 1 keeps only its
          // coefficient bit of column 0
          const int l0 = piv0 - row0, l1 = piv1 - row0;
          if ((unsigned)l0 < (unsigned)nloc && (l0 & (nthreads - 1)) == tid) {
            const uint32_t bi = 1u << (l0 / nthreads);
            live &= ~bi;
            e0m &= ~bi;
            e1m &= ~bi;
          }
          if ((unsigned)l1 < (unsigned)nloc && (l1 & (nthreads - 1)) == tid) {
            const int i1 = l1 / nthreads;
#pragma unroll
            for (int i = 0; i < kSlots; ++i)
              if (i == i1 && ((e0m >> i) & 1u)) c[i] ^= bit0;
            const uint32_t bi = 1u << i1;
            live &= ~bi;
            e0m &= ~bi;
            e1m &= ~bi;
          }
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            if (!(((e0m | e1m) >> i) & 1u)) continue;
            const uint32_t s0 = 0u - ((e0m >> i) & 1u), s1 = 0u - ((e1m >> i) & 1u);
            const int loc = i * nthreads + tid;
            bT_s[hs * rpb_pad + loc] = xor4(v[i], xor4(and4(y0, s0), and4(y1, s1)));
            if (upper) bT_s[rpb_pad + loc] = xor4(u[i], xor4(and4(x0h, s0), and4(x1h, s1)));
            c[i] ^= (bit0 & s0) | (bit1 & s1);
          }
        }
      }
      // a later chunk writes only the columns it elects: the first wrote the rest
      if (writer) {
        if (!chained || piv0 < rows) {
          const int g = piv0 < rows ? base + piv0 : -1;
          prow[jj0] = g;
          if (kChain) chain.record[8 * K + jj0] = g;
        }
        if (!chained || piv1 < rows) {
          const int g = piv1 < rows ? base + piv1 : -1;
          prow[jj0 + 1] = g;
          if (kChain) chain.record[8 * K + jj0 + 1] = g;
        }
      }
    }
    if ((next & 31) == 0) {  // word sw of the coefficients is final
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int loc = i * nthreads + tid;
        if (loc < nloc) cT[(size_t)sw * ld + row0 + loc] = c[i];
        c[i] = 0u;
      }
    }
    jj = next;
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int loc = i * nthreads + tid;
    if (loc < nloc) used_out[row0 + loc] = (int32_t)(((live >> i) & 1u) ^ 1u);
  }
  // no block exits while another may still write into, or read from, its
  // shared memory
  if (kCluster) cooperative_groups::this_cluster().sync();
}

}  // namespace gf2
