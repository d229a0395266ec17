// The Four-Russians table update as a body other kernels call: one block's
// share (a strip of 4 word columns, a chunk of rows) of
// a[i] ^= XOR{pf[t] : bit t of sel[i]}, and the host-side arithmetic that cuts
// an update into such shares.  update_table.cu launches it as a kernel of its
// own (the panel updates and the rebuilds' product); panel_update.cu runs it
// in the update clusters of the fused update + scan, phase1_fused.cu as the
// product pf = T . a[prow] of the fused phase 1.  The design and what
// bounds it are described in update_table.cu.
#pragma once

#include "gf2_common.cuh"

namespace gf2 {

constexpr int kTabThreads = 512;
constexpr int kStrip = 4;        // words per table entry
constexpr int kRowsInFlight = 4; // rows a thread loads before it computes

// Words p[0..3], of which the first n (1..4) exist; vec: p is 16-byte aligned
// and n == 4.
__device__ __forceinline__ uint4 load4(const uint32_t* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 v = make_uint4(p[0], 0u, 0u, 0u);
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}

__device__ __forceinline__ void store4(uint32_t* p, uint4 v, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

// The four table reads of selector word g.
__device__ __forceinline__ uint4 lookup_word(uint4 acc, const uint4* tab, int g, uint32_t s) {
  const uint4* t4 = tab + (4 * g) * 256;
  acc = xor4(acc, t4[s & 255u]);
  acc = xor4(acc, t4[256 + ((s >> 8) & 255u)]);
  acc = xor4(acc, t4[512 + ((s >> 16) & 255u)]);
  return xor4(acc, t4[768 + (s >> 24)]);
}

// Shared memory of a block of kTabThreads threads: the 4 * kw tables of 256
// entries, then pf's rows on the strip.
inline size_t table_smem_bytes(int kw) {
  return (size_t)(4 * kw * 256 + 32 * kw) * sizeof(uint4);
}

// Strip `strip` of the live words, rows [chunk * chunk_rows, + chunk_rows), by
// the calling block of kTabThreads threads; smem4 has table_smem_bytes(kw).
// Strip 0 is word 0 alone when const_word is set; the others are 4 words from
// word_lo on (the last may be cut by wp).  aligned: a and pf rows and word_lo
// allow 16-byte accesses; sel_vec: kw == 8 and sel rows are 16-byte aligned.
// kProduct: a is written, never read (out = S . PF).  kRowIndex: row t of PF
// is row pf_rows[t] of the matrix pf, zero where pf_rows[t] < 0 (the fused
// phase 1 reads its pivot rows in place; sel may then lie in shared memory).
template <bool kProduct, bool kRowIndex = false>
__device__ __forceinline__ void
table_update_body(uint32_t* a, const uint32_t* __restrict__ sel,
                  const uint32_t* __restrict__ pf, int rows, int wp, int kw, int word_lo,
                  int const_word, int chunk_rows, int aligned, int sel_vec, int strip,
                  int chunk, uint4* smem4, const int32_t* pf_rows = nullptr) {
  const int ngroups = 4 * kw;            // groups of 8 selector bits
  uint4* tab = smem4;                    // [ngroups][256]
  uint4* pf_s = smem4 + ngroups * 256;   // [32 * kw]: pf's rows on this strip
  const int tid = threadIdx.x;
  const bool is_const = const_word && strip == 0;
  const int w = is_const ? 0 : word_lo + kStrip * (strip - const_word);
  const int n = is_const ? 1 : min(kStrip, wp - w);
  const bool vec = aligned && n == kStrip;

  for (int t = tid; t < 32 * kw; t += kTabThreads) {
    if (kRowIndex) {
      const int pr = pf_rows[t];
      pf_s[t] = pr >= 0 ? load4(pf + (size_t)pr * wp + w, n, vec) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      pf_s[t] = load4(pf + (size_t)t * wp + w, n, vec);
    }
  }
  __syncthreads();
  // 16 threads a table: thread lo starts from the combination of the group's
  // rows 0-3 that the bits of lo select and doubles it over rows 4-7 in
  // registers, then stores its 16 entries (lo, 16 + lo, ...): a group's
  // threads write neighbouring entries, and no barrier splits the build.
  for (int t = tid; t < 16 * ngroups; t += kTabThreads) {
    const int g = t >> 4, lo = t & 15;
    const uint4* rows8 = pf_s + 8 * g;
    uint4 e[16];
    e[0] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if ((lo >> b) & 1) e[0] = xor4(e[0], rows8[b]);
    const uint4 r4 = rows8[4], r5 = rows8[5], r6 = rows8[6], r7 = rows8[7];
    e[1] = xor4(e[0], r4);
    e[2] = xor4(e[0], r5);
    e[3] = xor4(e[1], r5);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[4 + i] = xor4(e[i], r6);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[8 + i] = xor4(e[i], r7);
#pragma unroll
    for (int hi = 0; hi < 16; ++hi) tab[g * 256 + 16 * hi + lo] = e[hi];
  }
  __syncthreads();

  // kRowsInFlight rows a thread at a time: their loads of a and of the selector
  // words are all started before the first table read, so the memory latency of
  // a row is paid once per batch (a block has only 16 warps to hide it with).
  const int row0 = chunk * chunk_rows;
  const int row1 = min(rows, row0 + chunk_rows);
  for (int r = row0 + tid; r < row1; r += kRowsInFlight * kTabThreads) {
    uint4 acc[kRowsInFlight];
    uint32_t s[kRowsInFlight][8];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const int rr = r + j * kTabThreads;
      if (rr >= row1) break;
      const uint32_t* ap = a + (size_t)rr * wp + w;
      acc[j] = kProduct ? make_uint4(0u, 0u, 0u, 0u) : load4(ap, n, vec);
      const uint32_t* sp = sel + (size_t)rr * kw;
      if (sel_vec) {
        const uint4 lo = *reinterpret_cast<const uint4*>(sp);
        const uint4 hi = *reinterpret_cast<const uint4*>(sp + 4);
        s[j][0] = lo.x, s[j][1] = lo.y, s[j][2] = lo.z, s[j][3] = lo.w;
        s[j][4] = hi.x, s[j][5] = hi.y, s[j][6] = hi.z, s[j][7] = hi.w;
      } else {
#pragma unroll
        for (int g = 0; g < 8; ++g) s[j][g] = g < kw ? sp[g] : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const int rr = r + j * kTabThreads;
      if (rr >= row1) break;
#pragma unroll
      for (int g = 0; g < 8; ++g)
        if (g < kw) acc[j] = lookup_word(acc[j], tab, g, s[j][g]);
      store4(a + (size_t)rr * wp + w, acc[j], n, vec);
    }
  }
}

// Row chunks per strip.  A block's cost, in table reads per thread, is about
// 2 rows' worth for the table build plus its rows per thread; the grid runs
// in waves of one block per SM on the nsm SMs it may use.  Among the chunk
// counts from the fewest (4096 rows a chunk, or what fills the SMs once) up
// to 8 more, take the one with the least waves x cost.  nstrips counts the
// strips of every problem of a batch.
inline int pick_chunks(int rows, int nstrips, int nsm) {
  const int by_rows = (rows + 4095) / 4096;
  const int to_fill = (nsm + nstrips - 1) / nstrips;
  const int most = (rows + 31) / 32;
  int lo = by_rows > to_fill ? by_rows : to_fill;
  if (lo > most) lo = most;
  int best = lo;
  long best_cost = -1;
  for (int c = lo; c <= lo + 8 && c <= most; ++c) {
    const long waves = ((long)nstrips * c + nsm - 1) / nsm;
    const long per_thread = ((rows + c - 1) / c + kTabThreads - 1) / kTabThreads;
    const long cost = waves * (2 + per_thread);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// How an update under the rule (word_lo, const_word) is cut into blocks.
struct TableGrid {
  int const_word;  // 1: strip 0 is word 0 alone
  int nstrips;     // strips of one problem; 0: nothing to update
  int chunk_rows;  // rows of a chunk, a multiple of 32
  int nchunks;
  int aligned;     // 16-byte accesses to a and pf
  int sel_vec;     // 16-byte accesses to sel
};

// False for arguments the body does not take.  nsm: the SMs the update's
// blocks may use at once, one block each; batch: problems sharing the grid.
inline bool table_grid(const uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                       int wp, int kw, int word_lo, int const_word, int batch, int nsm,
                       TableGrid* g) {
  if (kw < 1 || kw > 8 || rows < 1 || wp < 1 || word_lo < 0 || word_lo > wp || batch < 1 ||
      nsm < 1)
    return false;
  g->const_word = (const_word && word_lo > 0) ? 1 : 0;  // else word 0 is live already
  g->nstrips = (wp - word_lo + kStrip - 1) / kStrip + g->const_word;
  g->chunk_rows = g->nchunks = 0;
  // every problem of a batch is as aligned as the first: the strides are whole rows
  g->aligned = wp % 4 == 0 && word_lo % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(pf) % 16 == 0;
  g->sel_vec = kw == 8 && reinterpret_cast<uintptr_t>(sel) % 16 == 0;
  if (g->nstrips == 0) return true;
  const int chunks = pick_chunks(rows, g->nstrips * batch, nsm);
  g->chunk_rows = (((rows + chunks - 1) / chunks) + 31) & ~31;
  g->nchunks = (rows + g->chunk_rows - 1) / g->chunk_rows;
  return true;
}

}  // namespace gf2
