// The subset-first pivot scan of one K-column panel: the default engine's
// scan on the card (ops/phase1.py: scan_subset).  Same contract as the
// cluster scan (scan_cluster.cuh): in bT (kw, rows), used (rows,), w0, cols;
// out prow (K,), used' (rows,), cT (kw, rows); the pivot of a column is the
// lowest unused row with the bit set.  cT is exact on the rows of the subset
// (below) and on every row where the fallback ran; the solver reads it only
// at the pivot rows.
//
// Why a subset is exact.  Take the subset to be the first S unused rows of
// the slice, and sub_end the row after the last of them: every unused row
// below sub_end is in the subset, and every other unused row lies above it.
// At a column where the subset has a candidate, its lowest is the global
// pivot, and the elimination gives the subset's rows what the full scan
// gives them.  So by induction over the panel's columns the subset scan
// returns the full scan's prow, used' and the pivot rows' coefficient words,
// unless at some valid column the subset has no candidate while a row above
// sub_end, reduced by the subset's pivots of the columns before, has the bit:
// a miss.  Where the unused rows number S or fewer, the subset is all of them
// and nothing can miss.
//
// One call, three launches on the stream, none of which the host waits on:
//   1. scan_subset_kernel, ONE block on one SM: gathers the first S unused
//      rows by an in-block prefix sum over used, scans them, writes prow, cT
//      (the subset's rows), the record of its pivots (each pivot's slice words
//      as they stood at its election, and its row, the chained scan's layout)
//      and a header; sets *decided = 1 and flags the header where a valid
//      column was left free while unused rows lie above sub_end;
//   2. scan_subset_test_kernel, a block per 256 rows: writes used' (used, and
//      the record's rows), and only where the header is flagged reduces every
//      unused row above sub_end by the record, column by column, and sets
//      *decided = 0 at a free column where such a row has the bit;
//   3. the fallback: the cluster scan (scan.cu) or, past the largest
//      cluster's rows, the chained scan (scan_chunked.cu) over every row, from
//      the saved slice and the original used, with an early-exit prologue that
//      returns at once unless *decided is 0.  So a miss rescans the panel from
//      scratch, and every output equals the full scan's.
//
// What bounds the subset scan on the H100: its 256 dependent steps, as for
// every scan here, but a step no longer waits on a block barrier or a
// cluster's exchange.  Within a word of the panel only that word of each row
// takes part in a step.  So one warp holds the S rows' current word in
// registers (kLane = S / 32 rows a lane, ascending with the lane) and takes
// the word's 32 columns alone: a step builds each lane's candidate mask and
// picks its lowest candidate's word, elects the lowest lane by a ballot,
// broadcasts the pivot's word by one shuffle, and sweeps it into the
// candidates, recording their coefficient bits.  The steps are
// software-pipelined (below), and the step loop is not unrolled: unrolled
// over the 32 columns its code outgrew the instruction cache.  A step is then
// bound by the ~170 integer instructions one warp issues on its scheduler;
// four warps that exchange each step's election through shared memory, by a
// barrier or as a chain, took longer (PERF.md §6).
//
// The later words of the panel are brought up to date once per word, from
// the recorded coefficients: the word's pivots' later words at their election
// are a triangular solve over 32 rows (a warp per word, the steps as shuffle
// broadcasts, the rebuild's scheme), and then every row XORs in the pivots its
// coefficient word names.  Only word g + 1 is on the chain's path: the words
// above it take group g's pivots while warp 0 runs the steps of group g + 1
// (the coefficients are double-buffered; the warps that share warp 0's
// scheduler stay out of it).  Shared memory holds the subset's words with row
// i of a lane at [i][lane], so warp 0's loads and stores are conflict-free.
#include "scan_chunked.cuh"
#include "scan_cluster.cuh"

namespace {

constexpr int kSubsetRows = 512;                   // S: ops/phase1.py's SCAN_SUBSET_ROWS
constexpr int kSubsetLane = kSubsetRows / 32;      // rows a lane of warp 0 holds
constexpr int kSubsetThreads = 512;
constexpr int kSubsetWarps = kSubsetThreads / 32;
constexpr int kSubsetKw = 8;                       // words of a panel row at most (K <= 256)
constexpr int kSubsetCols = 32 * kSubsetKw;
constexpr int kGatherRounds = 16;                  // rows a thread reads a pass of the gather
constexpr int kTestThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Where slot s of the subset lies in a word's row of shared memory: lane
// s / kLane owns it as its row s % kLane.
template <int kLane>
__device__ __forceinline__ int spos(int s) {
  return (s % kLane) * 32 + s / kLane;
}

// w[s] for a runtime s < N, by a tree of selects on the bits of s, top bit
// first (an index into a register array would put the array in local
// memory).  Every loop bound is a template constant, so every index is one.
template <int H>
struct PickLevel {
  template <int P>
  __device__ __forceinline__ static void run(uint32_t (&v)[P], int s) {
    const bool hi = (s & H) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) v[j] = hi ? v[j + H] : v[j];
    PickLevel<H / 2>::run(v, s);
  }
};

template <>
struct PickLevel<0> {
  template <int P>
  __device__ __forceinline__ static void run(uint32_t (&)[P], int) {}
};

template <int H>
struct OrLevel {
  template <int P>
  __device__ __forceinline__ static void run(uint32_t (&v)[P]) {
#pragma unroll
    for (int j = 0; j < H; ++j) v[j] |= v[j + H];
    OrLevel<H / 2>::run(v);
  }
};

template <>
struct OrLevel<0> {
  template <int P>
  __device__ __forceinline__ static void run(uint32_t (&)[P]) {}
};

template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[N], int s) {
  constexpr int P = N <= 8 ? 8 : N <= 16 ? 16 : 32;
  uint32_t v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = i < N ? w[i] : 0u;
  PickLevel<P / 2>::run(v, s);
  return v[0];
}

// The bit mask of the rows whose m[i] is all ones (m[i] is 0 or all ones), by
// a tree of ORs.
template <int N>
__device__ __forceinline__ uint32_t or_bits(const uint32_t (&m)[N]) {
  constexpr int P = N <= 8 ? 8 : N <= 16 ? 16 : 32;
  uint32_t v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = i < N ? m[i] & (1u << i) : 0u;
  OrLevel<P / 2>::run(v);
  return v[0];
}

// The mask of the rows of w with bit b set: row i's word rotated so that
// bit b lands on bit i.
template <int N>
__device__ __forceinline__ uint32_t column_bits(const uint32_t (&w)[N], int b) {
  uint32_t m[N];
#pragma unroll
  for (int i = 0; i < N; ++i) m[i] = __funnelshift_r(w[i], w[i], b - i);
  return or_bits(m);
}

// scratch: the record, words [K][8] then rows [K] (as the chained scan's), and
// the header [3]: flag, sub_end, the subset's rows.
template <int kLane>
__global__ void __launch_bounds__(kSubsetThreads, 1)
scan_subset_kernel(const uint32_t* __restrict__ bT, const int32_t* __restrict__ used,
                   int32_t* __restrict__ prow, uint32_t* __restrict__ cT,
                   int32_t* __restrict__ scratch, int32_t* __restrict__ decided, int rows,
                   int kw, int w0, int cols) {
  constexpr int S = 32 * kLane;
  __shared__ int idx_s[S];                           // global row of slot s
  __shared__ uint32_t words_s[kSubsetKw][S];         // the subset's words, at spos
  __shared__ uint32_t coef_s[2][S];                  // a group's coefficient words, at spos
  __shared__ uint32_t rec_s[kSubsetCols][kSubsetKw];  // the pivots' words at election
  __shared__ int pslot_s[kSubsetCols];               // the slot of a column's pivot, or -1
  __shared__ int cnt_s[kGatherRounds * kSubsetWarps];  // a pass's unused rows per warp and round
  __shared__ int total_s, free_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = 32 * kw;
  if (tid == 0) {
    *decided = 1;
    free_s = 0;
  }
  for (int j = tid; j < kSubsetCols; j += kSubsetThreads) {
    pslot_s[j] = -1;
#pragma unroll
    for (int g = 0; g < kSubsetKw; ++g) rec_s[j][g] = 0u;
  }

  // 1. the first S unused rows, in order.  A pass reads kGatherRounds rounds of
  // 512 consecutive rows (coalesced); a warp's ballot of a round gives its 32
  // rows, warp 0 sums the counts in row order, and each unused row takes its
  // place from its warp's offset and its lanes below
  int found = 0;  // block-uniform
  for (int base = 0; found < S && base < rows; base += kGatherRounds * kSubsetThreads) {
    unsigned bal[kGatherRounds];
#pragma unroll
    for (int k = 0; k < kGatherRounds; ++k) {
      const int r = base + k * kSubsetThreads + tid;
      bal[k] = __ballot_sync(kFull, r < rows && used[r] == 0);
    }
    if (lane < kGatherRounds) {
      unsigned mine = 0u;
#pragma unroll
      for (int k = 0; k < kGatherRounds; ++k) mine = k == lane ? bal[k] : mine;
      cnt_s[lane * kSubsetWarps + warp] = __popc(mine);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive offsets of the 256 (round, warp) entries, 8 a lane
      constexpr int per = kGatherRounds * kSubsetWarps / 32;
      int v[per], sum = 0;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        v[e] = cnt_s[per * lane + e];
        sum += v[e];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int at = incl - sum;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        cnt_s[per * lane + e] = at;
        at += v[e];
      }
      if (lane == 31) total_s = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kGatherRounds; ++k) {
      if ((bal[k] >> lane) & 1u) {
        const int at = found + cnt_s[k * kSubsetWarps + warp] + __popc(bal[k] & below);
        if (at < S) idx_s[at] = base + k * kSubsetThreads + tid;
      }
    }
    found += total_s;
    __syncthreads();  // cnt_s and total_s are written again by the next pass
  }
  const int n = min(found, S);

  // 2. the subset's words; slots past n are zero and never candidates
  for (int s = tid; s < S; s += kSubsetThreads) {
    const int r = s < n ? idx_s[s] : -1;
#pragma unroll
    for (int g = 0; g < kSubsetKw; ++g)
      words_s[g][spos<kLane>(s)] = r >= 0 && g < kw ? bT[(size_t)g * rows + r] : 0u;
  }
  __syncthreads();

  // 3. the steps, a word of 32 columns at a time; valid columns [jlo, jhi).
  // The warps that share warp 0's scheduler (warp % 4 == 0) stay idle while it
  // steps; the other twelve bring the later words up to date meanwhile.
  const long long first = 1LL - 32LL * w0, last = (long long)cols - 32LL * w0;
  const int jlo = (int)max(0LL, min((long long)K, first));
  const int jhi = (int)max(0LL, min((long long)K, last + 1));
  constexpr int kHelpers = kSubsetThreads - kSubsetThreads / 4;
  const int helper = (warp - warp / 4 - 1) * 32 + lane;  // for warp % 4 != 0
  uint32_t live = 0u;  // warp 0, bit i: slot kLane * lane + i exists and is unused
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kLane; ++i)
      if (kLane * lane + i < n) live |= 1u << i;
  }
  for (int g = 0; g < kw; ++g) {
    const int cb = g & 1;  // this group's coefficient buffer
    if (warp == 0) {
      // a row that is used or was a pivot holds the word 0, so it is never a
      // candidate; a pivot's own sweep zeroes it
      uint32_t w[kLane], c[kLane];
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        w[i] = (live >> i) & 1u ? words_s[g][i * 32 + lane] : 0u;
        c[i] = 0u;
      }
      uint32_t pivots = 0u;  // bit i: row i of this lane pivoted in this word
      bool any_free = false;
      const int blo = max(jlo - 32 * g, 0), bhi = min(jhi - 32 * g, 32);
      // The steps are software-pipelined: while a step waits for its pivot's
      // word, it reads the next column's bits from the words as they stand, and
      // the pivot's word then only flips them on its candidates.  So the
      // dependent chain of a step is the broadcast, a flip, one find-first and
      // the pick of the lane's candidate word.
      uint32_t cand = blo < bhi ? column_bits(w, blo) : 0u;
#pragma unroll 1
      for (int b = blo; b < bhi; ++b) {
        const int nb = min(b + 1, 31);
        const uint32_t next = column_bits(w, nb);  // column b + 1 before this step's sweep
        const int sl = __ffs(cand) - 1;  // this lane's lowest candidate
        const uint32_t mine = pick(w, sl);
        const unsigned any = __ballot_sync(kFull, cand != 0u);
        if (!any) {
          any_free = true;
          cand = next;
          continue;
        }
        const int L = __ffs(any) - 1;  // the lowest lane with a candidate holds the pivot
        const uint32_t pw = __shfl_sync(kFull, mine, L);
        if (lane == L) {
          pivots |= 1u << sl;
          pslot_s[32 * g + b] = kLane * L + sl;
          rec_s[32 * g + b][g] = pw;
        }
        const uint32_t bit = 1u << b;
#pragma unroll
        for (int i = 0; i < kLane; ++i) {  // the pivot too: its word becomes 0
          if ((cand >> i) & 1u) {
            w[i] ^= pw;
            c[i] |= bit;
          }
        }
        cand = next ^ ((pw >> nb) & 1u ? cand : 0u);
      }
      live &= ~pivots;
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        // a pivot's last candidate bit is its own column: not a coefficient
        if ((pivots >> i) & 1u) c[i] &= ~(0x80000000u >> __clz(c[i]));
        words_s[g][i * 32 + lane] = w[i];
        coef_s[cb][i * 32 + lane] = c[i];
      }
      if (any_free && lane == 0) free_s = 1;
    } else if (g > 0 && (warp & 3)) {
      // group g - 1's pivots into the words above g (word g took them before)
      for (int s = helper; s < S; s += kHelpers) {
        const int p = spos<kLane>(s);
        const uint32_t cc = coef_s[cb ^ 1][p];
        if (!cc) continue;
        for (int h = g + 1; h < kw; ++h) {
          uint32_t acc = words_s[h][p], bits = cc;
          while (bits) {
            const int t = __ffs(bits) - 1;
            bits &= bits - 1;
            acc ^= rec_s[32 * (g - 1) + t][h];
          }
          words_s[h][p] = acc;
        }
      }
    }
    __syncthreads();
    // the group's pivots' later words at their election: P_t = B_t ^ XOR of
    // the P_u its coefficients name (u < t), a warp per word, lane t row t
    if (g + 1 + warp < kw) {
      const int h = g + 1 + warp;
      const int ps = pslot_s[32 * g + lane];
      uint32_t pv = ps >= 0 ? words_s[h][spos<kLane>(ps)] : 0u;
      const uint32_t ct = ps >= 0 ? coef_s[cb][spos<kLane>(ps)] : 0u;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const uint32_t v = __shfl_sync(kFull, pv, t);
        if ((ct >> t) & 1u) pv ^= v;
      }
      rec_s[32 * g + lane][h] = pv;
    }
    for (int s = tid; s < n; s += kSubsetThreads)
      cT[(size_t)g * rows + idx_s[s]] = coef_s[cb][spos<kLane>(s)];
    __syncthreads();
    // the group's pivots into word g + 1 of every row, before its steps
    if (g + 1 < kw) {
      for (int s = tid; s < S; s += kSubsetThreads) {
        const int p = spos<kLane>(s);
        uint32_t bits = coef_s[cb][p];
        if (!bits) continue;
        uint32_t acc = words_s[g + 1][p];
        while (bits) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1;
          acc ^= rec_s[32 * g + t][g + 1];
        }
        words_s[g + 1][p] = acc;
      }
    }
    __syncthreads();
  }

  // 4. prow, the record and the header (used' is the test kernel's)
  for (int j = tid; j < K; j += kSubsetThreads) {
    const int ps = pslot_s[j];
    const int r = ps >= 0 ? idx_s[ps] : -1;
    prow[j] = r;
    scratch[8 * K + j] = r;
#pragma unroll
    for (int g = 0; g < kSubsetKw; ++g) scratch[8 * j + g] = (int32_t)rec_s[j][g];
  }
  if (tid == 0) {
    const int sub_end = found >= S ? idx_s[S - 1] + 1 : rows;
    int32_t* hdr = scratch + 9 * K;
    hdr[0] = free_s && found >= S && sub_end < rows;
    hdr[1] = sub_end;
    hdr[2] = n;
  }
}

// The miss test, a thread a row: every block writes used' of its rows (used,
// and 1 at the subset's pivots, from the record's rows); only where the
// header is flagged does a block holding an unused row above sub_end load the
// record and reduce those rows column by column.
__global__ void __launch_bounds__(kTestThreads)
scan_subset_test_kernel(const uint32_t* __restrict__ bT, const int32_t* __restrict__ used,
                        int32_t* __restrict__ used_out, const int32_t* __restrict__ scratch,
                        int32_t* __restrict__ decided, int rows, int kw, int w0, int cols) {
  __shared__ uint32_t rec[kSubsetCols * kSubsetKw];
  __shared__ int taken[kSubsetCols];
  __shared__ int pivot[kTestThreads];  // a row of this block is one of the subset's pivots
  const int K = 32 * kw;
  const int32_t* hdr = scratch + 9 * K;
  const int row0 = blockIdx.x * kTestThreads;
  const int r = row0 + threadIdx.x;
  pivot[threadIdx.x] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += kTestThreads) {
    const int p = scratch[8 * K + j];
    if (p >= row0 && p < row0 + kTestThreads) pivot[p - row0] = 1;
  }
  __syncthreads();
  int u = 1;
  if (r < rows) {
    u = used[r];
    used_out[r] = u | pivot[threadIdx.x];
  }
  const bool mine = hdr[0] && r < rows && r >= hdr[1] && u == 0;
  if (!__syncthreads_or(mine)) return;
  for (int j = threadIdx.x; j < 8 * K; j += kTestThreads) rec[j] = (uint32_t)scratch[j];
  for (int j = threadIdx.x; j < K; j += kTestThreads) taken[j] = scratch[8 * K + j] >= 0;
  __syncthreads();
  if (!mine) return;
  uint32_t w[kSubsetKw];
#pragma unroll
  for (int g = 0; g < kSubsetKw; ++g) w[g] = g < kw ? bT[(size_t)g * rows + r] : 0u;
  const long long first = 1LL - 32LL * w0, last = (long long)cols - 32LL * w0;
  const int jlo = (int)max(0LL, min((long long)K, first));
  const int jhi = (int)max(0LL, min((long long)K, last + 1));
#pragma unroll
  for (int g = 0; g < kSubsetKw; ++g) {
    if (g >= kw) break;
    for (int b = 0; b < 32; ++b) {
      const int jj = 32 * g + b;
      if (jj < jlo || jj >= jhi || !((w[g] >> b) & 1u)) continue;
      if (!taken[jj]) {  // a free column of the subset that this row would pivot
        *decided = 0;
        return;
      }
#pragma unroll
      for (int h = g; h < kSubsetKw; ++h) w[h] ^= rec[8 * jj + h];
    }
  }
}

}  // namespace

// The subset-first scan: the subset kernel on kSubsetRows rows, the miss
// test, and the fallback gated on *decided: the cluster scan on nblocks
// blocks when chunk_rows is 0, else the chained scan on chunks of chunk_rows
// rows (nblocks, nblocks_last).  scratch: 9 K + 3 words; decided: one int32.  The
// fallback's geometry is checked before the first launch, so that a call the
// kernels cannot take launches nothing.
extern "C" int gf2_scan_subset(const uint32_t* bT, const int32_t* used, int32_t* prow,
                               int32_t* used_out, uint32_t* cT, int32_t* scratch,
                               int32_t* decided, int rows, int kw, int w0, int cols,
                               int chunk_rows, int nblocks, int nblocks_last,
                               cudaStream_t stream) {
  if (kw < 1 || kw > kSubsetKw || rows < 1) return (int)cudaErrorInvalidValue;
  gf2::ChunkCall chain{bT, used, prow, used_out, cT, scratch, 1, rows, kw, w0, cols,
                       chunk_rows, nblocks, nblocks_last, stream};
  chain.skip_if = decided;
  gf2::ScanGeometry geometry;
  if (chunk_rows > 0 ? !gf2::chain_fits(chain) : !gf2::scan_geometry(rows, kw, nblocks, &geometry))
    return (int)cudaErrorInvalidValue;
  scan_subset_kernel<kSubsetLane><<<1, kSubsetThreads, 0, stream>>>(bT, used, prow, cT, scratch,
                                                                     decided, rows, kw, w0, cols);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  scan_subset_test_kernel<<<(rows + kTestThreads - 1) / kTestThreads, kTestThreads, 0, stream>>>(
      bT, used, used_out, scratch, decided, rows, kw, w0, cols);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  if (chunk_rows == 0)
    return (int)gf2::scan_cluster_gated(bT, used, prow, used_out, cT, rows, kw, w0, cols, nblocks,
                                        decided, stream);
  for (int base = 0; base < rows; base += chunk_rows) {
    rc = gf2::launch_chain_link(chain, base);
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaSuccess;
}
