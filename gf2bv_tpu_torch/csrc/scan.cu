// Forward pivot scans of one K-column panel (phase 1, first half).
//
// gf2_scan replaces gf2bv_tpu/ops/pallas_phase1.py: _make_scan_kernel
// (launched by _call_scan_kernel, variant "", from phase1_panel_split).  The
// contract every scan here keeps is in scan_system.cuh: in bT (kw, rows),
// used (rows,), w0, cols; out prow (K,), used' (rows,), cT (kw, rows); the
// pivot of a column is the lowest unused row with the bit set.
//
// What bounds a scan on the H100: latency.  K = 256 dependent steps per panel
// (about 20k per flagship solve), each an election of the lowest candidate
// row followed by an elimination sweep; the arithmetic and the 1.5 MB moved
// are negligible.  With the state in global memory and one block (the design
// gf2_scan_block keeps, below) a step costs each thread a serial walk over
// its ~20 rows through L2 latency, twice: 7.5 us per step on 20224 rows
// against 0.58 us on 768.
//
// What gf2_scan does about it: a thread-block cluster holds the whole state
// in shared memory.  The rows are cut into nb contiguous ranges, one per
// block of the cluster (nb = 1, 2, 4, 8 or 16, chosen by the wrapper from
// (rows, kw)); a block keeps its rows' kw slice words and the one coefficient
// word the current 32 columns touch in shared memory ((kw + 1) words a row,
// laid out [word][row] so a warp's accesses are conflict-free), and each
// thread owns the rows tid, tid + 1024, ... of the range (two or three at the
// flagship shape) with their used flags in a register mask.  A step:
//   1. each thread tests its rows (one shared-memory load each, no branch);
//      __reduce_min_sync gives the warp's lowest candidate, one __syncthreads
//      and a second reduction, made by every warp for itself, the block's;
//   2. the block's first warp reads that row's slice words from shared memory
//      and lane b writes (row, words) into slot [parity][rank] of block b
//      through distributed shared memory (cluster.map_shared_rank);
//   3. one cluster barrier (arrive.release / wait.acquire);
//   4. every warp reads the nb slots, takes the lowest row (the ranges ascend
//      with the rank, so it is the first block that has a candidate), has the
//      pivot's words from the slot without a dependent load, and each thread
//      sweeps its own rows in shared memory.
// The slots are double-buffered by the parity of the step, so one cluster
// barrier per step suffices: a block can only write a slot again two steps
// later, after every block has passed the barrier in between and so finished
// reading it.  Both skips of a step are cluster-uniform: an invalid column
// depends on the arguments alone, and "no pivot" is decided after the
// exchange, from the same slots in every block.  bT is read once at the
// start; a coefficient word is written once, after its 32 columns; used' is
// written once at the end.  There is no working copy in global memory.
// With nb = 1 (the 768 rows of the subset scan) there is no exchange: every
// thread reads the pivot's words straight from the block's shared memory and
// a step has one __syncthreads.
//
// gf2_scan_block is the earlier design under its own name: ONE block of 1024
// threads striding over the rows with the state in global memory (scan_system
// in scan_system.cuh).  It takes the systems whose rows exceed what the
// largest cluster holds in shared memory, and scan_system stays the body of
// the batched scan and of the fused update + scan's scan block.
//
// The batched scan (gf2_scan_batched) replaces
// gf2bv_tpu/ops/gauss_batched.py: _make_scan_kernel_b (launched by
// _scan_batched): the same scan over B independent systems, bT (B, kw, rows),
// used (B, rows) -> prow (B, K), used' (B, rows), cT (B, kw, rows).  The TPU
// kernel advances all B systems in each sequential step to share the cost of
// a step's cross-lane reductions.  Here the systems share nothing, so each
// gets its own block (gridDim.x = B) running the same loop on its slices, on
// its own SM: B steps progress in parallel, and the per-system working set
// (bT in + bT work + cT + used, about 2 MB at the flagship shape) stays in
// the 50 MB L2 for B up to ~24.  prow is written as (B, K) directly.
//
// gf2_scan2 replaces pallas_phase1.py: _make_scan_kernel2 (variant "2"): two
// pivots per sequential step.  The second column's candidates see the first
// pivot's elimination virtually (one bit of the first pivot row), the second
// pivot row is corrected by the first, and one sweep applies both
// eliminations.  A pair of columns costs two elections but one sweep, where
// the 1-pivot scan spends two of each.  The second pivot's row is never
// rewritten in the working slice (it is used from this step on and never read
// again), so the loads of its words race with no write.
//
// gf2_scan_minkey replaces pallas_phase1.py: _make_scan_kernel_minkey
// (variant "m"): election and extraction in one reduction round.  Each thread
// forms int32 keys (row << 16 | 16-bit half) of its first candidate for every
// live slice word; the 2*(kw - sw) minima, independent __reduce_min_sync
// reductions issued together, all land on the lowest candidate row and carry
// its words.  The pivot row's words then come out of the reduction instead of
// a dependent load after it.  The no-candidate sentinel rows << 16 needs
// rows < 2^15; the wrapper sends taller systems to gf2_scan, as the
// reference's _call_scan_kernel does.

#include <cooperative_groups.h>

#include "scan_system.cuh"

namespace cg = cooperative_groups;

namespace {

using gf2::kMaxKw;
using gf2::kScanThreads;

// One system, one block, state in global memory; the pointers stay kernel
// parameters.  (Offsetting them by blockIdx.x here as well cost 17% per
// step: 2.25 against 1.93 ms per flagship panel on the H100.)
__global__ void __launch_bounds__(kScanThreads)
scan_block_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                  int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                  int rows, int kw, int w0, int cols) {
  gf2::scan_system(bT_in, used_in, prow, used, cT, bT, rows, kw, w0, cols);
}

// -- the cluster scan ---------------------------------------------------------

constexpr int kClusterThreads = 512;  // threads per block: up to 128 registers each
constexpr int kMaxSlots = 8;          // rows a thread can own (kernels for 1, 2, 3, 5, 8)
constexpr int kMaxCluster = 16;       // blocks per cluster (above 8: non-portable size)
constexpr int kSlotQuads = 3;         // one slot: words 0-3, words 4-7, (row, -, -, -)
// Dynamic shared memory of a block, in 16-byte quads: the exchange slots
// [2][kMaxCluster][kSlotQuads], the warp minima [2][32] ints, the two
// mbarriers of the exchange (one quad), then the state [halves][rpb_pad]
// (half h of a row: its slice words 4h .. 4h+3).
constexpr int kScanHeaderQuads = 2 * kMaxCluster * kSlotQuads + 2 * 32 / 4 + 1;
constexpr size_t kMaxBlockSmem = 232448;  // 227 KB

__device__ __forceinline__ uint4 xor4(uint4 x, uint4 y) {
  return make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}

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

// kCluster: launched as a cluster of gridDim.x blocks; else one plain block.
// kSlots: rows a thread owns at most (its loops over them are unrolled, so a
// thread pays for kSlots rows whatever it has).  rpb: rows per block, at most
// kSlots * kClusterThreads; rpb_pad: rpb rounded up to a multiple of 32.
template <bool kCluster, int kSlots>
__global__ void __launch_bounds__(kClusterThreads, 1)
scan_cluster_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                    int32_t* __restrict__ prow, int32_t* __restrict__ used_out,
                    uint32_t* __restrict__ cT, int rows, int kw, int w0, int cols, int rpb,
                    int rpb_pad) {
  extern __shared__ uint4 smem4[];
  uint4* slots = smem4;                                        // [2][kMaxCluster][kSlotQuads]
  int* warp_min = reinterpret_cast<int*>(smem4 + 2 * kMaxCluster * kSlotQuads);  // [2][32]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem4 + kScanHeaderQuads - 1);  // [2]
  uint4* bT_s = smem4 + kScanHeaderQuads;                      // [halves][rpb_pad]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nthreads = kClusterThreads, nwarps = kClusterThreads / 32;
  const unsigned full = 0xffffffffu;
  const int halves = (kw + 3) >> 2;
  int rank = 0, nb = 1;
  if (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    nb = (int)cluster.num_blocks();
  }
  const int row0 = rank * rpb;
  const int nloc = max(0, min(rpb, rows - row0));       // rows of this block
  const bool writer = rank == 0 && tid == 0;

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
          w[q] = 4 * h + q < kw ? bT_in[(size_t)(4 * h + q) * rows + r] : 0u;
        bT_s[h * rpb_pad + loc] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
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
    cg::this_cluster().sync();
  }

  // the valid columns of the panel are the steps [jlo, jhi): arguments only
  const long long first = 1LL - 32LL * w0, last = (long long)cols - 32LL * w0;
  const int K = 32 * kw;
  const int jlo = (int)max(0LL, min((long long)K, first));
  const int jhi = (int)max(0LL, min((long long)K, last + 1));
  int p = 0;  // parity of the valid steps: which slots and warp minima are in use
  for (int jj = 0; jj < K; ++jj) {
    const int sw = jj >> 5, hs = sw >> 2, q = sw & 3;
    const uint32_t bit = 1u << (jj & 31);
    int piv = rows;
    if (jj >= jlo && jj < jhi) {  // cluster-uniform
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
      mine = __reduce_min_sync(full, mine);
      if (lane == 0) warp_min[p * 32 + warp] = mine;
      __syncthreads();
      int bmin = lane < nwarps ? warp_min[p * 32 + lane] : rows;
      bmin = __reduce_min_sync(full, bmin);  // every warp reduces for itself

      uint4 bp0 = make_uint4(0u, 0u, 0u, 0u), bp1 = bp0;  // the pivot row's halves
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
      p ^= 1;

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
    if (writer) prow[jj] = piv < rows ? piv : -1;
    if ((jj & 31) == 31) {  // word sw of the coefficients is final
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int loc = i * nthreads + tid;
        if (loc < nloc) cT[(size_t)sw * rows + row0 + loc] = c[i];
        c[i] = 0u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int loc = i * nthreads + tid;
    if (loc < nloc) used_out[row0 + loc] = (int32_t)(((live >> i) & 1u) ^ 1u);
  }
  // no block exits while another may still write into its shared memory
  if (kCluster) cg::this_cluster().sync();
}

// B systems; block b takes system b.
__global__ void __launch_bounds__(kScanThreads)
scan_batched_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                    int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                    int rows, int kw, int w0, int cols) {
  const size_t slice = (size_t)kw * rows;  // words of one system's bT / cT
  const size_t b = blockIdx.x;
  gf2::scan_system(bT_in + b * slice, used_in + b * rows, prow + b * 32 * kw,
                   used + b * rows, cT + b * slice, bT + b * slice, rows, kw, w0, cols);
}

__global__ void __launch_bounds__(kScanThreads)
scan2_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
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

__global__ void __launch_bounds__(kScanThreads)
scan_minkey_kernel(const uint32_t* __restrict__ bT_in, const int32_t* __restrict__ used_in,
                   int32_t* __restrict__ prow, int32_t* used, uint32_t* cT, uint32_t* bT,
                   int rows, int kw, int w0, int cols) {
  __shared__ int warp_keys[kScanThreads / 32][2 * kMaxKw];
  __shared__ int keys_s[2 * kMaxKw];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x / 32;
  const int none = rows << 16;  // sentinel above every candidate's key
  gf2::scan_init(bT_in, used_in, used, cT, bT, rows, kw);

  const int K = 32 * kw;
  for (int jj = 0; jj < K; ++jj) {
    const long long gbit = 32LL * w0 + jj;
    if (gbit < 1 || gbit > cols) {  // block-uniform: no pivot, no barrier
      if (tid == 0) prow[jj] = -1;
      continue;
    }
    const int sw = jj >> 5;
    const uint32_t bit = 1u << (jj & 31);
    const uint32_t* col = bT + (size_t)sw * rows;

    const int mine = gf2::first_candidate(col, used, bit, rows);
    // keys of this thread's candidate, one lo and one hi per live word
    const bool cand = mine < rows;
    int key[2 * kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g) {
      const uint32_t v = (cand && g >= sw && g < kw) ? bT[(size_t)g * rows + mine] : 0u;
      key[2 * g] = cand ? (mine << 16) | (int)(v & 0xFFFFu) : none;
      key[2 * g + 1] = cand ? (mine << 16) | (int)(v >> 16) : none;
    }
#pragma unroll
    for (int i = 0; i < 2 * kMaxKw; ++i) {
      if (i >= 2 * sw && i < 2 * kw) {  // warp-uniform
        const int m = __reduce_min_sync(0xffffffffu, key[i]);
        if (lane == 0) warp_keys[warp][i] = m;
      }
    }
    __syncthreads();
    // warp i reduces key i over the warps' minima
    if (warp >= 2 * sw && warp < 2 * kw) {
      int m = lane < nwarps ? warp_keys[lane][warp] : none;
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) keys_s[warp] = m;
    }
    __syncthreads();
    const int piv = keys_s[2 * sw] >> 16;  // rows when there is no candidate
    if (tid == 0) prow[jj] = piv < rows ? piv : -1;
    if (piv >= rows) continue;  // block-uniform

    uint32_t bp[kMaxKw];
#pragma unroll
    for (int g = 0; g < kMaxKw; ++g)
      bp[g] = (g >= sw && g < kw)
                  ? ((uint32_t)(keys_s[2 * g + 1] & 0xFFFF) << 16) |
                        (uint32_t)(keys_s[2 * g] & 0xFFFF)
                  : 0u;
    gf2::eliminate(col, used, cT, bT, bp, bit, sw, piv, rows, kw);
  }
}

}  // namespace

namespace {

template <int kSlots>
cudaError_t launch_scan_cluster(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                                int32_t* used_out, uint32_t* cT, int rows, int kw, int w0,
                                int cols, int nblocks, int rpb, int rpb_pad, size_t smem,
                                cudaStream_t stream) {
  cudaError_t rc;
  if (nblocks == 1) {
    auto kernel = scan_cluster_kernel<false, kSlots>;
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
    kernel<<<1, kClusterThreads, smem, stream>>>(bT_in, used_in, prow, used_out, cT, rows, kw,
                                                 w0, cols, rpb, rpb_pad);
    return cudaGetLastError();
  }
  auto kernel = scan_cluster_kernel<true, kSlots>;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  if (nblocks > 8) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the largest shared-memory size each cluster size was found placeable with
  static size_t placeable[kMaxCluster + 1] = {};
  if (smem > placeable[nblocks]) {
    int nclusters = 0;
    rc = cudaOccupancyMaxActiveClusters(&nclusters, kernel, &cfg);
    if (rc != cudaSuccess) return rc;
    if (nclusters < 1) return cudaErrorLaunchOutOfResources;
    placeable[nblocks] = smem;
  }
  rc = cudaLaunchKernelEx(&cfg, kernel, bT_in, used_in, prow, used_out, cT, rows, kw, w0, cols,
                          rpb, rpb_pad);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

}  // namespace

// The cluster scan on nblocks blocks (1, 2, 4, 8 or 16; the wrapper's route).
// Returns an error, and launches nothing, when the state does not fit the
// blocks (shared memory, kMaxSlots rows a thread) or the card cannot place
// the cluster.
extern "C" int gf2_scan(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                        int32_t* used_out, uint32_t* cT, int rows, int kw, int w0, int cols,
                        int nblocks, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || rows < 1 || nblocks < 1 || nblocks > kMaxCluster ||
      (nblocks & (nblocks - 1)))
    return (int)cudaErrorInvalidValue;
  const int rpb = (rows + nblocks - 1) / nblocks;
  const int rpb_pad = (rpb + 31) & ~31;
  const size_t smem =
      sizeof(uint4) * (kScanHeaderQuads + (size_t)((kw + 3) / 4) * rpb_pad);
  const int slots = (rpb + kClusterThreads - 1) / kClusterThreads;
  if (smem > kMaxBlockSmem || slots > kMaxSlots) return (int)cudaErrorInvalidValue;
#define GF2_SCAN_SLOTS(n)                                                                   \
  if (slots <= n)                                                                           \
    return (int)launch_scan_cluster<n>(bT_in, used_in, prow, used_out, cT, rows, kw, w0,    \
                                       cols, nblocks, rpb, rpb_pad, smem, stream);
  GF2_SCAN_SLOTS(1)
  GF2_SCAN_SLOTS(2)
  GF2_SCAN_SLOTS(3)
  GF2_SCAN_SLOTS(5)
  GF2_SCAN_SLOTS(kMaxSlots)
#undef GF2_SCAN_SLOTS
  return (int)cudaErrorInvalidValue;
}

// The one-block scan with its state in global memory; bT_work (kw, rows) is
// its working copy of the slice.
extern "C" int gf2_scan_block(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                              int32_t* used_out, uint32_t* cT, uint32_t* bT_work, int rows,
                              int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw) return (int)cudaErrorInvalidValue;
  scan_block_kernel<<<1, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT,
                                                    bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}

extern "C" int gf2_scan_batched(const uint32_t* bT_in, const int32_t* used_in,
                                int32_t* prow, int32_t* used_out, uint32_t* cT,
                                uint32_t* bT_work, int batch, int rows, int kw, int w0,
                                int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || batch < 1) return (int)cudaErrorInvalidValue;
  scan_batched_kernel<<<batch, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out,
                                                          cT, bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}

extern "C" int gf2_scan2(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                         int32_t* used_out, uint32_t* cT, uint32_t* bT_work, int rows,
                         int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw) return (int)cudaErrorInvalidValue;
  scan2_kernel<<<1, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT, bT_work,
                                               rows, kw, w0, cols);
  return (int)cudaGetLastError();
}

extern "C" int gf2_scan_minkey(const uint32_t* bT_in, const int32_t* used_in, int32_t* prow,
                               int32_t* used_out, uint32_t* cT, uint32_t* bT_work, int rows,
                               int kw, int w0, int cols, cudaStream_t stream) {
  if (kw < 1 || kw > kMaxKw || rows >= (1 << 15)) return (int)cudaErrorInvalidValue;
  scan_minkey_kernel<<<1, kScanThreads, 0, stream>>>(bT_in, used_in, prow, used_out, cT,
                                                     bT_work, rows, kw, w0, cols);
  return (int)cudaGetLastError();
}
