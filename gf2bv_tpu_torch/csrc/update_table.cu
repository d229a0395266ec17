// GF(2) rank-K panel update through XOR tables (Method of the Four Russians):
// a[i] ^= XOR{pf[t] : bit t of sel[i]} on the live words of every row, in
// place.
//
// One kernel body (table_update_kernel, launched by launch_table_update)
// replaces four TPU kernels of gf2bv_tpu/ops/pallas_update.py, each of which
// keeps its own C entry point, Python wrapper and launch count; the same body
// with no input matrix (kProduct: out = S . PF, launch_table_product) is the
// second launch of the pivot-row rebuilds of reconstruct.cu, over one system
// or a batch (gridDim.z):
//   * _panel_update_kernel (panel_update, the "pallas" engine): every word,
//     no panel start (gf2_update_table, below);
//   * _mxu_kernel, _mxu_kernel_seg and _mxu_kernel_trailing (the "mxu"
//     family: gf2_update_full, gf2_update_seg, gf2_update_trailing in
//     panel_update.cu), which differ in the words they update.  The body
//     takes the rule as (word_lo, const_word): the live words are
//     [word_lo, wp), plus word 0 alone when const_word is set.  Words outside
//     that set are neither read nor written.
//
// What bounds it on the H100: the TPU bodies are K mask-and-XOR steps per
// output word (or the same product on the matrix unit).  On the CUDA cores
// that form costs about 4 INT32 operations per selector bit and word and is
// bound by the INT32 pipes at 21-23x the bytes the update must move (rank_k_tile
// in panel_update.cu, which the pivot-row rebuild's small product keeps).
// Here each group of 8 selector bits costs ONE shared-memory read and one
// XOR instead of 8 mask-and-XORs:
//   * a block owns a strip of 4 live word columns (one uint4; the const word
//     is a strip of one word) and a chunk of rows;
//   * for each of the K/8 groups it builds the 256-entry table of all XOR
//     combinations of the group's 8 pf rows on that strip, in shared memory:
//     entry e is the XOR of the rows that the bits of e select.  Sixteen
//     threads build a table, each doubling its 16 entries in registers, with
//     one barrier before and one after.  All K/8 tables live at once: 32 x
//     256 x 16 B = 128 KB at K = 256, of the 227 KB a block may use;
//   * each thread then walks its rows, four at a time: for each one 16-byte
//     load of a and the row's selector words (two 16-byte loads at K = 256),
//     all started before the first table read; then K/8 table reads a row,
//     indexed by the selector bytes, and one 16-byte store.
// The rows are cut into as many chunks as make the grid fill the card's SMs
// in whole waves (one block per SM: the tables take most of its shared
// memory), weighing a chunk's table build against the rows it serves; a
// narrow matrix (the (rows, 8) slice of the look-ahead engine: two strips)
// gets many short chunks instead of a few blocks walking thousands of rows.
// Bound: the kernel runs nothing on the tensor cores, so the least time for
// its work is its bytes (the live words read and written once).  What holds
// the design above that is the shared-memory reads: rows x K/8 random 16-byte
// entries per strip, 2 GB per full update of the 768-word matrix, with
// conflicts between the 8 lanes of a quarter warp that hit the same banks.

#include "gf2_common.cuh"

namespace {

constexpr int kTabThreads = 512;
constexpr int kStrip = 4;        // words per table entry
constexpr int kRowsInFlight = 4; // rows a thread loads before it computes

__device__ __forceinline__ uint4 xor4(uint4 x, uint4 y) {
  return make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}

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

// Strip blockIdx.x of the live words, rows [blockIdx.y * chunk_rows, + chunk_rows).
// Strip 0 is word 0 alone when const_word is set; the others are 4 words from
// word_lo on (the last may be cut by wp).  aligned: a and pf rows and word_lo
// allow 16-byte accesses; sel_vec: kw == 8 and sel rows are 16-byte aligned.
// kProbe is 0 in every entry point of the solver; the timing probe
// (gf2_update_table_probe) sets one of the kProbe* bits to take one cost out
// of the kernel, and its results are then wrong by design.
constexpr int kProbeSelResident = 1;  // selector rows from the first 512 rows only
constexpr int kProbeDenseA = 2;       // a strip's rows packed densely (16-byte stride)
constexpr int kProbeNoBuild = 4;      // no table build

// kProduct: a is written, never read (out = S . PF), and problem blockIdx.z
// of a batch lies at z * mat_stride (a), z * sel_stride and z * pf_stride words.
template <int kProbe, bool kProduct>
__global__ void __launch_bounds__(kTabThreads)
table_update_kernel(uint32_t* a, const uint32_t* __restrict__ sel,
                    const uint32_t* __restrict__ pf, int rows, int wp, int kw, int word_lo,
                    int const_word, int chunk_rows, int aligned, int sel_vec,
                    size_t mat_stride, size_t sel_stride, size_t pf_stride) {
  extern __shared__ uint4 smem4[];
  if (kProduct) {
    a += blockIdx.z * mat_stride;
    sel += blockIdx.z * sel_stride;
    pf += blockIdx.z * pf_stride;
  }
  const int ngroups = 4 * kw;            // groups of 8 selector bits
  uint4* tab = smem4;                    // [ngroups][256]
  uint4* pf_s = smem4 + ngroups * 256;   // [32 * kw]: pf's rows on this strip
  const int tid = threadIdx.x;
  const bool is_const = const_word && blockIdx.x == 0;
  const int w = is_const ? 0 : word_lo + kStrip * ((int)blockIdx.x - const_word);
  const int n = is_const ? 1 : min(kStrip, wp - w);
  const bool vec = aligned && n == kStrip;

  if (!(kProbe & kProbeNoBuild)) {
    for (int t = tid; t < 32 * kw; t += kTabThreads)
      pf_s[t] = load4(pf + (size_t)t * wp + w, n, vec);
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
  }

  // kRowsInFlight rows a thread at a time: their loads of a and of the selector
  // words are all started before the first table read, so the memory latency of
  // a row is paid once per batch (a block has only 16 warps to hide it with).
  const int row0 = blockIdx.y * chunk_rows;
  const int row1 = min(rows, row0 + chunk_rows);
  for (int r = row0 + tid; r < row1; r += kRowsInFlight * kTabThreads) {
    uint4 acc[kRowsInFlight];
    uint32_t s[kRowsInFlight][8];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const int rr = r + j * kTabThreads;
      if (rr >= row1) break;
      const uint32_t* ap = (kProbe & kProbeDenseA)
                               ? a + ((size_t)blockIdx.x * rows + rr) * kStrip
                               : a + (size_t)rr * wp + w;
      acc[j] = kProduct ? make_uint4(0u, 0u, 0u, 0u) : load4(ap, n, vec);
      const uint32_t* sp = sel + (size_t)((kProbe & kProbeSelResident) ? (rr & 511) : rr) * kw;
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
      uint32_t* ap = (kProbe & kProbeDenseA)
                         ? a + ((size_t)blockIdx.x * rows + rr) * kStrip
                         : a + (size_t)rr * wp + w;
      store4(ap, acc[j], n, vec);
    }
  }
}

// Row chunks per strip.  A block's cost, in table reads per thread, is about
// 2 rows' worth for the table build plus its rows per thread; the grid runs
// in waves of one block per SM.  Among the chunk counts from the fewest
// (4096 rows a chunk, or what fills the SMs once) up to 8 more, take the one
// with the least waves x cost.  nstrips counts the strips of every problem of
// a batch.
int pick_chunks(int rows, int nstrips, int nsm) {
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

template <int kProbe, bool kProduct = false>
cudaError_t launch_table(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                         int wp, int kw, int word_lo, int const_word, cudaStream_t stream,
                         int batch = 1, size_t mat_stride = 0, size_t sel_stride = 0,
                         size_t pf_stride = 0) {
  if (kw < 1 || kw > 8 || rows < 1 || wp < 1 || word_lo < 0 || word_lo > wp || batch < 1)
    return cudaErrorInvalidValue;
  const_word = const_word ? 1 : 0;
  if (word_lo == 0) const_word = 0;  // word 0 is in the live range already
  const int nstrips = (wp - word_lo + kStrip - 1) / kStrip + const_word;
  if (nstrips == 0) return cudaSuccess;
  static int nsm = 0;
  if (nsm == 0) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
  }
  const size_t smem = (size_t)(4 * kw * 256 + 32 * kw) * sizeof(uint4);
  cudaError_t rc = cudaFuncSetAttribute(
      table_update_kernel<kProbe, kProduct>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return rc;
  // every problem of a batch is as aligned as the first: the strides are whole rows
  const int aligned = wp % 4 == 0 && word_lo % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(pf) % 16 == 0;
  const int sel_vec = kw == 8 && reinterpret_cast<uintptr_t>(sel) % 16 == 0;
  const int chunks = pick_chunks(rows, nstrips * batch, nsm);
  int chunk_rows = (rows + chunks - 1) / chunks;
  chunk_rows = (chunk_rows + 31) & ~31;
  const dim3 grid(nstrips, (rows + chunk_rows - 1) / chunk_rows, batch);
  table_update_kernel<kProbe, kProduct><<<grid, kTabThreads, smem, stream>>>(
      a, sel, pf, rows, wp, kw, word_lo, const_word, chunk_rows, aligned, sel_vec,
      mat_stride, sel_stride, pf_stride);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_table_update(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                                int wp, int kw, int word_lo, int const_word,
                                cudaStream_t stream) {
  return launch_table<0>(a, sel, pf, rows, wp, kw, word_lo, const_word, stream);
}

cudaError_t launch_table_product(uint32_t* out, const uint32_t* sel, const uint32_t* pf,
                                 int rows, int wp, int kw, int batch, size_t mat_stride,
                                 size_t sel_stride, size_t pf_stride, cudaStream_t stream) {
  return launch_table<0, true>(out, sel, pf, rows, wp, kw, 0, 0, stream, batch, mat_stride,
                               sel_stride, pf_stride);
}

// a ^= S . PF over every word (replaces pallas_update._panel_update_kernel).
extern "C" int gf2_update_table(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                int rows, int wp, int kw, cudaStream_t stream) {
  return (int)launch_table_update(a, sel, pf, rows, wp, kw, 0, 0, stream);
}

// The full-width table update with one of its costs taken out, to time what
// that cost is (probe 1: selector rows from a resident 16 KB; 2: a strip's
// rows of a packed densely; 4: no table build; 0: the kernel as it is).  For
// probe != 0 the result is wrong by design and a is scratch.
extern "C" int gf2_update_table_probe(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                      int rows, int wp, int kw, int probe,
                                      cudaStream_t stream) {
  if (rows < 512) return (int)cudaErrorInvalidValue;  // probe 1 reads rows 0..511
  switch (probe) {
    case 0: return (int)launch_table<0>(a, sel, pf, rows, wp, kw, 0, 0, stream);
    case kProbeSelResident:
      return (int)launch_table<kProbeSelResident>(a, sel, pf, rows, wp, kw, 0, 0, stream);
    case kProbeDenseA:
      if (wp % kStrip) return (int)cudaErrorInvalidValue;
      return (int)launch_table<kProbeDenseA>(a, sel, pf, rows, wp, kw, 0, 0, stream);
    case kProbeNoBuild:
      return (int)launch_table<kProbeNoBuild>(a, sel, pf, rows, wp, kw, 0, 0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
