// GF(2) rank-K panel update through XOR tables (Method of the Four Russians).
//
// Replaces the TPU kernel gf2bv_tpu/ops/pallas_update.py:_panel_update_kernel
// (panel_update, the "pallas" phase-2 engine): a[i] ^= XOR{pf[t] : bit t of
// sel[i]} over every word; no panel start, so it is full-width in trailing
// mode too.  In place.
//
// The TPU body is K mask-and-XOR steps per output word.  On the H100 that
// form (panel_update.cu) is bound by INT32 issue, about 4 instructions per
// selector bit and word.  Here each group of 8 selector bits costs ONE
// shared-memory read and one XOR instead of 8 mask-and-XORs:
//   * a block owns a strip of 4 word columns (one uint4) and up to 4096 rows;
//   * for each of the K/8 groups it builds the 256-entry table of all XOR
//     combinations of the group's 8 pf rows on that strip, in shared memory,
//     by doubling: entries [2^b, 2^(b+1)) are entries [0, 2^b) XOR row b
//     (one XOR of an earlier entry and one row each, 8 barriers in all).
//     All K/8 tables live at once: 32 x 256 x 16 B = 128 KB at K = 256, of
//     the 227 KB a block may use;
//   * each thread then walks its rows: one 16-byte load of a, K/8 table
//     reads indexed by the row's selector bytes, one 16-byte store.
// The table build is 8192 entry XORs per block against 4096 x 32 reads, 6%.
// Bound: the kernel issues no tensor-core instruction, so the least time for
// its work is its bytes (the matrix read and written once), which is what
// chip_smoke.py prints.  What holds this design above that is shared-memory
// reads (random 16-byte entries, so some bank conflicts), not device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTabThreads = 512;
constexpr int kTabRows = 4096;   // rows per block
constexpr int kStrip = 4;        // words per table entry

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

__global__ void __launch_bounds__(kTabThreads)
table_update_kernel(uint32_t* a, const uint32_t* __restrict__ sel,
                    const uint32_t* __restrict__ pf, int rows, int wp, int kw, int aligned) {
  extern __shared__ uint4 smem4[];
  const int ngroups = 4 * kw;            // groups of 8 selector bits
  uint4* tab = smem4;                    // [ngroups][256]
  uint4* pf_s = smem4 + ngroups * 256;   // [32 * kw]: pf's rows on this strip
  const int tid = threadIdx.x;
  const int w = blockIdx.x * kStrip;
  const int n = min(kStrip, wp - w);
  const bool vec = aligned && n == kStrip;

  for (int t = tid; t < 32 * kw; t += kTabThreads)
    pf_s[t] = load4(pf + (size_t)t * wp + w, n, vec);
  for (int g = tid; g < ngroups; g += kTabThreads) tab[g * 256] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int b = 0; b < 8; ++b) {
    const int half = 1 << b;
    for (int i = tid; i < ngroups * half; i += kTabThreads) {
      const int g = i >> b, e = i & (half - 1);
      tab[g * 256 + half + e] = xor4(tab[g * 256 + e], pf_s[8 * g + b]);
    }
    __syncthreads();
  }

  const int row0 = blockIdx.y * kTabRows;
  const int row1 = min(rows, row0 + kTabRows);
  for (int r = row0 + tid; r < row1; r += kTabThreads) {
    uint32_t* ap = a + (size_t)r * wp + w;
    uint4 acc = load4(ap, n, vec);
    const uint32_t* sp = sel + (size_t)r * kw;
    for (int g = 0; g < kw; ++g) {
      const uint32_t s = sp[g];
      const uint4* t4 = tab + (4 * g) * 256;
      acc = xor4(acc, t4[s & 255u]);
      acc = xor4(acc, t4[256 + ((s >> 8) & 255u)]);
      acc = xor4(acc, t4[512 + ((s >> 16) & 255u)]);
      acc = xor4(acc, t4[768 + (s >> 24)]);
    }
    store4(ap, acc, n, vec);
  }
}

}  // namespace

// a ^= S . PF over every word, through 8-bit XOR tables.
extern "C" int gf2_update_table(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                int rows, int wp, int kw, cudaStream_t stream) {
  if (kw < 1 || kw > 8 || rows < 1 || wp < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(4 * kw * 256 + 32 * kw) * sizeof(uint4);
  cudaError_t rc = cudaFuncSetAttribute(
      table_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int aligned = wp % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(pf) % 16 == 0;
  const dim3 grid((wp + kStrip - 1) / kStrip, (rows + kTabRows - 1) / kTabRows);
  table_update_kernel<<<grid, kTabThreads, smem, stream>>>(a, sel, pf, rows, wp, kw, aligned);
  return (int)cudaGetLastError();
}
