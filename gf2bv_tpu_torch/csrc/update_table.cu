// GF(2) rank-K panel update through XOR tables (Method of the Four Russians):
// a[i] ^= XOR{pf[t] : bit t of sel[i]} on the live words of every row, in
// place.
//
// One kernel body (table_update_body in update_table.cuh, launched here as
// table_update_kernel by launch_table_update)
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
// bound by the INT32 pipes at 21-23x the bytes the update must move.
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

#include "update_table.cuh"

using namespace gf2;

namespace {

// Block (x, y) of problem z: strip x, row chunk y.  kProduct: problem z of a
// batch lies at z * mat_stride (a), z * sel_stride and z * pf_stride words.
template <bool kProduct>
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
  table_update_body<kProduct>(a, sel, pf, rows, wp, kw, word_lo, const_word, chunk_rows,
                              aligned, sel_vec, (int)blockIdx.x, (int)blockIdx.y, smem4);
}

template <bool kProduct>
cudaError_t launch_table(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                         int wp, int kw, int word_lo, int const_word, cudaStream_t stream,
                         int batch = 1, size_t mat_stride = 0, size_t sel_stride = 0,
                         size_t pf_stride = 0) {
  static bool smem_allowed = false;  // once per instantiation: tables up to K = 256
  if (!smem_allowed) {
    cudaError_t rc = cudaFuncSetAttribute(table_update_kernel<kProduct>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)table_smem_bytes(8));
    if (rc != cudaSuccess) return rc;
    smem_allowed = true;
  }
  int nsm = 0;
  cudaError_t rc = sm_count(&nsm);
  if (rc != cudaSuccess) return rc;
  TableGrid g;
  if (!table_grid(a, sel, pf, rows, wp, kw, word_lo, const_word, batch, nsm, &g))
    return cudaErrorInvalidValue;
  if (g.nstrips == 0) return cudaSuccess;
  table_update_kernel<kProduct>
      <<<dim3(g.nstrips, g.nchunks, batch), kTabThreads, table_smem_bytes(kw), stream>>>(
          a, sel, pf, rows, wp, kw, word_lo, g.const_word, g.chunk_rows, g.aligned, g.sel_vec,
          mat_stride, sel_stride, pf_stride);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_table_update(uint32_t* a, const uint32_t* sel, const uint32_t* pf, int rows,
                                int wp, int kw, int word_lo, int const_word,
                                cudaStream_t stream) {
  return launch_table<false>(a, sel, pf, rows, wp, kw, word_lo, const_word, stream);
}

cudaError_t launch_table_product(uint32_t* out, const uint32_t* sel, const uint32_t* pf,
                                 int rows, int wp, int kw, int batch, size_t mat_stride,
                                 size_t sel_stride, size_t pf_stride, cudaStream_t stream) {
  return launch_table<true>(out, sel, pf, rows, wp, kw, 0, 0, stream, batch, mat_stride,
                            sel_stride, pf_stride);
}

// a ^= S . PF over every word (replaces pallas_update._panel_update_kernel).
extern "C" int gf2_update_table(uint32_t* a, const uint32_t* sel, const uint32_t* pf,
                                int rows, int wp, int kw, cudaStream_t stream) {
  return (int)launch_table_update(a, sel, pf, rows, wp, kw, 0, 0, stream);
}
