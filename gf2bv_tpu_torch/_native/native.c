/* Native host GF(2) elimination engine.
 *
 * The CPU-side counterpart of the TPU solvers: bit-packed (uint64 words)
 * Gauss-Jordan to reduced row echelon form using NSUB*8-column macro-panels
 * with NSUB 256-entry XOR tables applied in ONE fused pass per macro-panel
 * ("Method of Four Russians" style, the same algorithmic family as the
 * reference's libm4ri backend) and OpenMP row parallelism for the bulk
 * update.
 *
 * This is a from-scratch implementation of the same two-phase panel scheme
 * as gf2bv_tpu/ops/gauss_blocked.py:
 *   phase 1 (thin): forward-eliminate on the NSUB*8-bit column strip,
 *     tracking per-row coefficient words; reconstruct the <=NSUB*8 final
 *     pivot rows at full width (forward combos, then back-elimination).
 *   phase 2 (bulk): selector word per row from the *original* strip
 *     (diagonal-flipped for pivot rows), NSUB table lookups fused into one
 *     W-word XOR pass per row per macro-panel.
 *
 * Why macro-panels: the bulk update is memory-bandwidth-bound (every row
 * streams through cache once per panel), so applying NSUB sub-panel tables
 * per pass divides the number of full-matrix sweeps by NSUB while the
 * tables themselves (NSUB * 256 * W words) stay cache-resident.  Measured
 * at the MT19937 flagship shape (20224 x 19969) on one Xeon core: see
 * scripts/bench_native.py; NSUB is a compile-time knob (-DNSUB=n).
 *
 * Matrix layout matches the Python side: row-major uint64 words, packed
 * bit j (0 = affine constant / RHS, 1..cols = variables) at word j>>6,
 * bit j&63.  The caller passes w_alloc >= nwords(1+cols) + 1 with the pad
 * word(s) zeroed so cross-word strip extraction never reads out of bounds.
 *
 * Exposed via ctypes (no CPython API): see _native/__init__.py.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#define PANEL 8
#ifndef NSUB
/* 64-column macro-panels: best on real (structured/sparse) systems — the
 * MT19937 flagship measures 0.248 s raw at NSUB=8 vs 0.356 s at NSUB=4
 * (zero selectors skip whole rows, favoring fewer wider passes); dense
 * random is within 5% of the NSUB=4 optimum.  scripts/bench_native.py. */
#define NSUB 8
#endif
#define KCOLS (NSUB * PANEL)
/* strip/coef/sel/pivmask are single uint64 words: at most 64 panel bits */
_Static_assert(NSUB >= 1 && NSUB <= 8, "NSUB must be in 1..8");

static inline uint64_t stripk(const uint64_t *row, int64_t c0, int k) {
    /* bits c0..c0+k-1 (k <= 64) of a packed row; the pad word guarantees
     * the row[wi+1] read stays in bounds. */
    int64_t wi = c0 >> 6;
    int sh = (int)(c0 & 63);
    uint64_t v = row[wi] >> sh;
    if (sh) v |= row[wi + 1] << (64 - sh);
    if (k < 64) v &= (((uint64_t)1 << k) - 1);
    return v;
}

/* Full RREF in place.  Returns the rank.
 *   a      : rows x w_alloc uint64 (>= 1 zeroed pad word at each row end)
 *   pof    : cols int32, set to pivot row index per variable column or -1
 *   used   : rows uint8 scratch, zero-initialized by this function
 *   trailing: nonzero = mode-0 fast path: the bulk update touches only
 *     word 0 (the affine/RHS column) and words >= the macro-panel start —
 *     columns left of the panel are earlier pivot columns (identity) or
 *     free columns, which a free-vars-0 particular solution never reads.
 *     The result is then NOT a full RREF in the free columns and
 *     gf2_inconsistent is unreliable; the caller must verify the extracted
 *     solution against the original system (the same contract as the TPU
 *     trailing mode, ops/gauss_blocked.py).
 */
int64_t gf2_rref(uint64_t *a, int64_t rows, int64_t w_alloc, int64_t cols,
                 int32_t *pof, uint8_t *used, int trailing) {
    int64_t rank = 0;
    memset(used, 0, (size_t)rows);
    for (int64_t c = 0; c < cols; c++) pof[c] = -1;

    uint64_t *strip = (uint64_t *)malloc((size_t)rows * 8);
    uint64_t *coef = (uint64_t *)malloc((size_t)rows * 8);
    uint64_t *sel = (uint64_t *)malloc((size_t)rows * 8);
    uint64_t *pf = (uint64_t *)malloc(KCOLS * (size_t)w_alloc * 8);
    uint64_t *tbl = (uint64_t *)malloc(NSUB * 256 * (size_t)w_alloc * 8);
    int64_t first_free = 0; /* all rows below this are used (pivots) */

    for (int64_t c0 = 1; c0 <= cols; c0 += KCOLS) {
        int np = (int)((cols + 1 - c0) < KCOLS ? (cols + 1 - c0) : KCOLS);

        /* strip + coefficient words; used (pivot) rows get strip 0 so the
         * branchless per-pivot passes below never select or touch them */
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < rows; i++) {
            strip[i] = used[i] ? 0 : stripk(&a[i * w_alloc], c0, np);
            coef[i] = 0;
        }
        memset(pf, 0, KCOLS * (size_t)w_alloc * 8);

        int32_t prow[KCOLS];
        uint64_t borig_piv[KCOLS];
        uint64_t pivmask = 0;
        /* phase 1: forward elimination on the strip */
        for (int jj = 0; jj < np; jj++) {
            prow[jj] = -1;
            int64_t piv = -1;
            while (first_free < rows && used[first_free]) first_free++;
            for (int64_t i = first_free; i < rows; i++) {
                if ((strip[i] >> jj) & 1) { piv = i; break; }
            }
            if (piv < 0) continue;
            prow[jj] = (int32_t)piv;
            pivmask |= (uint64_t)1 << jj;
            pof[c0 - 1 + jj] = (int32_t)piv;
            used[piv] = 1;
            rank++;
            /* final-so-far pivot row = original row ^ combo(PF_fwd, coef) */
            uint64_t *dst = &pf[(size_t)jj * w_alloc];
            memcpy(dst, &a[(size_t)piv * w_alloc], (size_t)w_alloc * 8);
            uint64_t cb = coef[piv];
            for (int j2 = 0; j2 < jj; j2++) {
                if ((cb >> j2) & 1) {
                    const uint64_t *src = &pf[(size_t)j2 * w_alloc];
                    for (int64_t w = 0; w < w_alloc; w++) dst[w] ^= src[w];
                }
            }
            borig_piv[jj] = stripk(&a[(size_t)piv * w_alloc], c0, np);
            /* eliminate remaining candidates within the strip — branchless
             * mask form so the compiler vectorizes it (this per-pivot pass
             * is ~panels*K*rows word ops, the phase-1 hot loop); the pivot
             * row is retired by zeroing its strip word first */
            uint64_t bpiv = strip[piv];
            uint64_t cbit = (uint64_t)1 << jj;
            strip[piv] = 0;
            /* simd, not parallel-for: the per-pivot region is ~10k word
             * ops — thread fork/join overhead (64 regions per panel)
             * exceeds the work; SIMD lanes are the right parallelism */
#pragma omp simd
            for (int64_t i = first_free; i < rows; i++) {
                uint64_t m = (uint64_t)0 - ((strip[i] >> jj) & 1);
                strip[i] ^= bpiv & m;
                coef[i] ^= cbit & m;
            }
        }

        /* phase 1b: back-eliminate the pivot rows among themselves */
        for (int jj = np - 1; jj >= 0; jj--) {
            if (prow[jj] < 0) continue;
            const uint64_t *src = &pf[(size_t)jj * w_alloc];
            for (int j2 = 0; j2 < np; j2++) {
                if (j2 == jj || prow[j2] < 0) continue;
                uint64_t *dst = &pf[(size_t)j2 * w_alloc];
                if ((dst[(c0 + jj) >> 6] >> ((c0 + jj) & 63)) & 1) {
                    for (int64_t w = 0; w < w_alloc; w++) dst[w] ^= src[w];
                }
            }
        }

        if (!pivmask) continue;

        /* selector words from the ORIGINAL strip, diagonal-flipped */
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < rows; i++) {
            sel[i] = stripk(&a[(size_t)i * w_alloc], c0, np) & pivmask;
        }
        for (int jj = 0; jj < np; jj++) {
            if (prow[jj] >= 0) {
                sel[prow[jj]] =
                    (borig_piv[jj] & pivmask) ^ ((uint64_t)1 << jj);
            }
        }

        /* live word range: [wlo, w_alloc) plus word 0 when trailing */
        int64_t wlo = trailing ? (c0 >> 6) : 0;
        int64_t w1 = wlo ? wlo : 1;

        /* one 256-entry XOR table of PF-row combinations per sub-panel
         * (live words only); sub-panels with no pivots stay untouched —
         * their selector bytes are 0 under pivmask */
        for (int t = 0; t < NSUB; t++) {
            if (!((pivmask >> (PANEL * t)) & 0xff)) continue;
            uint64_t *tb = &tbl[(size_t)t * 256 * w_alloc];
            memset(tb, 0, (size_t)w_alloc * 8);
            for (int m = 1; m < 256; m++) {
                int bit = __builtin_ctz(m);
                const uint64_t *base = &tb[(size_t)(m & (m - 1)) * w_alloc];
                const uint64_t *add = &pf[(size_t)(PANEL * t + bit) * w_alloc];
                uint64_t *dst = &tb[(size_t)m * w_alloc];
                dst[0] = base[0] ^ add[0];
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] = base[w] ^ add[w];
            }
        }

        /* phase 2: NSUB table lookups fused into ONE pass per row */
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < rows; i++) {
            uint64_t s = sel[i];
            if (!s) continue;
            /* fixed 8 slots: the ns<=NSUB<=8 invariant bounds use, and
             * the static switch bodies below index up to srcs[7] */
            const uint64_t *srcs[8];
            int ns = 0;
            for (int t = 0; t < NSUB; t++) {
                uint8_t b = (uint8_t)(s >> (PANEL * t));
                if (b)
                    srcs[ns++] = &tbl[((size_t)t * 256 + b) * w_alloc];
            }
            uint64_t *dst = &a[(size_t)i * w_alloc];
            for (int q = 0; q < ns; q++) dst[0] ^= srcs[q][0];
            /* fixed-count bodies vectorize; the generic inner loop over a
             * runtime ns costs ~70 ns/row extra at narrow widths */
            switch (ns) {
            case 1:
                for (int64_t w = w1; w < w_alloc; w++) dst[w] ^= srcs[0][w];
                break;
            case 2:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w];
                break;
            case 3:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w] ^ srcs[2][w];
                break;
            case 4:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w] ^ srcs[2][w] ^
                              srcs[3][w];
                break;
            case 5:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w] ^ srcs[2][w] ^
                              srcs[3][w] ^ srcs[4][w];
                break;
            case 6:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w] ^ srcs[2][w] ^
                              srcs[3][w] ^ srcs[4][w] ^ srcs[5][w];
                break;
            case 7:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w] ^ srcs[2][w] ^
                              srcs[3][w] ^ srcs[4][w] ^ srcs[5][w] ^
                              srcs[6][w];
                break;
            case 8:
                for (int64_t w = w1; w < w_alloc; w++)
                    dst[w] ^= srcs[0][w] ^ srcs[1][w] ^ srcs[2][w] ^
                              srcs[3][w] ^ srcs[4][w] ^ srcs[5][w] ^
                              srcs[6][w] ^ srcs[7][w];
                break;
            default:
                for (int64_t w = w1; w < w_alloc; w++) {
                    uint64_t acc = dst[w];
                    for (int q = 0; q < ns; q++) acc ^= srcs[q][w];
                    dst[w] = acc;
                }
            }
        }
    }

    free(strip);
    free(coef);
    free(sel);
    free(pf);
    free(tbl);
    return rank;
}

/* Any row reduced to 0*x = 1?  (variable bits empty, constant bit set) */
int gf2_inconsistent(const uint64_t *a, int64_t rows, int64_t w_alloc,
                     int64_t cols) {
    int64_t nw = (1 + cols + 63) >> 6;
    int bad = 0;
#pragma omp parallel for schedule(static) reduction(|| : bad)
    for (int64_t i = 0; i < rows; i++) {
        const uint64_t *row = &a[(size_t)i * w_alloc];
        if (!(row[0] & 1)) continue;
        uint64_t any = row[0] >> 1;
        for (int64_t w = 1; w < nw; w++) any |= row[w];
        if (!any) bad = 1;
    }
    return bad;
}

/* Does x (packed over nw words, bit 0 = the constant 1) satisfy every row?
 * Row parity of (row & x) must be 0 for all rows; returns 1 on success.
 * ``aff`` (nullable, rows bytes) REPLACES each row's own bit 0 — the
 * lazy-route affine-column swap (x bit 0 must be set); the correction is
 * parity ^ own_bit0 ^ aff.  The C twin of the mode-0 verification
 * (solve_native): hardware parity beats the numpy lookup-table
 * popcount by ~6x at flagship width. */
int gf2_verify(const uint64_t *a, int64_t rows, int64_t w_alloc, int64_t nw,
               const uint64_t *x, const uint8_t *aff) {
    int bad = 0;
#pragma omp parallel for schedule(static) reduction(|| : bad)
    for (int64_t i = 0; i < rows; i++) {
        const uint64_t *row = &a[(size_t)i * w_alloc];
        uint64_t p = 0;
        for (int64_t w = 0; w < nw; w++)
            p ^= row[w] & x[w];
        p = __builtin_parityll(p);
        if (aff) p ^= (row[0] ^ (uint64_t)aff[i]) & 1;
        if (p) bad = 1;
    }
    return !bad;
}


/* Batched affine-space enumeration: fill out[k] = origin ^ combo(basis,
 * bits(order(start+k))) for k < count, gray order optional. */
void gf2_enumerate(const uint64_t *origin, const uint64_t *basis,
                   int64_t dim, int64_t w, uint64_t start, int64_t count,
                   int use_gray, uint64_t *out) {
#pragma omp parallel for schedule(static)
    for (int64_t k = 0; k < count; k++) {
        uint64_t idx = start + (uint64_t)k;
        if (use_gray) idx ^= idx >> 1;
        uint64_t *dst = &out[(size_t)k * w];
        memcpy(dst, origin, (size_t)w * 8);
        uint64_t m = idx;
        while (m) {
            int b = __builtin_ctzll(m);
            m &= m - 1;
            if (b < dim) {
                const uint64_t *src = &basis[(size_t)b * w];
                for (int64_t ww = 0; ww < w; ww++) dst[ww] ^= src[ww];
            } else break;
        }
    }
}
