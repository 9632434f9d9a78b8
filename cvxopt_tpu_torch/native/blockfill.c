/* Symbolic block-Cholesky fill over a quotient (tile) graph.
 *
 * Native host-side runtime component for ops/blocksparse.analyze:
 * given the block adjacency of a tiled SPD pattern, compute the block
 * fill pattern of the Cholesky factor by clique elimination — the
 * analysis CHOLMOD performs natively (reference cholmod.c:273), here
 * over tiles.  Bitset rows make each clique union O(nt/64) words.
 *
 * API (ctypes):
 *   long block_fill(long nt,
 *                   const long *indptr, const long *indices,
 *                   long *colptr, long *cols, long cap);
 * indptr/indices: CSR adjacency of the SYMMETRIZED block pattern
 * (diagonal optional).  On success returns the total number of blocks
 * in L (diagonal first per column) and fills colptr (nt+1) and
 * cols (that many entries); returns -1 if cap would be exceeded,
 * -2 on allocation failure.
 */

#include <stdlib.h>
#include <string.h>

long block_fill(long nt, const long *indptr, const long *indices,
                long *colptr, long *cols, long cap)
{
    long words = (nt + 63) / 64;
    unsigned long long *adj = calloc((size_t)nt * words,
                                     sizeof(unsigned long long));
    if (!adj) return -2;

    for (long k = 0; k < nt; ++k) {
        unsigned long long *row = adj + (size_t)k * words;
        row[k / 64] |= 1ULL << (k % 64);          /* diagonal */
        for (long p = indptr[k]; p < indptr[k + 1]; ++p) {
            long j = indices[p];
            row[j / 64] |= 1ULL << (j % 64);
        }
    }

    long total = 0;
    for (long k = 0; k < nt; ++k) {
        unsigned long long *row = adj + (size_t)k * words;
        colptr[k] = total;
        if (total < cap) cols[total] = k;
        ++total;
        /* neighbors strictly above k, in ascending order */
        long first = -1;
        for (long w = k / 64; w < words; ++w) {
            unsigned long long bits = row[w];
            if (w == k / 64)
                bits &= ~((k % 64 == 63) ? ~0ULL
                          : ((1ULL << ((k % 64) + 1)) - 1ULL));
            while (bits) {
                long b = __builtin_ctzll(bits);
                long i = w * 64 + b;
                bits &= bits - 1;
                if (first < 0) first = i;
                if (total < cap) cols[total] = i;
                ++total;
                if (i != first) {
                    /* clique: the FIRST above-diagonal neighbor
                     * absorbs the rest of k's row (standard
                     * elimination-tree fill propagation) */
                }
            }
        }
        if (total > cap) { free(adj); return -1; }
        /* propagate: union k's above-k row into its first neighbor
         * (fill pattern equals transitive closure through parents) */
        if (first >= 0) {
            unsigned long long *dst = adj + (size_t)first * words;
            for (long w = 0; w < words; ++w) {
                unsigned long long bits = row[w];
                /* mask to entries > k */
                if (w < k / 64) bits = 0;
                else if (w == k / 64)
                    bits &= ~((k % 64 == 63) ? ~0ULL
                              : ((1ULL << ((k % 64) + 1)) - 1ULL));
                dst[w] |= bits;
            }
            /* remove 'first' itself from dst's copy of the clique?
             * harmless: diagonal bit of 'first' is already set */
        }
    }
    colptr[nt] = total;
    free(adj);
    return total;
}
