/* Native minimum-degree fill-reducing ordering.
 *
 * Host-side native runtime piece mirroring the reference's use of C
 * for orderings (reference: src/C/amd.c wrapping SuiteSparse AMD).
 * Greedy minimum-degree on the symmetrized sparsity pattern with
 * clique merging on elimination — the same semantics as the Python
 * fallback in cvxopt_tpu_torch/ops/spsolve.py:amd_order, implemented with
 * dynamic adjacency arrays and a timestamp marker for O(1) dedup.
 *
 * Interface (ctypes):
 *   int mindeg_order(int n, const int *indptr, const int *indices,
 *                    int *perm_out);
 * indptr/indices describe the symmetric pattern in CSR form
 * (diagonal entries ignored); perm_out receives the elimination
 * order.  Returns 0 on success, -1 on allocation failure.
 */

#include <stdlib.h>
#include <string.h>

typedef struct {
    int *items;
    int len;
    int cap;
} vec;

static int vec_push(vec *v, int x)
{
    if (v->len == v->cap) {
        int ncap = v->cap ? 2 * v->cap : 8;
        int *ni = (int *)realloc(v->items, (size_t)ncap * sizeof(int));
        if (!ni)
            return -1;
        v->items = ni;
        v->cap = ncap;
    }
    v->items[v->len++] = x;
    return 0;
}

int mindeg_order(int n, const int *indptr, const int *indices,
                 int *perm_out)
{
    vec *adj = (vec *)calloc((size_t)n, sizeof(vec));
    int *alive = (int *)malloc((size_t)n * sizeof(int));
    int *deg = (int *)malloc((size_t)n * sizeof(int));
    int *mark = (int *)calloc((size_t)n, sizeof(int));
    int stamp = 0, i, j, k, rc = -1;

    if (!adj || !alive || !deg || !mark)
        goto done;

    for (i = 0; i < n; i++) {
        alive[i] = 1;
        for (j = indptr[i]; j < indptr[i + 1]; j++) {
            k = indices[j];
            if (k != i) {
                if (vec_push(&adj[i], k))
                    goto done;
            }
        }
    }
    /* dedup initial adjacency with the marker */
    for (i = 0; i < n; i++) {
        int w = 0;
        stamp++;
        for (j = 0; j < adj[i].len; j++) {
            k = adj[i].items[j];
            if (mark[k] != stamp) {
                mark[k] = stamp;
                adj[i].items[w++] = k;
            }
        }
        adj[i].len = w;
        deg[i] = w;
    }

    for (int step = 0; step < n; step++) {
        /* pick the min-degree alive node */
        int v = -1, best = n + 1;
        for (i = 0; i < n; i++)
            if (alive[i] && deg[i] < best) {
                best = deg[i];
                v = i;
            }
        perm_out[step] = v;
        alive[v] = 0;

        /* connect v's alive neighbors into a clique */
        for (j = 0; j < adj[v].len; j++) {
            int u = adj[v].items[j];
            int w;
            if (!alive[u])
                continue;
            /* adj[u] := (adj[u] u nb(v)) \ {v, u}, alive only */
            stamp++;
            mark[u] = stamp;
            mark[v] = stamp;
            w = 0;
            for (k = 0; k < adj[u].len; k++) {
                int t = adj[u].items[k];
                if (alive[t] && mark[t] != stamp) {
                    mark[t] = stamp;
                    adj[u].items[w++] = t;
                }
            }
            adj[u].len = w;
            for (k = 0; k < adj[v].len; k++) {
                int t = adj[v].items[k];
                if (alive[t] && mark[t] != stamp) {
                    mark[t] = stamp;
                    if (vec_push(&adj[u], t))
                        goto done;
                }
            }
            deg[u] = adj[u].len;
        }
    }
    rc = 0;

done:
    if (adj) {
        for (i = 0; i < n; i++)
            free(adj[i].items);
        free(adj);
    }
    free(alive);
    free(deg);
    free(mark);
    return rc;
}
