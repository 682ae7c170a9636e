/* The host collate core of infomax3d_tpu_torch/graphs/batch.py::
 * batch_graphs: every index-shaped array of a padded flat batch in one
 * O(N + E) pass (counting sorts instead of argsorts), the feature payloads
 * left to numpy.  The port's own copy of the JAX package's pack_topology
 * (infomax3d_tpu/native/batcher.c), without the mailbox outputs, which the
 * port's batch does not carry, and with the port's CSR slot (csr_pos) and
 * degree maxima added.
 *
 * Contract: the arrays equal the numpy batcher's (batch_graphs_numpy),
 * element for element: the same padding values (sender / receiver N,
 * node graph G, node position 0), the same stable receiver and sender
 * orders, snorm as 1.0f / sqrtf(n).  Capacity checks stay in Python; this
 * file reports each side's largest degree for them.
 *
 * Build: cc -O3 -shared -fPIC -ffp-contract=off batcher.c -o batcher.so
 * (infomax3d_tpu_torch/native/__init__.py, at first use; raw int32 /
 * float32 buffers, no Python headers).
 */
#include <math.h>
#include <stdint.h>
#include <string.h>

/* stable counting sort of n keys in [0, nkeys]; order[new] = old */
static void counting_sort(const int32_t *key, int32_t n, int32_t nkeys,
                          int32_t *cnt /* [nkeys + 2] */, int32_t *order) {
    memset(cnt, 0, (size_t)(nkeys + 2) * sizeof(int32_t));
    for (int32_t e = 0; e < n; ++e) cnt[key[e] + 1]++;
    for (int32_t k = 0; k < nkeys + 1; ++k) cnt[k + 1] += cnt[k];
    for (int32_t e = 0; e < n; ++e) order[cnt[key[e]]++] = e;
}

/* row pointers [N + 1] of ids ascending in [0, N] (N: padding, last) */
static void row_pointers(const int32_t *ids, int32_t E, int32_t N,
                         int32_t *cnt /* [N + 2] */, int32_t *ptr) {
    memset(cnt, 0, (size_t)(N + 2) * sizeof(int32_t));
    for (int32_t e = 0; e < E; ++e) cnt[ids[e] < N ? ids[e] : N]++;
    ptr[0] = 0;
    for (int32_t i = 0; i < N; ++i) ptr[i + 1] = ptr[i] + cnt[i];
}

/* the largest count of one node among ids in [0, N) */
static int32_t max_degree(const int32_t *ids, int32_t E, int32_t N,
                          int32_t *cnt /* [N] */) {
    int32_t m = 0;
    memset(cnt, 0, (size_t)N * sizeof(int32_t));
    for (int32_t e = 0; e < E; ++e) {
        int32_t i = ids[e];
        if (i >= 0 && i < N && ++cnt[i] > m) m = cnt[i];
    }
    return m;
}

int pack_topology(
    /* each graph's local edge endpoints, concatenated over the graphs */
    const int32_t *src_cat, const int32_t *dst_cat,
    const int32_t *n_per, const int32_t *e_per,
    int32_t g_real, int32_t G, int32_t N, int32_t E,
    int32_t n_tot, int32_t e_tot,
    int32_t nmax,         /* readout regroup width; 0: none */
    int32_t do_csr,       /* sort the edges by receiver, CSR / CSC arrays */
    /* outputs, allocated by the caller */
    int32_t *senders, int32_t *receivers,   /* [E] */
    int32_t *edge_perm,                     /* [E] new position -> old */
    int32_t *node_graph, int32_t *node_pos, /* [N] */
    uint8_t *node_mask, uint8_t *edge_mask, /* [N], [E] */
    int32_t *n_nodes, uint8_t *graph_mask,  /* [G], [G] */
    float *snorm, float *in_degree,         /* [N], [N] */
    int32_t *csr_row_ptr,                   /* [N + 1] (do_csr) */
    int32_t *csc_perm, int32_t *csc_row_ptr,/* [E], [N + 1] (do_csr) */
    int16_t *csr_pos,                       /* [E] (do_csr) */
    int32_t *rd_node_idx, int32_t *rd_inv,  /* [G * nmax], [N] (nmax) */
    int32_t *deg_max,                       /* [2]: receivers, senders */
    int32_t *scratch                        /* [E + N + 2] */
) {
    int32_t off = 0;
    for (int32_t gi = 0; gi < g_real; ++gi) {
        int32_t n = n_per[gi];
        float s = n > 0 ? 1.0f / sqrtf((float)n) : 0.0f;
        for (int32_t j = 0; j < n; ++j) {
            node_graph[off + j] = gi;
            node_pos[off + j] = j;
            node_mask[off + j] = 1;
            snorm[off + j] = s;
            if (nmax > 0) {
                rd_inv[off + j] = gi * nmax + j;
                rd_node_idx[(int64_t)gi * nmax + j] = off + j;
            }
        }
        if (nmax > 0)
            for (int32_t j = n; j < nmax; ++j)
                rd_node_idx[(int64_t)gi * nmax + j] = N;
        n_nodes[gi] = n;
        graph_mask[gi] = 1;
        off += n;
    }
    for (int32_t i = n_tot; i < N; ++i) {
        node_graph[i] = G; node_pos[i] = 0; node_mask[i] = 0;
        snorm[i] = 0.0f;
        if (nmax > 0) rd_inv[i] = G * nmax;
    }
    for (int32_t gi = g_real; gi < G; ++gi) {
        n_nodes[gi] = 0; graph_mask[gi] = 0;
        if (nmax > 0)
            for (int32_t j = 0; j < nmax; ++j)
                rd_node_idx[(int64_t)gi * nmax + j] = N;
    }

    /* edges into batch node space; padding edges at N */
    off = 0;
    int32_t e_off = 0;
    for (int32_t gi = 0; gi < g_real; ++gi) {
        for (int32_t j = 0; j < e_per[gi]; ++j) {
            senders[e_off + j] = src_cat[e_off + j] + off;
            receivers[e_off + j] = dst_cat[e_off + j] + off;
            edge_mask[e_off + j] = 1;
        }
        e_off += e_per[gi];
        off += n_per[gi];
    }
    for (int32_t e = e_tot; e < E; ++e) {
        senders[e] = N; receivers[e] = N; edge_mask[e] = 0;
    }

    int32_t *cnt = scratch + E;             /* [N + 2] */
    if (do_csr) {
        /* the stable receiver order (numpy's argsort kind="stable") */
        int32_t *order = scratch;           /* [E] */
        counting_sort(receivers, E, N, cnt, order);
        int32_t *tmp = csc_perm;            /* free until the CSC sort */
        for (int32_t e = 0; e < E; ++e) tmp[e] = senders[order[e]];
        memcpy(senders, tmp, (size_t)E * sizeof(int32_t));
        for (int32_t e = 0; e < E; ++e) tmp[e] = receivers[order[e]];
        memcpy(receivers, tmp, (size_t)E * sizeof(int32_t));
        for (int32_t e = 0; e < E; ++e) ((uint8_t *)tmp)[e] =
            edge_mask[order[e]];
        memcpy(edge_mask, tmp, (size_t)E);
        memcpy(edge_perm, order, (size_t)E * sizeof(int32_t));
        row_pointers(receivers, E, N, cnt, csr_row_ptr);
        /* each edge's slot in its receiver's range; -1 on padding */
        for (int32_t e = 0; e < E; ++e)
            csr_pos[e] = receivers[e] < N
                ? (int16_t)(e - csr_row_ptr[receivers[e]]) : (int16_t)-1;
        /* the stable sender order of the receiver-sorted edges */
        counting_sort(senders, E, N, cnt, csc_perm);
        row_pointers(senders, E, N, cnt, csc_row_ptr);
    } else {
        for (int32_t e = 0; e < E; ++e) edge_perm[e] = e;
    }

    for (int32_t i = 0; i < N; ++i) in_degree[i] = 0.0f;
    for (int32_t e = 0; e < E; ++e)
        if (receivers[e] >= 0 && receivers[e] < N)
            in_degree[receivers[e]] += 1.0f;
    deg_max[0] = max_degree(receivers, E, N, scratch);
    deg_max[1] = max_degree(senders, E, N, scratch);
    return 0;
}
