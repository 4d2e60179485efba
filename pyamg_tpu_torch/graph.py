"""Graph algorithms of the setup phase (counterpart of
``pyamg_tpu/graph.py``).

Every algorithm runs in rounds over the ELL adjacency, iterated on the
host with numpy to a fixed point, as the JAX package iterates its jitted
rounds.  The maximal independent set and the coloring are Luby-style: a
node wins a round when its key is strictly greater than every
still-active neighbour's.  Bellman-Ford relaxes every node at once from
the previous round's distances, taking the first smallest offer over a
row's ELL slots and only a strict improvement, so its ties fall as the
JAX package's do; distances are float64 with ``inf`` for unreached
nodes.  Lloyd clustering alternates Bellman-Ford and re-centring.  ``G``
is an ELL matrix whose sparsity is the edge set (values are the edge
weights where they count); self loops are ignored.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL


def _neighbors(G: ELL):
    """(cols, mask) with padding and self loops masked out."""
    cols = np.asarray(G.cols)
    rows = np.arange(G.shape[0], dtype=np.int32)[:, None]
    return cols, G.valid_mask() & (cols != rows)


def _mis_round(cols, mask, state, keys):
    """One Luby round. state: 0 active, 1 in the set, -1 removed."""
    active = state == 0
    nk = np.where(active[cols] & mask, keys[cols], -np.inf)
    winner = active & (keys > nk.max(axis=1, initial=-np.inf))
    nwin = (winner[cols] & mask).any(axis=1)
    state = np.where(winner, 1, state)
    return np.where((state == 0) & nwin, -1, state).astype(np.int8)


def maximal_independent_set(G: ELL, algo="parallel", k=1, weights=None,
                            seed=0, max_iters=None):
    """Distance-k maximal independent set: int8, 1 = in the set (reference
    ``graph.py:33`` / ``graph.h:140,974``).  The keys are a random
    permutation of the nodes from ``seed``, led by ``weights`` when given.
    """
    n = G.shape[0]
    Gk = G
    if k > 1:
        from pyamg_tpu_torch.ops.spgemm import spgemm
        for _ in range(k - 1):
            Gk = spgemm(Gk, G)
    cols, mask = _neighbors(Gk)
    perm = np.random.default_rng(seed).permutation(n).astype(np.float64)
    keys = perm if weights is None else \
        np.asarray(weights, np.float64) * n + perm
    state = np.zeros((n,), np.int8)
    it = 0
    while (state == 0).any():
        state = _mis_round(cols, mask, state, keys)
        it += 1
        if max_iters is not None and it >= max_iters:
            break
        if it > n + 2:
            raise RuntimeError("MIS failed to converge")
    return (state == 1).astype(np.int8)


def vertex_coloring(G: ELL, method="JP", seed=0):
    """Parallel greedy coloring: int32 colors >= 0 (reference
    ``graph.py:84`` / ``graph.h:297,351``).  Each round, the uncolored
    nodes whose key beats every uncolored neighbour's take the smallest
    color no colored neighbour has.  ``'JP'`` keys are a random permutation
    from ``seed``; ``'LDF'`` (largest degree first) leads with the degree.
    ``'MIS'`` takes JP keys, as the JAX package does (PyAMG colors by
    repeated maximal independent sets there)."""
    n = G.shape[0]
    cols, mask = _neighbors(G)
    perm = np.random.default_rng(seed).permutation(n).astype(np.float64)
    if method in ("LDF", "ldf"):
        keys = mask.sum(axis=1).astype(np.float64) * n + perm
    else:
        keys = perm
    color = np.full((n,), -1, np.int32)
    cand = np.arange(G.width + 1, dtype=np.int32)
    it = 0
    while (color < 0).any():
        uncolored = color < 0
        nk = np.where(uncolored[cols] & mask, keys[cols], -np.inf)
        winner = uncolored & (keys > nk.max(axis=1, initial=-np.inf))
        ncol = np.where(mask, color[cols], -1)
        used = (ncol[:, :, None] == cand[None, None, :]).any(axis=1)
        avail = used.argmin(axis=1).astype(np.int32)
        color = np.where(winner, avail, color)
        it += 1
        if it > n + 2:
            raise RuntimeError("coloring failed to converge")
    return color


# -- Bellman-Ford and clustering (reference graph.h:671, graph.py:129-600) --

def _sources(n, centers):
    """Distances (0 at the centers, inf elsewhere) and the nearest center's
    index (-1 where none) of a multi-source search."""
    centers = np.asarray(centers, np.int32)
    dist = np.full((n,), np.inf)
    dist[centers] = 0.0
    nearest = np.full((n,), -1, np.int32)
    nearest[centers] = np.arange(centers.shape[0], dtype=np.int32)
    return centers, dist, nearest


def _first_min(vals, *more):
    """The first smallest entry of each row of ``vals`` and the entries of
    ``more`` at the same slots."""
    j = np.argmin(vals, axis=1)[:, None]
    return [np.take_along_axis(a, j, axis=1)[:, 0] for a in (vals,) + more]


def _bf_round(cols, mask, w, dist, nearest):
    """Relax every node once from the previous distances: the first
    smallest ``dist[j] + w`` over the row's slots, taken where strictly
    smaller."""
    nd = np.where(mask, dist[cols] + w, np.inf)
    best, bcols = _first_min(nd, cols)
    better = best < dist
    return np.where(better, best, dist), \
        np.where(better, nearest[bcols], nearest)


def bellman_ford(G: ELL, centers, max_iters=None):
    """Multi-source shortest paths with edge weights ``|G.vals|``:
    (float64 distances, index of the nearest center, -1 where none),
    after rounds to a fixed point or ``max_iters`` (reference
    ``graph.py:129``)."""
    n = G.shape[0]
    cols, mask = _neighbors(G)
    w = np.abs(np.asarray(G.vals))
    _, dist, nearest = _sources(n, centers)
    limit = max_iters if max_iters is not None else n + 1
    for _ in range(limit):
        nd, nn = _bf_round(cols, mask, w, dist, nearest)
        if np.array_equal(nd, dist) and np.array_equal(nn, nearest):
            break
        dist, nearest = nd, nn
    return dist, nearest


def breadth_first_search(G: ELL, seed_node: int):
    """(order, level): the BFS level of every node from ``seed_node`` (-1
    where unreached) and the nodes in a stable order of level, the
    unreached first (reference ``graph.py:640``)."""
    n = G.shape[0]
    cols, mask = _neighbors(G)
    level = np.full((n,), -1, np.int32)
    level[seed_node] = 0
    cur = 0
    while True:
        frontier = level == cur
        newly = (frontier[cols] & mask).any(axis=1) & (level < 0)
        if not newly.any():
            break
        level = np.where(newly, cur + 1, level).astype(np.int32)
        cur += 1
    return np.argsort(level, kind="stable"), level


def connected_components(G: ELL):
    """Component labels 0..k-1 in order of each component's smallest node,
    by min-label propagation (reference ``graph.py:698``)."""
    n = G.shape[0]
    cols, mask = _neighbors(G)
    label = np.arange(n, dtype=np.int32)
    while True:
        nl = np.minimum(label, np.where(mask, label[cols], n).min(axis=1))
        if np.array_equal(nl, label):
            break
        label = nl.astype(np.int32)
    return np.unique(label, return_inverse=True)[1].astype(np.int32)


def lloyd_cluster(G: ELL, centers, maxiter=5):
    """Lloyd clustering on a graph (reference ``graph.py:203-288``):
    Bellman-Ford assignment and re-centring on each cluster's most
    interior node, until the centers stay or ``maxiter`` rounds.
    ``centers`` is a count of seeds or an array of seed nodes; a count
    draws its seeds from ``default_rng(0)``, as the JAX package does.
    Returns (cluster of each node, the final center nodes)."""
    n = G.shape[0]
    if np.isscalar(centers):
        nc = int(centers)
        centers = np.random.default_rng(0).choice(n, size=nc, replace=False)
    else:
        nc = len(centers)
    centers = np.asarray(centers, np.int32)
    for _ in range(maxiter):
        _, clusters = bellman_ford(G, centers)
        new_centers = most_interior_nodes(G, clusters, nc).astype(np.int32)
        done = np.array_equal(new_centers, centers)
        centers = new_centers
        if done:
            break
    _, clusters = bellman_ford(G, centers)
    return clusters, centers


def kmeanspp_seed(G: ELL, nc, seed=0):
    """k-means++ seeds on graph distances (reference ``graph.py:602``):
    each new center drawn with probability proportional to the squared
    distance from the current ones (unreached nodes one past the
    farthest)."""
    n = G.shape[0]
    rng = np.random.default_rng(seed)
    centers = [int(rng.integers(n))]
    for _ in range(nc - 1):
        d, _ = bellman_ford(G, np.asarray(centers))
        d = np.array(d)
        fin = np.isfinite(d)
        d[~fin] = d[fin].max() + 1 if fin.any() else 1.0
        p = d ** 2
        s = p.sum()
        if s == 0:
            centers.append(int(rng.choice(np.setdiff1d(np.arange(n),
                                                       centers))))
            continue
        centers.append(int(rng.choice(n, p=p / s)))
    return np.asarray(centers)


_NO_SIZE = 2 ** 30


def _bf_balanced_round(cols, mask, w, dist, nearest, sizes):
    """One balanced round (reference ``graph.h:736``): each node takes the
    first smallest (distance, cluster size) offer, where strictly closer,
    or as close from a cluster two or more smaller than its own."""
    nd = np.where(mask, dist[cols] + w, np.inf)
    ncl = np.where(mask, nearest[cols], -1)
    nsz = np.where(ncl >= 0, sizes[np.maximum(ncl, 0)], _NO_SIZE)
    best_d, best_c, best_s = _first_min(nd * (2.0 ** 32) + nsz, nd, ncl,
                                        nsz)[1:]
    cur_s = np.where(nearest >= 0, sizes[np.maximum(nearest, 0)], _NO_SIZE)
    better = (best_d < dist) | ((best_d == dist) & (best_c >= 0) &
                                (best_s + 1 < cur_s))
    return np.where(better, best_d, dist), \
        np.where(better, best_c, nearest).astype(np.int32)


def bellman_ford_balanced(G: ELL, centers, max_iters=None):
    """Balanced multi-source shortest paths (reference ``graph.py:129`` /
    ``graph.h:736``): as ``bellman_ford``, with distance ties going to
    the smaller cluster; at most ``2 n + 2`` rounds by default."""
    n = G.shape[0]
    cols, mask = _neighbors(G)
    w = np.abs(np.asarray(G.vals))
    centers, dist, nearest = _sources(n, centers)
    nc = centers.shape[0]
    limit = max_iters if max_iters is not None else 2 * n + 2
    for _ in range(limit):
        sizes = np.bincount(nearest[nearest >= 0], minlength=nc).astype(
            np.int32)
        nd, nn = _bf_balanced_round(cols, mask, w, dist, nearest, sizes)
        if np.array_equal(nd, dist) and np.array_equal(nn, nearest):
            break
        dist, nearest = nd, nn
    return dist, nearest


def _cluster_floyd_warshall(G: ELL, clusters, nc, maxsize):
    """All-pairs shortest paths inside each cluster by a batched dense
    Floyd-Warshall in G's dtype (reference ``graph.h:436``): (members
    (nc, maxsize), -1 padded, in node order; D (nc, maxsize, maxsize)).
    An edge of weight 0 counts as no edge, as in the JAX package."""
    from pyamg_tpu_torch.ops.rowops import row_lookup
    cl = np.asarray(clusters)
    order = np.argsort(cl, kind="stable")
    cs = cl[order]
    rank = np.arange(len(cs)) - np.searchsorted(cs, cs)
    take = (cs >= 0) & (cs < nc) & (rank < maxsize)
    members = np.full((nc, maxsize), -1, np.int64)
    members[cs[take], rank[take]] = order[take]
    mem = np.where(members < 0, 0, members).reshape(-1)
    m = maxsize
    sub = ELL(np.asarray(G.cols)[mem], np.abs(np.asarray(G.vals))[mem],
              np.asarray(G.row_nnz)[mem], (nc * m, G.shape[1]))
    qc = np.broadcast_to(mem.reshape(nc, 1, m), (nc, m, m)).reshape(nc * m, m)
    Wd = row_lookup(sub, qc).reshape(nc, m, m)
    D = np.where(Wd > 0, Wd, np.inf).astype(Wd.dtype)
    eye = np.eye(m, dtype=bool)[None]
    D = np.where(eye, 0, D).astype(Wd.dtype)
    ok = members >= 0
    D = np.where((ok[:, :, None] & ok[:, None, :]) | eye, D, np.inf).astype(
        Wd.dtype)
    for k in range(m):
        D = np.minimum(D, D[:, :, k][:, :, None] + D[:, k, :][:, None, :])
    return members, D


def center_nodes(G: ELL, clusters, nc, maxsize=None):
    """The graph median of each cluster, the member with the smallest sum
    of in-cluster distances (the first of equal sums; reference
    ``graph.h:530``); node 0 for a cluster without members."""
    cl = np.asarray(clusters)
    sizes = np.bincount(cl[cl >= 0], minlength=nc)
    m = int(sizes.max()) if len(sizes) else 1
    if maxsize is not None:
        m = min(m, maxsize)
    members, D = _cluster_floyd_warshall(G, cl, nc, max(m, 1))
    ok = members >= 0
    Dn = np.array(D)
    Dn[~np.isfinite(Dn)] = 1e30
    rowsum = (Dn * ok[:, None, :]).sum(axis=2)
    rowsum[~ok] = np.inf
    centers = members[np.arange(nc), rowsum.argmin(axis=1)]
    return np.where(ok.any(axis=1), centers, 0)


def balanced_lloyd_cluster(G: ELL, num_clusters, maxiter=5, rebalance_iters=0,
                           seed=0):
    """Balanced Lloyd clustering (reference ``graph.py:289-600``):
    balanced Bellman-Ford assignment and graph-median re-centring, from
    ``num_clusters`` seeds drawn by ``default_rng(seed)``.  The JAX package
    takes ``rebalance_iters`` and ignores it; the port raises for a
    positive one rather than pretend to rebalance.  Returns (cluster of
    each node, the final center nodes)."""
    if rebalance_iters > 0:
        raise NotImplementedError("balanced Lloyd clustering has no "
                                  "rebalancing passes (rebalance_iters=0)")
    n = G.shape[0]
    centers = np.random.default_rng(seed).choice(n, size=num_clusters,
                                                 replace=False)
    maxsize = 12 * int(np.ceil(n / num_clusters))
    for _ in range(maxiter):
        _, clusters = bellman_ford_balanced(G, centers)
        if (clusters < 0).any():
            raise ValueError("Lloyd clustering failed to assign all nodes")
        new_centers = center_nodes(G, clusters, num_clusters, maxsize)
        if np.array_equal(new_centers, centers):
            break
        centers = new_centers
    _, clusters = bellman_ford_balanced(G, centers)
    return clusters, np.asarray(centers)


def pseudo_peripheral_node(G: ELL):
    """(node, BFS order, BFS levels) of a pseudo-peripheral node, by BFS
    from node 0 and then from the least connected node of the last level
    until the eccentricity stops growing (reference ``graph.py:789``)."""
    deg = _neighbors(G)[1].sum(axis=1)
    u, last_ecc = 0, -1
    while True:
        order, level = breadth_first_search(G, u)
        ecc = int(level.max())
        if ecc <= last_ecc:
            return u, order, level
        last_ecc = ecc
        frontier = np.where(level == ecc)[0]
        u = int(frontier[np.argmin(deg[frontier])])


def symmetric_rcm(A: ELL):
    """The reverse Cuthill-McKee permutation (reference ``graph.py:744``):
    BFS levels from a pseudo-peripheral node, by degree within a level,
    unreached nodes last, all reversed."""
    deg = _neighbors(A)[1].sum(axis=1)
    _, _, level = pseudo_peripheral_node(A)
    perm = np.lexsort((deg, level))
    unreached = level[perm] < 0
    perm = np.concatenate([perm[~unreached], perm[unreached]])
    return perm[::-1].copy()


def metis_partition(G: ELL, nparts, seed=0):
    """``nparts`` parts of G by ``pymetis`` where it is installed, else by
    balanced Lloyd clustering from ``seed`` (reference ``graph.py:839``).
    The second is the JAX package's semantics of this host-side setup
    step, not a device fallback: the parts decide the hierarchy in both
    packages alike."""
    try:
        import pymetis
    except ImportError:
        return balanced_lloyd_cluster(G, nparts, seed=seed)[0]
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A = to_scipy(G).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    adj = [A.indices[A.indptr[i]:A.indptr[i + 1]].tolist()
           for i in range(G.shape[0])]
    _, parts = pymetis.part_graph(nparts, adjacency=adj)
    return np.asarray(parts, np.int32)


def most_interior_nodes(G: ELL, clusters, nc):
    """Per cluster, the node farthest from the cluster's border
    (reference ``graph.h:843``): distances from the border nodes along
    edges inside a cluster, the largest per cluster, ties to the smaller
    node id; a cluster without a border counts ``n + 1``; node 0 for a
    cluster without members."""
    n = G.shape[0]
    cols, mask = _neighbors(G)
    cl = np.asarray(clusters, np.int32)
    same = mask & (cl[cols] == cl[:, None])
    border = (mask & (cl[cols] != cl[:, None])).any(axis=1)
    w = np.abs(np.asarray(G.vals))
    dist = np.where(border, 0.0, np.inf)
    for _ in range(n + 1):
        nd = np.minimum(dist, np.where(same, dist[cols] + w, np.inf).min(
            axis=1))
        if np.array_equal(nd, dist):
            break
        dist = nd
    dist = np.where(np.isinf(dist), float(n + 1), dist)
    order = np.lexsort((np.arange(n), -dist))
    c = cl[order]
    keep = (c >= 0) & (c < nc)
    first, idx = np.unique(c[keep], return_index=True)
    centers = np.zeros(nc, np.int64)
    centers[first] = order[keep][idx]
    return centers
