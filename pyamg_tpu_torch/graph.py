"""Graph algorithms of the setup phase (counterpart of the maximal
independent set and the vertex coloring of ``pyamg_tpu/graph.py``).

Both are Luby-style rounds over the ELL adjacency, iterated on the host
with numpy to a fixed point: a node wins a round when its key is strictly
greater than every still-active neighbour's.  ``G`` is an ELL matrix whose
sparsity is the edge set; self loops are ignored.
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
