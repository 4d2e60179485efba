"""Pure-Python reference graph algorithms for testing
(counterpart of ``pyamg_tpu/graph_ref.py``).

These are deliberately naive edge-relaxation loops; the round-based
implementations in :mod:`pyamg_tpu_torch.graph` are held against them.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import to_scipy


def bellman_ford_reference(A, centers):
    """Naive Bellman-Ford from multiple seeds.

    Returns (distances, nearest-center index, predecessor) arrays; the
    graph is the sparsity of A with edge weights A[i, j] >= 0.
    """
    S = to_scipy(A).tocoo()
    n = S.shape[0]
    d = np.full(n, np.inf)
    m = np.full(n, -1, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    centers = np.asarray(centers)
    d[centers] = 0
    m[centers] = np.arange(len(centers))
    for _ in range(n):
        changed = False
        for i, j, w in zip(S.row, S.col, S.data):
            if d[i] + w < d[j]:
                d[j] = d[i] + w
                m[j] = m[i]
                p[j] = i
                changed = True
        if not changed:
            break
    return d, m, p


def bellman_ford_balanced_reference(A, centers):
    """Balanced variant: distance ties (and strict improvements) prefer the
    smaller cluster, mirroring ``graph.h:736`` tie-breaking semantics."""
    S = to_scipy(A).tocoo()
    n = S.shape[0]
    d = np.full(n, np.inf)
    m = np.full(n, -1, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    centers = np.asarray(centers)
    d[centers] = 0
    m[centers] = np.arange(len(centers))
    for _ in range(n * 2):
        sizes = np.bincount(m[m >= 0], minlength=len(centers))
        changed = False
        for i, j, w in zip(S.row, S.col, S.data):
            if m[i] < 0:
                continue
            better = d[i] + w < d[j]
            tie = (d[i] + w == d[j]) and m[j] >= 0 and \
                sizes[m[i]] + 1 < sizes[m[j]]
            if better or (tie and m[i] != m[j]):
                d[j] = d[i] + w
                m[j] = m[i]
                p[j] = i
                changed = True
        if not changed:
            break
    return d, m, p
