"""Aggregation methods (counterpart of ``grid_aggregation``,
``standard_aggregation``, ``naive_aggregation``, ``pairwise_aggregation``
and ``aggregate_dispatch`` in ``pyamg_tpu/aggregation/aggregate.py``; setup
phase, numpy).

The greedy standard and naive aggregations run in the port's native
helper (``_native/aggregation.cpp``), which is built or raises: the
aggregates fix the hierarchy, so no other method stands in for it.  The
parallel forms seed aggregates with a distance-2 (standard) or distance-1
(naive) maximal independent set and grow them by label propagation.
Pairwise aggregation composes heavy-edge handshake matchings.  Lloyd,
balanced Lloyd and METIS aggregation cluster the strength graph with
``graph.py``'s rounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL


def _aggop_from_labels(agg, nagg, dtype=np.float64) -> ELL:
    """(n,) labels (-1 = unaggregated) -> (n x nagg) unit ELL."""
    agg = np.asarray(agg, np.int32)
    n = agg.shape[0]
    has = agg >= 0
    cols = np.where(has, agg, 0)[:, None]
    vals = np.where(has, 1.0, 0.0)[:, None].astype(dtype)
    return ELL(cols, vals, has.astype(np.int32), (n, int(nagg)))


def grid_aggregation(C: ELL, ratio=3, grid=None):
    """Tile a tensor grid into ``ratio``-sized box aggregates.

    Grid-aligned tiles make the prolongator phase-structured, which is what
    lets ``compress_stencils`` build ``PhaseStencil`` transfers.  Returns
    ``(AggOp, Cpts)`` with ``AggOp.grid``/``AggOp.col_grid`` set to the
    fine and coarse grid shapes; Cpts are the tile centres.
    """
    g = tuple(grid) if grid is not None else getattr(C, "grid", None)
    if g is None:
        raise ValueError("grid aggregation requires grid metadata "
                         "(A.grid or grid=...)")
    nd = len(g)
    if isinstance(ratio, int):
        ratio = (ratio,) * nd
    ratio = tuple(int(r) for r in ratio)
    cgrid = tuple(-(-g[d] // ratio[d]) for d in range(nd))
    n = int(np.prod(g))
    coords = np.stack(np.unravel_index(np.arange(n), g), axis=1)
    cell = coords // np.array(ratio)
    labels = np.ravel_multi_index(cell.T, cgrid).astype(np.int32)
    nagg = int(np.prod(cgrid))
    AggOp = dataclasses.replace(_aggop_from_labels(labels, nagg, C.dtype),
                                grid=g, col_grid=cgrid)
    ccoords = np.stack(np.unravel_index(np.arange(nagg), cgrid), axis=1)
    centers = np.minimum(ccoords * np.array(ratio) + np.array(ratio) // 2,
                         np.array(g) - 1)
    Cpts = np.ravel_multi_index(centers.T, g).astype(np.int32)
    return AggOp, Cpts


def _csr_arrays(C: ELL):
    """Host CSR (indptr, indices) of the stored pattern of ``C``."""
    rn = np.asarray(C.row_nnz)
    indices = np.asarray(C.cols)[C.valid_mask()].astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(rn)]).astype(np.int32)
    return indptr, indices


def standard_aggregation(C: ELL, seed=0, max_rounds=None, method="greedy"):
    """Standard aggregation of the strength graph ``C``: the sequential
    3-pass greedy of the port's native helper (``method='greedy'``), or
    MIS-2 seeds grown by label propagation (``'parallel'``, which the
    greedy form also takes where it finds no aggregate).  Returns
    ``(AggOp, Cpts)``."""
    from pyamg_tpu_torch import _native
    out = _greedy(C, _native.standard_aggregation, method)
    return out or _standard_aggregation_parallel(C, seed=seed,
                                                 max_rounds=max_rounds)


def _greedy(C: ELL, native, method):
    """``(AggOp, Cpts)`` of the native greedy aggregation ``native`` for
    ``method='greedy'``, or None for ``'parallel'`` and for a graph the
    greedy finds no aggregate in."""
    if method == "parallel":
        return None
    if method != "greedy":
        raise ValueError(f"unrecognized method {method!r}")
    labels, cpts = native(C.shape[0], *_csr_arrays(C))
    nagg = int(labels.max()) + 1 if len(labels) else 0
    return (_aggop_from_labels(labels, nagg, C.vals.dtype), cpts) \
        if nagg > 0 else None


def _neighbors_nodiag(C: ELL):
    cols = np.asarray(C.cols)
    return cols, C.valid_mask() & (cols != np.arange(C.shape[0])[:, None])


def _propagate_round(cols, mask, w, agg):
    """Unaggregated nodes adopt the label of their strongest labelled
    neighbour (the first of equal strengths)."""
    lab = agg[cols]
    ok = mask & (lab >= 0)
    j = np.argmax(np.where(ok, w, -np.inf), axis=1)[:, None]
    best_ok = np.take_along_axis(ok, j, axis=1)[:, 0]
    best = np.take_along_axis(lab, j, axis=1)[:, 0]
    return np.where((agg < 0) & best_ok, best, agg)


def _seeded(C: ELL, k, seed):
    """(roots, labels with the roots numbered and -1 elsewhere, neighbour
    columns, their mask, |C|) of the distance-k MIS of C."""
    from pyamg_tpu_torch.graph import maximal_independent_set
    roots = np.where(maximal_independent_set(C, k=k, seed=seed) == 1)[0]
    agg = np.full(C.shape[0], -1, np.int32)
    agg[roots] = np.arange(len(roots))
    cols, mask = _neighbors_nodiag(C)
    return roots, agg, cols, mask, np.abs(np.asarray(C.vals))


def _standard_aggregation_parallel(C: ELL, seed=0, max_rounds=None):
    """MIS-2 seeds, then up to ``max_rounds`` (3) rounds of label
    propagation; a graph without roots makes every node an aggregate."""
    n = C.shape[0]
    roots, agg, cols, mask, w = _seeded(C, 2, seed)
    nagg = len(roots)
    if nagg == 0:
        return _aggop_from_labels(np.arange(n), n, C.vals.dtype), \
            np.arange(n)
    for _ in range(max_rounds if max_rounds is not None else 3):
        new = _propagate_round(cols, mask, w, agg)
        done = bool(np.all(new == agg))
        agg = new
        if done:
            break
    return _aggop_from_labels(agg, nagg, C.vals.dtype), roots


def naive_aggregation(C: ELL, seed=0, method="greedy"):
    """Naive aggregation of the strength graph ``C``: the greedy of the
    port's native helper (``method='greedy'``), or MIS-1 seeds with one
    round of label propagation (``'parallel'``).  Returns
    ``(AggOp, Cpts)``."""
    from pyamg_tpu_torch import _native
    return _greedy(C, _native.naive_aggregation, method) or \
        _naive_aggregation_parallel(C, seed=seed)


def _naive_aggregation_parallel(C: ELL, seed=0):
    """MIS-1 seeds and one round of label propagation (MIS-1 maximality
    puts every node with a neighbour next to a root); nodes left over
    become aggregates of their own."""
    roots, agg, cols, mask, w = _seeded(C, 1, seed)
    nagg = len(roots)
    agg = _propagate_round(cols, mask, w, agg)
    left = np.where(agg < 0)[0]
    if len(left):
        agg[left] = nagg + np.arange(len(left))
        roots = np.concatenate([roots, left])
        nagg += len(left)
    return _aggop_from_labels(agg, nagg, C.vals.dtype), roots


def pairwise_aggregation(A, matchings=2, theta=0.25, norm="min", seed=0):
    """Notay-style pairwise aggregation by ``matchings`` composed
    heavy-edge handshake matchings, each on the Galerkin product of the
    last (reference ``aggregate.py:181``).  A BELL is matched on its
    blocks' minima.  ``theta`` and ``norm`` are accepted and not used, as
    in the JAX package.  Returns ``(AggOp, Cpts)``, Cpts the first member
    of each aggregate."""
    from pyamg_tpu_torch.ops.spgemm import spgemm
    from pyamg_tpu_torch.ops.transpose import transpose
    if not isinstance(A, ELL):
        from pyamg_tpu_torch.strength import _block_reduce
        A = _block_reduce(A, "min")
    total, cur = None, A
    for m in range(matchings):
        agg, nagg = _one_matching(cur, seed=seed + m)
        T = _aggop_from_labels(agg, nagg, cur.vals.dtype)
        total = T if total is None else spgemm(total, T, width=1)
        if m + 1 < matchings:
            cur = spgemm(spgemm(transpose(T), cur), T)
    has = np.asarray(total.row_nnz) > 0
    total = ELL(total.cols, np.where(total.valid_mask(), 1.0, 0.0).astype(
        total.vals.dtype), total.row_nnz, total.shape)
    labels = np.asarray(total.cols[:, 0])
    members = np.where(has)[0]
    nagg = total.shape[1]
    # the first member of each aggregate (0 for an empty one)
    Cpts = np.zeros(nagg, np.int64)
    first = np.unique(labels[members], return_index=True)
    Cpts[first[0]] = members[first[1]]
    return total, Cpts


def _one_matching(A: ELL, seed=0):
    """Heavy-edge handshake matching: each round, every live node points
    at its live neighbour of the largest ``-Re(a_ij)`` plus a fresh random
    tie-break (``rng.random(n) * 1e-6 * scale``, in float64 as the JAX
    package's sum promotes it), and mutual pairs match; up to 12 rounds.
    Returns (labels, number of aggregates): pairs in order of their first
    node, the unmatched nodes as singletons."""
    n = A.shape[0]
    cols = np.asarray(A.cols)
    rows = np.arange(n)
    mask = A.valid_mask() & (cols != rows[:, None])
    w = np.where(mask, -np.real(np.asarray(A.vals)), -np.inf)
    scale = float(np.max(np.where(np.isfinite(w), np.abs(w), 0))) or 1.0
    partner = np.full(n, -1, np.int64)
    rng = np.random.default_rng(seed)
    live = np.ones(n, bool)
    for _ in range(12):
        tie = rng.random(n) * (1e-6 * scale)
        key = w.astype(np.float64) + tie[cols]
        ww = np.where(live[cols] & mask & live[:, None], key, -np.inf)
        j = np.argmax(ww, axis=1)[:, None]
        tgt = np.take_along_axis(cols, j, axis=1)[:, 0]
        ok = np.take_along_axis(ww, j, axis=1)[:, 0] > -np.inf
        tgt = np.where(ok & live, tgt, -1)
        mutual = (tgt >= 0) & (tgt[np.where(tgt >= 0, tgt, 0)] == rows)
        partner = np.where(mutual & (partner < 0), tgt, partner)
        live = live & (partner < 0)
        if not live.any():
            break
    # number the pairs and singletons in order of their first node
    first = (partner < 0) | (partner > rows)
    ids = np.cumsum(first) - 1
    agg = np.where(first, ids, ids[np.where(partner >= 0, partner, 0)])
    return agg.astype(np.int32), int(first.sum())


def _weighted(C: ELL, data) -> ELL:
    """The graph of C's pattern with edge weights ``data`` (0 off it)."""
    return ELL(C.cols, np.where(C.valid_mask(), data, 0).astype(data.dtype),
               C.row_nnz, C.shape)


def _inverse_magnitudes(C: ELL):
    """``1 / max(|C|, 1e-300)`` in C's dtype (inf where that floor rounds
    to 0, off the pattern)."""
    with np.errstate(divide="ignore"):
        return 1.0 / np.maximum(np.abs(np.asarray(C.vals)), 1e-300)


def lloyd_aggregation(C: ELL, ratio=0.1, distance="unit", maxiter=10,
                      seed=0):
    """Lloyd-clustering aggregation of the strength graph C into
    ``max(1, int(ratio * n))`` aggregates (reference ``aggregate.py:313``):
    edge lengths 1 (``'unit'``), ``|c_ij|`` (``'abs'``) or ``1 / |c_ij|``
    (``'inv'``).  The seeds come from ``default_rng(0)`` whatever
    ``seed`` is, as in the JAX package.  Returns ``(AggOp, Cpts)``, Cpts
    the final centers."""
    from pyamg_tpu_torch.graph import lloyd_cluster
    if distance == "unit":
        data = np.ones(C.cols.shape)
    elif distance == "abs":
        data = np.abs(np.asarray(C.vals))
    elif distance == "inv":
        data = _inverse_magnitudes(C)
    else:
        raise ValueError(f"unrecognized distance {distance!r}")
    nagg = max(1, int(ratio * C.shape[0]))
    clusters, centers = lloyd_cluster(_weighted(C, data), nagg,
                                      maxiter=maxiter)
    return _aggop_from_labels(clusters, nagg, C.vals.dtype), centers


def balanced_lloyd_aggregation(C: ELL, num_clusters=None, maxiter=5, seed=0):
    """Balanced Lloyd aggregation (reference ``aggregate.py:424``):
    balanced Bellman-Ford assignment with edge lengths ``1 / |c_ij|`` and
    graph-median re-centring, ``num_clusters`` (``sqrt(n)`` by default)
    seeds from ``default_rng(seed)``.  Returns ``(AggOp, Cpts)``."""
    from pyamg_tpu_torch.graph import balanced_lloyd_cluster
    if num_clusters is None:
        num_clusters = max(1, int(C.shape[0] ** 0.5))
    clusters, centers = balanced_lloyd_cluster(
        _weighted(C, _inverse_magnitudes(C)), num_clusters, maxiter=maxiter,
        seed=seed)
    return _aggop_from_labels(clusters, num_clusters, C.vals.dtype), centers


def metis_aggregation(C: ELL, ratio=0.1, measure=None, seed=0):
    """Aggregation by a partition of the strength graph into
    ``max(1, int(ratio * n))`` parts (reference ``aggregate.py:563``):
    ``graph.metis_partition``, which is balanced Lloyd clustering where
    ``pymetis`` is not installed.  Edge weights: 1 (``measure`` None or
    ``'unit'``) or ``round(9 |c_ij|) + 1`` (``'range'``).  Returns
    ``(AggOp, None)``."""
    from pyamg_tpu_torch.graph import metis_partition
    if measure is None or measure == "unit":
        data = np.ones(C.cols.shape)
    elif measure == "range":
        data = np.round(9 * np.abs(np.asarray(C.vals))) + 1
    else:
        raise ValueError(f"Unrecognized value measure={measure}")
    nparts = max(1, int(ratio * C.shape[0]))
    parts = np.asarray(metis_partition(_weighted(C, data), nparts,
                                       seed=seed))
    return _aggop_from_labels(parts, int(parts.max()) + 1,
                              C.vals.dtype), None


def aggregate_dispatch(C, spec, seed=0):
    """Dispatch PyAMG's ``(name, opts)`` aggregation convention:
    ``'grid'``, ``'standard'``, ``'naive'``, ``'pairwise'``, ``'lloyd'``,
    ``'balanced lloyd'``, ``'metis'`` and ``'predefined'``."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    name, opts = unpack_arg(spec)
    if name == "grid":
        return grid_aggregation(C, **opts)
    if name == "standard":
        return standard_aggregation(C, seed=seed, **opts)
    if name == "naive":
        return naive_aggregation(C, seed=seed, **opts)
    if name == "pairwise":
        return pairwise_aggregation(C, seed=seed, **opts)
    if name == "lloyd":
        return lloyd_aggregation(C, seed=seed, **opts)
    if name == "balanced lloyd":
        return balanced_lloyd_aggregation(C, seed=seed, **opts)
    if name == "metis":
        return metis_aggregation(C, seed=seed, **opts)
    if name == "predefined":
        return opts["AggOp"], opts.get("Cpts")
    raise ValueError(f"unrecognized aggregation method {name!r}")
