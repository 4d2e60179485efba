"""Grid and standard aggregation (counterpart of ``grid_aggregation``,
``standard_aggregation`` and ``aggregate_dispatch`` in
``pyamg_tpu/aggregation/aggregate.py``; setup phase, numpy)."""

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


def standard_aggregation(C: ELL, seed=0, method="greedy"):
    """Standard aggregation of the strength graph ``C``: the sequential
    3-pass greedy of the port's native helper.  Returns ``(AggOp, Cpts)``.
    ``method='parallel'`` (MIS-2 seeds and label propagation) is not
    ported."""
    from pyamg_tpu_torch import _native
    if method != "greedy":
        raise NotImplementedError(
            f"standard aggregation method {method!r} is not ported yet "
            "(only 'greedy')")
    indptr, indices = _csr_arrays(C)
    labels, cpts = _native.standard_aggregation(C.shape[0], indptr, indices)
    nagg = int(labels.max()) + 1 if len(labels) else 0
    if nagg == 0:
        raise NotImplementedError(
            "a graph without aggregates takes the parallel aggregation, "
            "which is not ported yet")
    return _aggop_from_labels(labels, nagg, C.vals.dtype), cpts


def aggregate_dispatch(C, spec, seed=0):
    """Dispatch PyAMG's ``(name, opts)`` aggregation convention; ``'grid'``
    and ``'standard'`` are ported."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    name, opts = unpack_arg(spec)
    if name == "grid":
        return grid_aggregation(C, **opts)
    if name == "standard":
        return standard_aggregation(C, seed=seed, **opts)
    raise NotImplementedError(
        f"aggregation {name!r} is not ported yet (only 'grid' and "
        "'standard')")
