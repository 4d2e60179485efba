"""Smoothed-aggregation solver constructor (counterpart of
``pyamg_tpu/aggregation/aggregation.py:smoothed_aggregation_solver``).

Per level, on the host with numpy/scipy: strength of connection,
aggregation, candidate improvement (relaxation on A x = 0), tentative
prolongator by per-aggregate QR, prolongation smoothing, restriction by
symmetry and the Galerkin product.  Scalar operators only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyamg_tpu_torch.sparse.matrix import asarray_or_ell
from pyamg_tpu_torch.multilevel import Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.smoothing import (
    apply_smoother, change_smoothers, make_smoother, unpack_arg)
from pyamg_tpu_torch.strength import strength_measure
from pyamg_tpu_torch.aggregation.aggregate import aggregate_dispatch
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.aggregation.smooth import smooth_prolongator
from pyamg_tpu_torch.util.utils import levelize
from pyamg_tpu_torch.ops.spgemm import spgemm
from pyamg_tpu_torch.ops.transpose import transpose


def _improve_candidates(A, B, spec):
    fn, kwargs = unpack_arg(spec)
    if fn is None:
        return B
    kind, sopts, params = make_smoother(None, A, (fn, kwargs))
    return apply_smoother(kind, sopts, params, A, np.asarray(B),
                          np.zeros_like(np.asarray(B)))


def smoothed_aggregation_solver(A, B=None, symmetry="hermitian",
                                strength="symmetric", aggregate="standard",
                                smooth=("jacobi", {"omega": 4.0 / 3.0}),
                                presmoother=("block_gauss_seidel",
                                             {"sweep": "symmetric"}),
                                postsmoother=("block_gauss_seidel",
                                              {"sweep": "symmetric"}),
                                improve_candidates=(("block_gauss_seidel",
                                                     {"sweep": "symmetric",
                                                      "iterations": 4}),
                                                    None),
                                max_levels=10, max_coarse=10,
                                diagonal_dominance=False, keep=False,
                                coarse_solver="pinv", seed=0):
    """Smoothed-aggregation AMG hierarchy of a symmetric or Hermitian
    scalar operator (host ELL or scipy sparse).  Of the aggregation
    methods ``'standard'`` (the default, greedy) and ``'grid'`` are
    ported.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    >>> ml = smoothed_aggregation_solver(poisson((30, 30)),
    ...                                  aggregate=("grid", {}))
    >>> len(ml.levels)
    4
    >>> len(smoothed_aggregation_solver(poisson((30, 30))).levels)
    4
    """
    A = asarray_or_ell(A)
    if symmetry == "nonsymmetric":
        raise NotImplementedError("nonsymmetric SA is not ported yet")
    if symmetry not in ("symmetric", "hermitian"):
        raise ValueError("expected symmetric, nonsymmetric or hermitian")
    if diagonal_dominance:
        raise NotImplementedError("diagonal_dominance is not ported yet")
    n = A.shape[0]
    B = np.ones((n, 1), dtype=A.dtype) if B is None else \
        np.asarray(B, dtype=A.dtype)
    if B.ndim == 1:
        B = B[:, None]

    strength = levelize(strength, max_levels)
    aggregate = levelize(aggregate, max_levels)
    smooth = levelize(smooth, max_levels)
    improve_candidates = levelize(improve_candidates, max_levels)

    levels = [Level(A=A)]
    levels[0].B = B
    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        if not _extend_hierarchy(levels, strength, aggregate, smooth,
                                 improve_candidates, keep, symmetry, seed):
            break

    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, aggregate, smooth,
                      improve_candidates, keep, symmetry, seed):
    """One coarsening step; False when coarsening stalls."""
    lvl_idx = len(levels) - 1
    A, B = levels[-1].A, levels[-1].B

    C = strength_measure(A, strength[lvl_idx])
    # the strength filter drops the grid tag: thread it through so grid
    # aggregation and the PhaseStencil transfers can engage
    fine_grid = A.grid
    if fine_grid is not None:
        C = dataclasses.replace(C, grid=fine_grid)

    AggOp, Cnodes = aggregate_dispatch(C, aggregate[lvl_idx],
                                       seed=seed + lvl_idx)
    coarse_grid = getattr(AggOp, "col_grid", None)
    nnodes, nagg = AggOp.shape
    if nagg == 0 or nagg >= nnodes:
        return False

    B = _improve_candidates(A, B, improve_candidates[lvl_idx])
    levels[-1].B = B
    T, Bc = fit_candidates(AggOp, B)
    P = smooth_prolongator(smooth[lvl_idx], A, T, C, Bc)
    # grid-aligned single-candidate coarsening keeps the tensor structure:
    # tag P and the Galerkin product with the fine and coarse grids
    if coarse_grid is not None and fine_grid is not None \
            and Bc.shape[1] == 1:
        P = dataclasses.replace(P, grid=fine_grid, col_grid=coarse_grid)
    else:
        coarse_grid = None

    R = transpose(P, conjugate=(symmetry == "hermitian"))

    if keep:
        levels[-1].C = C
        levels[-1].AggOp = AggOp
        levels[-1].T = T
    levels[-1].Cnodes = Cnodes
    levels[-1].P = P
    levels[-1].R = R

    Ac = spgemm(spgemm(R, A), P)
    if coarse_grid is not None:
        Ac = dataclasses.replace(Ac, grid=coarse_grid)
    lvl = Level(A=Ac)
    lvl.B = Bc
    levels.append(lvl)
    return True
