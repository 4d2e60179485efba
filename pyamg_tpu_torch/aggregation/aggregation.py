"""Smoothed-aggregation solver constructor (counterpart of
``pyamg_tpu/aggregation/aggregation.py:smoothed_aggregation_solver``).

Per level, on the host with numpy/scipy: strength of connection,
aggregation, candidate improvement (relaxation on A x = 0), tentative
prolongator by per-aggregate QR, prolongation smoothing, restriction by
symmetry and the Galerkin product.  A block (BELL) operator coarsens its
block graph: T, P, R and the coarse operators are BELLs, the Galerkin
product a block SpGEMM.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, asarray_or_ell
from pyamg_tpu_torch.multilevel import Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.smoothing import (
    apply_smoother, change_smoothers, make_smoother, unpack_arg)
from pyamg_tpu_torch.strength import strength_measure
from pyamg_tpu_torch.aggregation.aggregate import aggregate_dispatch
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.aggregation.smooth import smooth_prolongator
from pyamg_tpu_torch.util.utils import (SetupClock, eliminate_diag_dom_nodes,
                                        levelize)
from pyamg_tpu_torch.ops.spgemm import spgemm, spgemm_bell
from pyamg_tpu_torch.ops.transpose import btranspose, transpose


def _galerkin(R, A, P):
    if isinstance(A, BELL):
        return spgemm_bell(spgemm_bell(R, A), P)
    return spgemm(spgemm(R, A), P)


def _transpose(P, conjugate):
    if isinstance(P, BELL):
        return btranspose(P, conjugate=conjugate)
    return transpose(P, conjugate=conjugate)


def _block_rows(A):
    return A.n_block_rows if isinstance(A, BELL) else A.shape[0]


def _improve_candidates(A, B, spec):
    fn, kwargs = unpack_arg(spec)
    if fn is None:
        return B
    kind, sopts, params = make_smoother(None, A, (fn, kwargs))
    return apply_smoother(kind, sopts, params, A, np.asarray(B),
                          np.zeros_like(np.asarray(B)))


def smoothed_aggregation_solver(A, B=None, BH=None, symmetry="hermitian",
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
                                coarse_solver="pinv", seed=0, **kwargs):
    """Smoothed-aggregation AMG hierarchy of a host ELL, a host BELL or
    scipy sparse (BSR becomes a BELL).  Other keyword arguments are
    accepted and ignored, as the JAX package does.  ``B`` defaults to ones, or on a
    BELL to one candidate per unknown of a block (``kron(ones,
    eye(blocksize))``); ``max_coarse`` counts block rows.  With
    ``symmetry='nonsymmetric'`` R is the adjoint of a P smoothed on A^H
    from the left candidates ``BH`` (B by default).
    ``diagonal_dominance`` (True or ``(True, {'theta': ...})``) keeps
    strongly diagonally dominant rows on the fine level.  Every level
    records ``symmetry``, on which the blackbox ``solve`` picks its Krylov
    method.

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
    B, BH = candidates(A, B, BH, symmetry)

    strength = levelize(strength, max_levels)
    aggregate = levelize(aggregate, max_levels)
    smooth = levelize(smooth, max_levels)
    improve_candidates = levelize(improve_candidates, max_levels)

    levels = [level_with_candidates(A, B, BH)]
    while len(levels) < max_levels and \
            _block_rows(levels[-1].A) > max_coarse:
        if not _extend_hierarchy(levels, strength, aggregate, smooth,
                                 improve_candidates, diagonal_dominance,
                                 keep, symmetry, seed):
            break

    for lvl in levels:
        lvl.symmetry = symmetry
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def candidates(A, B, BH, symmetry):
    """(B, BH) as (n, k) arrays in A's dtype: B defaults to ones, or on a
    BELL to one candidate per unknown of a block; BH, kept only for
    ``symmetry='nonsymmetric'``, to B."""
    if symmetry not in ("symmetric", "hermitian", "nonsymmetric"):
        raise ValueError("expected symmetric, nonsymmetric or hermitian")
    n = A.shape[0]
    bs = A.blocksize[0] if isinstance(A, BELL) else 1
    B = np.kron(np.ones((n // bs, 1)), np.eye(bs)) if B is None else B
    B = np.asarray(B, dtype=A.dtype)
    B = B[:, None] if B.ndim == 1 else B
    if symmetry != "nonsymmetric":
        return B, None
    BH = B if BH is None else np.asarray(BH, dtype=A.dtype)
    return B, (BH[:, None] if BH.ndim == 1 else BH)


def level_with_candidates(A, B, BH):
    """A level of A with its candidates B (and BH, where not None)."""
    lvl = Level(A=A)
    lvl.B = B
    if BH is not None:
        lvl.BH = BH
    return lvl


def strength_and_dominance(A, spec, diagonal_dominance):
    """The strength of connection of A by ``spec``, without the edges of
    the rows ``diagonal_dominance`` marks as dominant."""
    C = strength_measure(A, spec)
    if diagonal_dominance:
        flag, dd_kwargs = unpack_arg(diagonal_dominance)
        if flag:
            C = eliminate_diag_dom_nodes(A, C, **dd_kwargs)
    return C


def _extend_hierarchy(levels, strength, aggregate, smooth,
                      improve_candidates, diagonal_dominance, keep, symmetry,
                      seed):
    """One coarsening step; False when coarsening stalls."""
    lvl_idx = len(levels) - 1
    A, B = levels[-1].A, levels[-1].B
    nonsym = symmetry == "nonsymmetric"
    clock = SetupClock(lvl_idx)

    AH = _transpose(A, conjugate=True) if nonsym else None
    C = strength_and_dominance(A, strength[lvl_idx], diagonal_dominance)
    clock.mark("strength")
    # the strength filter drops the grid tag: thread it through so grid
    # aggregation and the PhaseStencil transfers can engage
    fine_grid = getattr(A, "grid", None)
    if fine_grid is not None:
        C = dataclasses.replace(C, grid=fine_grid)

    AggOp, Cnodes = aggregate_dispatch(C, aggregate[lvl_idx],
                                       seed=seed + lvl_idx)
    clock.mark("aggregate")
    coarse_grid = getattr(AggOp, "col_grid", None)
    nnodes, nagg = AggOp.shape
    if nagg == 0 or nagg >= nnodes:
        return False

    B = _improve_candidates(A, B, improve_candidates[lvl_idx])
    levels[-1].B = B
    if nonsym:
        BH = _improve_candidates(AH, levels[-1].BH,
                                 improve_candidates[lvl_idx])
        levels[-1].BH = BH
    clock.mark("improve_candidates")
    T, Bc = fit_candidates(AggOp, B)
    if nonsym:
        TH, BHc = fit_candidates(AggOp, BH)
    clock.mark("fit_candidates")
    P = smooth_prolongator(smooth[lvl_idx], A, T, C, Bc)
    clock.mark("smooth_P")
    # grid-aligned single-candidate coarsening keeps the tensor structure:
    # tag P and the Galerkin product with the fine and coarse grids
    if coarse_grid is not None and fine_grid is not None \
            and not isinstance(P, BELL) and Bc.shape[1] == 1:
        P = dataclasses.replace(P, grid=fine_grid, col_grid=coarse_grid)
    else:
        coarse_grid = None

    if nonsym:
        R = _transpose(smooth_prolongator(smooth[lvl_idx], AH, TH, C, BHc),
                       conjugate=True)
    else:
        R = _transpose(P, conjugate=(symmetry == "hermitian"))

    if keep:
        levels[-1].C = C
        levels[-1].AggOp = AggOp
        levels[-1].T = T
    levels[-1].Cnodes = Cnodes
    levels[-1].P = P
    levels[-1].R = R
    clock.mark("transpose_R")

    Ac = _galerkin(R, A, P)
    clock.mark("rap")
    levels[-1]._setup_timings = clock.times
    if coarse_grid is not None:
        Ac = dataclasses.replace(Ac, grid=coarse_grid)
    levels.append(level_with_candidates(Ac, Bc, BHc if nonsym else None))
    return True
