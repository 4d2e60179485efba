"""Pairwise (unsmoothed) aggregation AMG (counterpart of
``pyamg_tpu/aggregation/pairwise.py``; setup phase, numpy): every level
aggregates by composed pairwise matchings and takes the normalised
aggregation operator as P."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import asarray_or_ell
from pyamg_tpu_torch.multilevel import Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.smoothing import change_smoothers, unpack_arg
from pyamg_tpu_torch.aggregation.aggregate import pairwise_aggregation
from pyamg_tpu_torch.aggregation.aggregation import _galerkin, _transpose
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.util.utils import SetupClock, levelize


def pairwise_solver(A,
                    aggregate=("pairwise", {"theta": 0.25, "norm": "min",
                                            "matchings": 2}),
                    presmoother=("block_gauss_seidel",
                                 {"sweep": "symmetric"}),
                    postsmoother=("block_gauss_seidel",
                                  {"sweep": "symmetric"}),
                    max_levels=20, max_coarse=10, coarse_solver="pinv",
                    seed=0, **kwargs):
    """Pairwise-aggregation AMG hierarchy of a square host ELL or scipy
    matrix (reference ``pairwise.py:14``); other keyword arguments are
    accepted and ignored, as the JAX package does; level l matches with seed
    ``seed + l`` unless ``aggregate`` names one.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.aggregation import pairwise_solver
    >>> ml = pairwise_solver(poisson((30, 30)), max_coarse=10)
    >>> [lvl.A.shape[0] for lvl in ml.levels]
    [900, 264, 82, 25, 8]
    """
    A = asarray_or_ell(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    aggregate = levelize(aggregate, max_levels)

    levels = [Level(A=A)]
    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        lvl_idx = len(levels) - 1
        A_l = levels[-1].A
        clock = SetupClock(lvl_idx)
        fn, akwargs = unpack_arg(aggregate[lvl_idx])
        if fn != "pairwise":
            raise ValueError("aggregate method must be 'pairwise'")
        akwargs.setdefault("seed", seed + lvl_idx)
        AggOp, _ = pairwise_aggregation(A_l, **akwargs)
        clock.mark("aggregate")
        nnodes, nagg = AggOp.shape
        if nagg == 0 or nagg >= nnodes:
            break
        P, _ = fit_candidates(AggOp, np.ones((nnodes, 1), A_l.dtype))
        clock.mark("fit_candidates")
        R = _transpose(P, conjugate=True)
        clock.mark("transpose_R")
        levels[-1].AggOp, levels[-1].P, levels[-1].R = AggOp, P, R
        Ac = _galerkin(R, A_l, P)
        clock.mark("rap")
        levels[-1]._setup_timings = clock.times
        levels.append(Level(A=Ac))

    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    change_smoothers(ml, presmoother, postsmoother)
    return ml
