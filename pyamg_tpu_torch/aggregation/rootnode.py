"""Root-node smoothed aggregation (counterpart of
``pyamg_tpu/aggregation/rootnode.py``; setup phase, numpy).

As SA, but the tentative prolongator is scaled to an exact identity at
each aggregate's root node (its C-point) and energy minimisation keeps
those rows: injection at the C-points, energy-minimised interpolation
elsewhere.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, asarray_or_ell
from pyamg_tpu_torch.multilevel import MultilevelSolver
from pyamg_tpu_torch.relaxation.smoothing import change_smoothers, unpack_arg
from pyamg_tpu_torch.aggregation.aggregate import aggregate_dispatch
from pyamg_tpu_torch.aggregation.aggregation import (
    _block_rows, _galerkin, _improve_candidates, _transpose, candidates,
    level_with_candidates, strength_and_dominance)
from pyamg_tpu_torch.aggregation.energy import energy_prolongation_smoother
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.util.utils import (SetupClock, get_Cpt_params, levelize,
                                        scale_T)


def rootnode_solver(A, B=None, BH=None, symmetry="hermitian",
                    strength="symmetric", aggregate="standard",
                    smooth="energy",
                    presmoother=("block_gauss_seidel",
                                 {"sweep": "symmetric"}),
                    postsmoother=("block_gauss_seidel",
                                  {"sweep": "symmetric"}),
                    improve_candidates=(("block_gauss_seidel",
                                         {"sweep": "symmetric",
                                          "iterations": 4}), None),
                    max_levels=10, max_coarse=10,
                    diagonal_dominance=False, keep=False,
                    coarse_solver="pinv", seed=0, **kwargs):
    """Root-node SA hierarchy of a host ELL, a host BELL or scipy sparse
    (reference ``rootnode.py:25``); other keyword arguments are accepted
    and ignored, as the JAX package does.  ``smooth`` is ``'energy'`` (with its
    options as ``('energy', {...})``) or None; the coarse candidates are B
    injected at the C-points.  Each level keeps ``Cnodes``, ``Cpts`` and
    ``Fpts``, and with ``keep`` also ``C``, ``AggOp`` and ``T``.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.aggregation import rootnode_solver
    >>> ml = rootnode_solver(poisson((30, 30)), max_coarse=10)
    >>> [lvl.A.shape[0] for lvl in ml.levels]
    [900, 158, 18, 2]
    """
    A = asarray_or_ell(A)
    B, BH = candidates(A, B, BH, symmetry)
    bs = A.blocksize[0] if isinstance(A, BELL) else 1
    if B.shape[1] < bs:
        raise ValueError("B must have at least blocksize candidates")

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


def _extend_hierarchy(levels, strength, aggregate, smooth,
                      improve_candidates, diagonal_dominance, keep,
                      symmetry, seed):
    """One root-node coarsening step; False when coarsening stalls."""
    lvl_idx = len(levels) - 1
    A, B = levels[-1].A, levels[-1].B
    bs = A.blocksize[0] if isinstance(A, BELL) else 1
    nonsym = symmetry == "nonsymmetric"
    clock = SetupClock()

    AH = _transpose(A, conjugate=True) if nonsym else None
    C = strength_and_dominance(A, strength[lvl_idx], diagonal_dominance)
    clock.mark("strength")
    AggOp, Cnodes = aggregate_dispatch(C, aggregate[lvl_idx],
                                       seed=seed + lvl_idx)
    clock.mark("aggregate")
    nnodes, nagg = AggOp.shape
    if nagg == 0 or nagg >= nnodes:
        return False
    Cnodes = np.asarray(Cnodes)

    B = _improve_candidates(A, B, improve_candidates[lvl_idx])
    levels[-1].B = B
    if nonsym:
        BH = _improve_candidates(AH, levels[-1].BH,
                                 improve_candidates[lvl_idx])
        levels[-1].BH = BH
    clock.mark("improve_candidates")

    # the tentative prolongator of the first bs candidates, scaled to the
    # identity at the root nodes
    T = scale_T(fit_candidates(AggOp, B[:, :bs])[0], Cnodes)
    if nonsym:
        TH = scale_T(fit_candidates(AggOp, BH[:, :bs])[0], Cnodes)
    params = get_Cpt_params(A, Cnodes)
    Cpts = params["Cpts"]
    # the coarse candidates: injection at the C-points
    Bc = B[Cpts]
    BHc = BH[Cpts] if nonsym else None
    clock.mark("fit_candidates")

    fn, skwargs = unpack_arg(smooth[lvl_idx])
    if fn not in ("energy", None):
        raise ValueError(f"unrecognized prolongation smoother {fn!r}")

    def smoothed(A_, T_, Bc_, B_):
        if fn is None:
            return T_
        return energy_prolongation_smoother(A_, T_, C, Bc_, B_,
                                            Cpt_params=(True, params),
                                            **skwargs)

    P = smoothed(A, T, Bc, B)
    clock.mark("smooth_P")
    if nonsym:
        R = _transpose(smoothed(AH, TH, BHc, BH), conjugate=True)
    else:
        R = _transpose(P, conjugate=symmetry == "hermitian")
    clock.mark("transpose_R")

    if keep:
        levels[-1].C = C
        levels[-1].AggOp = AggOp
        levels[-1].T = T
    levels[-1].Cnodes = Cnodes
    levels[-1].Cpts = Cpts
    levels[-1].Fpts = params["Fpts"]
    levels[-1].P = P
    levels[-1].R = R

    Ac = _galerkin(R, A, P)
    clock.mark("rap")
    levels[-1]._setup_timings = clock.times
    levels.append(level_with_candidates(Ac, Bc, BHc))
    return True
