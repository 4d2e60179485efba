"""AIR: approximate-ideal-restriction AMG (counterpart of
``pyamg_tpu/classical/air.py``; reference ``pyamg/classical/air.py:21``),
for nonsymmetric and advective systems.

Per level, on the host: an optional row filter of A, classical strength,
C/F splitting, P (one-point by default), R by lAIR's local solves and the
Galerkin product R A P of the filtered A, with F/C Jacobi post-smoothing,
which reads each level's ``splitting``.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import asarray_or_ell
from pyamg_tpu_torch.multilevel import Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.smoothing import change_smoothers, unpack_arg
from pyamg_tpu_torch.strength import strength_measure
from pyamg_tpu_torch.classical.classical import (interpolation_of,
                                                 splitting_of)
from pyamg_tpu_torch.classical.interpolate import local_air
from pyamg_tpu_torch.ops.spgemm import spgemm
from pyamg_tpu_torch.util.utils import SetupClock


def air_solver(A,
               strength=("classical", {"theta": 0.3, "norm": "min"}),
               CF=("RS", {"second_pass": True}),
               interpolation="one_point",
               restrict=("air", {"theta": 0.05, "degree": 2}),
               presmoother=None,
               postsmoother=("fc_jacobi", {"omega": 1.0, "iterations": 1,
                                           "withrho": False,
                                           "f_iterations": 2,
                                           "c_iterations": 1}),
               filter_operator=None,
               max_levels=20, max_coarse=20, keep=False,
               coarse_solver="pinv", seed=0, **kwargs):
    """AIR AMG hierarchy of a scalar operator (host ELL or scipy sparse).
    ``filter_operator=(lump, theta)`` drops, before each level's setup,
    the off-diagonal entries under ``theta`` times the diagonal (lumping
    them onto it with ``lump``).

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import advection_2d
    >>> from pyamg_tpu_torch.classical import air_solver
    >>> A, rhs = advection_2d((16, 16))
    >>> ml = air_solver(A, CF="PMIS")
    >>> ml.levels[0].splitting.shape
    (225,)
    """
    A = asarray_or_ell(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    levels = [Level(A=A)]
    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        if _extend_hierarchy(levels, strength, CF, interpolation, restrict,
                             filter_operator, keep, seed + len(levels)):
            break
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, CF, interpolation, restrict,
                      filter_operator, keep, seed):
    """One AIR coarsening step (reference ``air.py:136-242``); True when
    coarsening must stop."""
    A = levels[-1].A
    clock = SetupClock()
    if filter_operator is not None and filter_operator[1] != 0:
        from pyamg_tpu_torch.util.utils import filter_matrix_rows
        A = filter_matrix_rows(A, filter_operator[1], diagonal=True,
                               lump=filter_operator[0])
    clock.mark("filter")
    if A.nnz == A.shape[0]:
        return True
    C = strength_measure(A, strength)
    clock.mark("strength")
    splitting = splitting_of(C, CF, seed)
    clock.mark("split")
    num_cpts = int(np.sum(splitting))
    if num_cpts == len(splitting) or num_cpts == 0:
        return True
    P = interpolation_of(A, C, splitting, interpolation)
    clock.mark("interpolate")
    fn, rkwargs = unpack_arg(restrict)
    if fn not in ("air", "lair"):
        raise ValueError(f"unknown restriction method {restrict}")
    R = local_air(A, splitting, **rkwargs)
    clock.mark("lair_restrict")
    lvl = levels[-1]
    lvl.splitting = splitting.astype(bool)
    lvl.Fpts = np.flatnonzero(splitting == 0)
    lvl.Cpts = np.flatnonzero(splitting == 1)
    if keep:
        lvl.C = C
    lvl.P = P
    lvl.R = R
    Ac = spgemm(spgemm(R, A), P)
    clock.mark("rap")
    lvl._setup_timings = clock.times
    levels.append(Level(A=Ac))
    return False
