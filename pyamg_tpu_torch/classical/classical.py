"""Ruge-Stuben classical AMG solver constructor (counterpart of
``pyamg_tpu/classical/classical.py``; reference
``pyamg/classical/classical.py:20``).

Per level, on the host: classical strength of connection, C/F splitting,
classical (or direct, injection, one-point) interpolation, R = P^T and the
Galerkin product.  Scalar operators only.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import asarray_or_ell
from pyamg_tpu_torch.multilevel import Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.smoothing import change_smoothers, unpack_arg
from pyamg_tpu_torch.strength import strength_measure
from pyamg_tpu_torch.classical import split as split_mod
from pyamg_tpu_torch.classical.interpolate import (
    classical_interpolation, direct_interpolation, injection_interpolation,
    one_point_interpolation)
from pyamg_tpu_torch.ops.spgemm import spgemm
from pyamg_tpu_torch.ops.transpose import transpose
from pyamg_tpu_torch.util.utils import SetupClock


def splitting_of(C, CF, seed):
    """The C/F splitting of the strength graph C under PyAMG's ``CF``
    spec (CR included)."""
    fn, cf_kwargs = unpack_arg(CF)
    if fn == "CR":
        from pyamg_tpu_torch.classical.cr import CR
        return np.asarray(CR(C, **cf_kwargs), np.int32)
    return split_mod.split_dispatch(C, CF, seed=seed)


def interpolation_of(A, C, splitting, interpolation):
    """P of A under PyAMG's ``interpolation`` spec."""
    fn, kwargs = unpack_arg(interpolation)
    if fn == "classical":
        return classical_interpolation(A, C, splitting, **kwargs)
    if fn == "direct":
        return direct_interpolation(A, C, splitting, **kwargs)
    if fn == "injection":
        return injection_interpolation(A, splitting, **kwargs)
    if fn == "one_point":
        return one_point_interpolation(A, C, splitting, **kwargs)
    raise ValueError(f"unknown interpolation method {interpolation}")


def ruge_stuben_solver(A,
                       strength=("classical", {"theta": 0.25}),
                       CF=("RS", {"second_pass": False}),
                       interpolation="classical",
                       presmoother=("gauss_seidel", {"sweep": "symmetric"}),
                       postsmoother=("gauss_seidel", {"sweep": "symmetric"}),
                       max_levels=30, max_coarse=10, keep=False,
                       coarse_solver="pinv", seed=0, **kwargs):
    """Classical (Ruge-Stuben) AMG hierarchy of a scalar operator (host ELL
    or scipy sparse).  ``CF`` is ``'RS'``, ``'PMIS'``, ``'PMISc'``,
    ``'CLJP'``, ``'CLJPc'``, ``'MIS'`` or ``'CR'`` (with options as
    ``(name, {opts})``); ``interpolation`` is ``'classical'``,
    ``'direct'``, ``'injection'`` or ``'one_point'``.  ``keep`` keeps each
    level's strength graph as ``C``; each level's setup times are in
    ``setup_timings()``.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.classical import ruge_stuben_solver
    >>> ml = ruge_stuben_solver(poisson((10, 10)), max_coarse=3)
    >>> [l.A.shape[0] for l in ml.levels]
    [100, 50, 14, 5, 1]
    """
    A = asarray_or_ell(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    levels = [Level(A=A)]
    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        if _extend_hierarchy(levels, strength, CF, interpolation, keep,
                             seed + len(levels)):
            break
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, CF, interpolation, keep, seed):
    """One coarsening step (reference ``classical.py:123-203``); True when
    coarsening must stop."""
    A = levels[-1].A
    clock = SetupClock()
    C = strength_measure(A, strength)
    clock.mark("strength")
    splitting = splitting_of(C, CF, seed)
    clock.mark("split")
    num_cpts = int(np.sum(splitting))
    if num_cpts == len(splitting) or num_cpts == 0:
        return True
    P = interpolation_of(A, C, splitting, interpolation)
    clock.mark("interpolate")
    R = transpose(P)
    clock.mark("transpose_R")
    if keep:
        levels[-1].C = C
    levels[-1].splitting = splitting.astype(bool)
    levels[-1].P = P
    levels[-1].R = R
    Ac = spgemm(spgemm(R, A), P)
    clock.mark("rap")
    levels[-1]._setup_timings = clock.times
    levels.append(Level(A=Ac))
    return False
