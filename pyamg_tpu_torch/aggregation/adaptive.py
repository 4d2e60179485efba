"""Adaptive smoothed aggregation (counterpart of
``pyamg_tpu/aggregation/adaptive.py``; setup phase).

The first candidate is bootstrapped by relaxation on ``A x = 0`` down a
trial hierarchy and back up; three rounds of self-improvement then cycle
with the current solver on ``A x = 0``, each measuring the solver's
factor and making the slowest mode the next candidate, and the best
solver seen wins; a general stage adds candidates and improvement sweeps
refine them.  The trial hierarchies are not compressed (ELL or BELL
levels), so their cycles run where the setup runs: on the host, with
plain torch ops on the CPU.  No kernel takes part.
"""

from __future__ import annotations

import copy
import warnings

import numpy as np

from pyamg_tpu_torch.sparse.matrix import asarray_or_ell, to_scipy
from pyamg_tpu_torch.multilevel import MultilevelSolver
from pyamg_tpu_torch.ops.spmv import matvec
from pyamg_tpu_torch.relaxation.smoothing import apply_smoother, make_smoother
from pyamg_tpu_torch.aggregation.aggregation import (
    _galerkin, _transpose, smoothed_aggregation_solver)
from pyamg_tpu_torch.util.linalg import approximate_spectral_radius


def eliminate_local_candidates(x, AggOp, A, T, thresh=1.0):
    """x with the aggregates where it is locally unimportant set to 0
    (reference ``adaptive.py:25``): an aggregate is dropped when the
    candidate's local mass ``<x, x>_i`` is at most the energy-scaled
    weight ``thresh * card_i * <Ax, x> / (n rho(A))``, or when the part of
    x outside range(T) is."""
    x = np.asarray(x)
    nnodes, nagg = AggOp.shape
    ndof = x.shape[0]
    npde = ndof // nnodes
    labels = np.where(np.asarray(AggOp.row_nnz) > 0,
                      np.asarray(AggOp.cols[:, 0]), nagg)
    dof_labels = np.repeat(labels, npde)

    def agg_inner(z):
        return np.bincount(dof_labels, weights=np.abs(z) ** 2,
                           minlength=nagg + 1)[:nagg]

    rho = approximate_spectral_radius(A)
    zAz = float(np.real(np.vdot(x, to_scipy(A) @ x)))
    card = npde * np.bincount(labels, minlength=nagg + 1)[:nagg]
    weights = thresh * card * zAz / (ndof * rho)
    Ts = to_scipy(T)
    projected = x - Ts @ (Ts.conj().T @ x)
    drop = (agg_inner(x) <= weights) | (agg_inner(projected) <= weights)
    kill_node = np.zeros(nnodes, dtype=bool)
    valid = labels < nagg
    kill_node[valid] = drop[labels[valid]]
    return np.where(np.repeat(kill_node, npde), 0.0, x)


def _relax_on_homogeneous(A, x, spec, iterations):
    """x <- relax(A, x, b = 0), ``iterations`` times (host arrays)."""
    kind, sopts, params = make_smoother(None, A, spec)
    b = np.zeros_like(x)
    for _ in range(iterations):
        x = apply_smoother(kind, sopts, params, A, x, b)
    return x


def _normalized(x):
    """x / ||x||, scaled by max |x| first so that the norm of a tiny
    candidate does not underflow (0 stays 0)."""
    big = np.max(np.abs(x)) if x.size else 0
    if big == 0:
        return x
    x = x / big
    return x / np.linalg.norm(x)


def _cycled(ml, x0, iterations):
    """(x, ||x||, rho): x after ``iterations`` V-cycles on A x = 0 from x0
    (numpy, in the hierarchy's dtype), run by a CPU twin of the host
    hierarchy ``ml`` (which stays unplaced), and the factor
    ``(||x|| / ||x0||)^(1 / iterations)``, which the first call on ``ml``
    also records in its trial."""
    twin = MultilevelSolver([copy.copy(lvl) for lvl in ml.levels],
                            coarse_solver=copy.copy(ml.coarse_solver))
    twin.symmetric_smoothing = ml.symmetric_smoothing
    twin.to_device("cpu")
    x = twin.solve(np.zeros_like(x0), x0=x0, maxiter=iterations, tol=1e-16,
                   cycle="V").numpy()
    nrm = float(np.linalg.norm(x))
    rho = (nrm / float(np.linalg.norm(x0))) ** (1.0 / iterations)
    if ml._trial["rho"] is None:
        ml._trial["rho"] = rho
    return x, nrm, rho


def _nnz(ml):
    return sum(lvl.A.nnz for lvl in ml.levels)


def adaptive_sa_solver(A, initial_candidates=None, symmetry="hermitian",
                       pdef=True, num_candidates=1, candidate_iters=5,
                       improvement_iters=0, epsilon=0.1, max_levels=10,
                       max_coarse=10, aggregate="standard",
                       prepostsmoother=("gauss_seidel",
                                        {"sweep": "symmetric"}),
                       smooth=("jacobi", {}), strength="symmetric",
                       coarse_solver="pinv", eliminate_local=(False, {}),
                       keep=False, seed=0, **kwargs):
    """Adaptive SA hierarchy (reference ``adaptive.py:117``); returns
    ``(ml, work)``, work in stored non-zeros touched.  ``kwargs`` go on to
    ``smoothed_aggregation_solver``.  The hierarchy records its trials in
    ``ml.trials``: for each hierarchy the setup built, its rows and the
    factor rho first measured on it (None for one never cycled).
    A candidate whose norm would underflow is scaled by its largest entry
    first; a zero candidate raises a warning.  ``pdef`` and ``epsilon``
    are accepted and not used, as in the JAX package."""
    A = asarray_or_ell(A)
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    work = 0.0
    do_elim, elim_opts = eliminate_local if isinstance(
        eliminate_local, tuple) else (bool(eliminate_local), {})
    trials = []

    def build(B):
        ml = smoothed_aggregation_solver(
            A, B=B, symmetry=symmetry, strength=strength,
            aggregate=aggregate, smooth=smooth, presmoother=prepostsmoother,
            postsmoother=prepostsmoother, max_levels=max_levels,
            max_coarse=max_coarse, coarse_solver=coarse_solver,
            keep=keep or do_elim, **kwargs)
        ml._trial = {"rows": [lvl.A.shape[0] for lvl in ml.levels],
                     "rho": None}
        trials.append(ml._trial)
        return ml

    def candidate(x):
        if do_elim and len(ml.levels) > 1:
            lvl = ml.levels[0]
            x = eliminate_local_candidates(x, lvl.AggOp, lvl.A, lvl.T,
                                           **elim_opts).astype(A.dtype)
        return x

    if initial_candidates is None:
        # the initial stage: relax on A x = 0 at every level of a trial
        # hierarchy going down, then interpolate back up relaxing again
        from pyamg_tpu_torch.strength import strength_measure
        from pyamg_tpu_torch.aggregation.aggregate import aggregate_dispatch
        from pyamg_tpu_torch.aggregation.tentative import fit_candidates
        from pyamg_tpu_torch.aggregation.smooth import smooth_prolongator
        x = rng.standard_normal(n).astype(A.dtype)
        x = _relax_on_homogeneous(A, x, prepostsmoother, candidate_iters)
        work += A.nnz * candidate_iters
        trail = []
        A_l, x_l = A, x
        while A_l.shape[0] > max_coarse and len(trail) + 1 < max_levels:
            C = strength_measure(A_l, strength)
            AggOp, _ = aggregate_dispatch(C, aggregate, seed=seed)
            if AggOp.shape[1] == 0 or AggOp.shape[1] >= AggOp.shape[0]:
                break
            T, xc = fit_candidates(AggOp, x_l[:, None])
            P = smooth_prolongator(smooth, A_l, T, C, xc)
            trail.append((A_l, P))
            A_l = _galerkin(_transpose(P, conjugate=True), A_l, P)
            x_l = _relax_on_homogeneous(A_l, xc[:, 0], prepostsmoother,
                                        candidate_iters)
            work += A_l.nnz * candidate_iters
        for A_l, P in reversed(trail):
            x_l = _relax_on_homogeneous(A_l, matvec(P, x_l),
                                        prepostsmoother, candidate_iters)
            work += A_l.nnz * candidate_iters
        if not np.any(x_l):
            warnings.warn("adaptive SA: the bootstrapped candidate is zero; "
                          "the hierarchy built on it does not coarsen")
        B = _normalized(x_l)[:, None]
    else:
        B = np.asarray(initial_candidates, A.dtype)
        B = B[:, None] if B.ndim == 1 else B

    ml = build(B)
    work += _nnz(ml)

    # self-improvement: cycling on A x = 0 exposes the solver's slowest
    # mode, the next candidate; each round measures the solver's factor
    # and the best solver seen wins
    if initial_candidates is None:
        best, best_rho = ml, np.inf
        for _ in range(3):
            x0 = rng.standard_normal(n).astype(A.dtype)
            x, nrm, rho = _cycled(ml, x0, candidate_iters)
            work += _nnz(ml) * candidate_iters
            if rho < best_rho:
                best, best_rho = ml, rho
            if rho < 0.1 or nrm < 1e-12:
                break
            B = (x / nrm)[:, None]
            ml = build(B)
            work += _nnz(ml)
        if best_rho < np.inf:
            ml = best
            B = ml.levels[0].B

    # the general stage: grow the candidate set
    for _ in range(max(num_candidates - 1, 0)):
        x0 = rng.standard_normal(n).astype(A.dtype)
        x = candidate(_cycled(ml, x0, candidate_iters)[0])
        work += _nnz(ml) * candidate_iters
        if not np.any(x):
            break  # the solver is exact: no new candidate
        B = np.concatenate([B, _normalized(x)[:, None]], axis=1)
        ml = build(B)
        work += _nnz(ml)

    # improvement sweeps over the candidates
    for _ in range(max(improvement_iters, 0)):
        newB = []
        for i in range(B.shape[1]):
            x = candidate(_cycled(ml, np.ascontiguousarray(B[:, i]),
                                  candidate_iters)[0])
            work += _nnz(ml) * candidate_iters
            newB.append(_normalized(x))
        B = np.stack(newB, axis=1)
        ml = build(B)
        work += _nnz(ml)

    if do_elim and not keep:
        # elimination made every trial keep its AggOp, T and C
        for lvl in ml.levels:
            for attr in ("AggOp", "T", "C"):
                lvl.__dict__.pop(attr, None)
    ml.trials = trials
    del ml._trial
    return ml, float(work)
