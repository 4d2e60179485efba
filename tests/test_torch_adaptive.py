"""The port's adaptive smoothed aggregation (``aggregation/adaptive.py``)
against the JAX package's, on the CPU: ``adaptive_sa_solver`` on 2-D
Poisson 24^2 with one and two candidates, with and without
``eliminate_local``, and with an improvement sweep; each trial hierarchy
and the factor first measured on it; the candidates,
``work``, the hierarchy and the solve; ``eliminate_local_candidates``;
the JAX package's hierarchy fed through ``hierarchy_from_arrays``; and the
float32 bootstrap, whose candidate norm underflows in the JAX package.

Tolerances: float64.  Rows, ``work`` and every trial's rows equal; each
measured rho within 1e-10 relative (the trial cycles run as torch ops on
the CPU in the port and jitted in the JAX package); the candidates B
within 1e-8 of the largest; A, P and R with equal patterns and values
within 1e-8 of the largest (they are built from those B); the solve's
iteration count equal.  float32: the port's first candidate within 1e-4 of
the largest of the JAX package's float64 one.
"""

import warnings

import numpy as np
import pytest
import torch

import pyamg_tpu.aggregation.adaptive as ref_adaptive
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.strength import strength_measure as ref_strength

import pyamg_tpu_torch.aggregation.adaptive as adaptive
from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import adaptive_sa_solver
from pyamg_tpu_torch.gallery import poisson

from jax_families_reference import adaptive_trials
from test_torch_cycles import _coarse_spec, _ell, _smoother
from test_torch_energy import port
from test_torch_rootnode import iterations, same_hierarchy

torch.set_num_threads(1)

CASES = {"one": {"num_candidates": 1},
         "two": {"num_candidates": 2},
         "two-eliminate": {"num_candidates": 2,
                           "eliminate_local": (True, {"thresh": 1.0})},
         "one-eliminate-improve": {"num_candidates": 1, "improvement_iters": 1,
                                   "eliminate_local": (True, {})}}


@pytest.fixture(scope="module")
def hierarchies():
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, kw in CASES.items():
            ml, work = adaptive_sa_solver(poisson((24, 24)), max_coarse=10,
                                          **kw)
            mr, extra = adaptive_trials(ref_poisson((24, 24)), max_coarse=10,
                                        **kw)
            out[name] = (ml, work, mr, extra)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_adaptive_solver_matches_reference(hierarchies, name):
    ml, work, mr, extra = hierarchies[name]
    assert work == extra["work"]
    assert [t["rows"] for t in ml.trials] == \
        [t["rows"] for t in extra["trials"]]
    for got, want in zip(ml.trials, extra["trials"]):
        assert (got["rho"] is None) == (want["rho"] is None)
        if want["rho"] is not None:
            assert abs(got["rho"] - want["rho"]) <= 1e-10 * want["rho"]
    B, Br = ml.levels[0].B, np.asarray(mr.levels[0].B)
    assert B.shape == Br.shape == (576, CASES[name]["num_candidates"])
    assert np.abs(B - Br).max() <= 1e-8 * np.abs(Br).max()
    same_hierarchy(ml, mr, tol=1e-8)
    if "eliminate" in name:
        assert not hasattr(ml.levels[0], "AggOp")
    got, want = iterations(ml, mr, "cg")
    assert got == want < 100


def test_eliminate_local_candidates_matches_reference(hierarchies):
    ml, _, mr, _ = hierarchies["one"]
    from pyamg_tpu_torch.aggregation import standard_aggregation
    from pyamg_tpu.aggregation.aggregate import standard_aggregation as ref_std
    from pyamg_tpu.aggregation.tentative import fit_candidates as ref_fit
    A = ref_poisson((24, 24))
    AggOp, _ = ref_std(ref_strength(A, ("symmetric", {})))
    T, _ = ref_fit(AggOp, np.asarray(mr.levels[0].B))
    x = np.random.default_rng(5).standard_normal(576)
    x[:100] *= 1e-3
    for thresh in (0.1, 1.0, 10.0):
        want = ref_adaptive.eliminate_local_candidates(x, AggOp, A, T,
                                                       thresh=thresh)
        got = adaptive.eliminate_local_candidates(x, port(AggOp), port(A),
                                                  port(T), thresh=thresh)
        np.testing.assert_array_equal(got == 0, np.asarray(want) == 0)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert standard_aggregation(port(ref_strength(A, ("symmetric", {}))))[
        0].shape == tuple(AggOp.shape)


def test_reference_hierarchy_through_arrays(hierarchies):
    _, _, mr, _ = hierarchies["one"]
    levels = []
    for i, lvl in enumerate(mr.levels):
        d = {"A": _ell(lvl.A), "B": np.asarray(lvl.B)}
        if i < len(mr.levels) - 1:
            d.update(P=_ell(lvl.P), R=_ell(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post))
        levels.append(d)
    ml = hierarchy_from_arrays({"levels": levels,
                                "coarse": _coarse_spec(mr.coarse_solver)},
                               device="cpu")
    b = np.random.default_rng(0).standard_normal(576)
    got, want = [], []
    ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=got)
    mr.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=want)
    assert len(got) == len(want) < 100
    assert np.abs(np.subtract(got, want)).max() <= 1e-12 * want[0]


# -- float32: a JAX package fault the port does not copy ----------------------

def _first_candidate(module, A, **kw):
    """(the candidate the bootstrap hands to the first trial hierarchy,
    the hierarchy) of ``module.adaptive_sa_solver(A, **kw)``."""
    seen, build = [], module.smoothed_aggregation_solver

    def recording(*args, **kwargs):
        seen.append(np.asarray(kwargs["B"]))
        return build(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "smoothed_aggregation_solver", recording)
        out = module.adaptive_sa_solver(A, max_coarse=10, **kw)
    return seen[0], out[0]


def test_float32_candidate_is_normalized_without_underflow():
    """On float32 2-D Poisson 24^2 the bootstrapped candidate's entries are
    about 1e-19: their squares fall below float32's normal range, and the
    JAX package's norm comes out 0, so it hands over the candidate
    unnormalised (at 500^2 its hierarchy stops at level 1 this way).  The
    port scales by the largest entry first: its candidate has norm 1 and
    equals the JAX package's float64 one, and its hierarchy solves."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Br, _ = _first_candidate(ref_adaptive,
                                 ref_poisson((24, 24)).astype(np.float32))
        B64, _ = _first_candidate(ref_adaptive, ref_poisson((24, 24)))
        B, ml = _first_candidate(adaptive,
                                 poisson((24, 24)).astype(np.float32))
    assert np.linalg.norm(Br) < 1e-10
    assert B.dtype == np.float32 and abs(np.linalg.norm(B) - 1) < 1e-6
    assert np.abs(B - B64).max() <= 1e-4 * np.abs(B64).max()
    assert [lvl.A.shape[0] for lvl in ml.levels] == [576, 102, 12, 2]
    b = np.random.default_rng(0).standard_normal(576)
    res = []
    from test_torch_rootnode import on_cpu
    on_cpu(ml).solve(b, tol=1e-5, maxiter=50, accel="cg", residuals=res)
    assert res[-1] < 1e-5 * res[0]


def test_zero_candidate_warns():
    """With 20 relaxations a level the float32 bootstrap relaxes its
    candidate to exactly 0 (in both packages): the port says so."""
    with pytest.warns(UserWarning, match="bootstrapped candidate is zero"):
        B, _ = _first_candidate(adaptive,
                                poisson((24, 24)).astype(np.float32),
                                candidate_iters=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Br, _ = _first_candidate(ref_adaptive,
                                 ref_poisson((24, 24)).astype(np.float32),
                                 candidate_iters=20)
    assert not B.any() and not Br.any()
