"""The port's root-node smoothed aggregation (``aggregation/rootnode.py``)
against the JAX package's, on the CPU: whole hierarchies of 1-D Poisson
100, 2-D Poisson 24^2 (hermitian and symmetric), 2-D advection 16^2
(nonsymmetric: BH, and R from a smoothed RH) and 2-D linear elasticity
10^2 (BELL levels with the rigid-body modes), with ``keep``; their solves;
the JAX package's 24^2 hierarchy fed through ``hierarchy_from_arrays``;
and the float32 hierarchy, which the JAX package builds only with
``jax_enable_x64`` off.

Tolerances: float64.  Levels, C-points, F-points, root nodes and
aggregates equal; A, P, R and T with equal patterns and values within
1e-10 of the largest (the energy minimisation sums in another order, see
``test_torch_energy``); on the nonsymmetric case, whose R from A^H holds
entries that cancel to rounding residues, an entry one side stores and the
other computes as 0 is allowed where it is within 1e-10 of the largest (one
at 6.6e-17 in R1); operator complexity to 1e-12; the solves' iteration
counts equal.  float32: rows equal, operator complexity to 1e-12, P within
1e-5 of the largest.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyamg_tpu.aggregation import rootnode_solver as ref_rootnode
from pyamg_tpu.gallery import advection_2d as ref_advection_2d
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson

from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import rootnode_solver
from pyamg_tpu_torch.gallery import advection_2d, linear_elasticity, poisson
from pyamg_tpu_torch.multilevel import MultilevelSolver

from test_torch_cycles import _coarse_spec, _ell, _smoother
from test_torch_energy import same_operator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_cpu(ml):
    """A twin of the host hierarchy ``ml`` placed on the CPU (``ml`` stays
    on the host)."""
    twin = MultilevelSolver([copy.copy(lvl) for lvl in ml.levels],
                            coarse_solver=copy.copy(ml.coarse_solver))
    twin.symmetric_smoothing = ml.symmetric_smoothing
    return twin.to_device("cpu")


def same_hierarchy(ml, mr, attrs=("A", "P", "R"), tol=1e-10, strict=True):
    """Equal rows and operator complexity; equal patterns of ``attrs`` with
    values within ``tol`` of the largest (not ``strict``: see
    ``same_operator``)."""
    assert [lvl.A.shape[0] for lvl in ml.levels] == \
        [int(lvl.A.shape[0]) for lvl in mr.levels]
    assert abs(ml.operator_complexity() - mr.operator_complexity()) <= 1e-12
    for lp, lr in zip(ml.levels, mr.levels):
        for attr in attrs:
            if getattr(lr, attr, None) is not None:
                same_operator(getattr(lp, attr), getattr(lr, attr), tol,
                              strict)


def iterations(ml, mr, accel, tol=1e-8):
    """(port's, JAX package's) iteration counts of one solve on a b from
    ``default_rng(0)``."""
    b = np.random.default_rng(0).standard_normal(ml.levels[0].A.shape[0])
    got, want = [], []
    on_cpu(ml).solve(b, tol=tol, maxiter=100, accel=accel, residuals=got)
    mr.solve(b, tol=tol, maxiter=100, accel=accel, residuals=want)
    return len(got) - 1, len(want) - 1


def _case(name):
    if name == "1d":
        return poisson((100,)), ref_poisson((100,)), {}, None
    if name in ("2d", "2d-symmetric"):
        kw = {"symmetry": "symmetric"} if name == "2d-symmetric" else {}
        return poisson((24, 24)), ref_poisson((24, 24)), kw, None
    if name == "nonsymmetric":
        return (advection_2d((16, 16))[0], ref_advection_2d((16, 16))[0],
                {"symmetry": "nonsymmetric"}, None)
    A, B = linear_elasticity((10, 10))
    Ar, _ = ref_elasticity((10, 10))
    return A, Ar, {}, B


CASES = ["1d", "2d", "2d-symmetric", "nonsymmetric", "block"]


@pytest.fixture(scope="module")
def hierarchies():
    out = {}
    for name in CASES:
        A, Ar, kw, B = _case(name)
        out[name] = (rootnode_solver(A, B=B, max_coarse=10, keep=True, **kw),
                     ref_rootnode(Ar, B=B, max_coarse=10, keep=True, **kw))
    return out


@pytest.mark.parametrize("name", CASES)
def test_hierarchy_matches_reference(hierarchies, name):
    ml, mr = hierarchies[name]
    assert len(ml.levels) >= 3
    same_hierarchy(ml, mr, ("A", "P", "R", "T", "C", "AggOp"),
                   strict=name != "nonsymmetric")
    for lp, lr in zip(ml.levels[:-1], mr.levels[:-1]):
        for attr in ("Cnodes", "Cpts", "Fpts"):
            np.testing.assert_array_equal(getattr(lp, attr),
                                          np.asarray(getattr(lr, attr)))
        np.testing.assert_allclose(lp.B, np.asarray(lr.B), rtol=0,
                                   atol=1e-10 * np.abs(lr.B).max())
        if name == "nonsymmetric":
            np.testing.assert_allclose(lp.BH, np.asarray(lr.BH), rtol=0,
                                       atol=1e-10 * np.abs(lr.BH).max())


@pytest.mark.parametrize("name", CASES)
def test_c_points_interpolate_by_injection(hierarchies, name):
    """P is the identity at the C-points: P[Cpts] = I, and with it R's
    columns at the C-points (the nonsymmetric R from RH too)."""
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    ml, _ = hierarchies[name]
    for lvl in ml.levels[:-1]:
        P = to_scipy(lvl.P).tocsr()
        R = to_scipy(lvl.R).tocsc()
        eye = np.eye(P.shape[1])
        np.testing.assert_array_equal(P[lvl.Cpts].toarray(), eye)
        np.testing.assert_array_equal(R[:, lvl.Cpts].toarray(), eye)


@pytest.mark.parametrize("name", CASES)
def test_solve_takes_the_reference_iterations(hierarchies, name):
    ml, mr = hierarchies[name]
    accel = "gmres" if name == "nonsymmetric" else "cg"
    got, want = iterations(ml, mr, accel)
    assert got == want < 100


def test_reference_hierarchy_through_arrays(hierarchies):
    """The JAX package's 24^2 hierarchy, handed over as plain arrays (A, P,
    R, B, Cpts, Fpts and the smoothers), solves as the JAX package does."""
    _, mr = hierarchies["2d"]
    levels = []
    for i, lvl in enumerate(mr.levels):
        d = {"A": _ell(lvl.A), "B": np.asarray(lvl.B)}
        if i < len(mr.levels) - 1:
            d.update(P=_ell(lvl.P), R=_ell(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post), Cpts=np.asarray(lvl.Cpts),
                     Fpts=np.asarray(lvl.Fpts))
        levels.append(d)
    ml = hierarchy_from_arrays({"levels": levels,
                                "coarse": _coarse_spec(mr.coarse_solver)},
                               device="cpu")
    np.testing.assert_array_equal(ml.levels[0].Cpts, mr.levels[0].Cpts)
    np.testing.assert_array_equal(ml.levels[1].B, mr.levels[1].B)
    b = np.random.default_rng(0).standard_normal(mr.levels[0].A.shape[0])
    got, want = [], []
    ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=got)
    mr.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=want)
    assert len(got) == len(want) < 100
    assert np.abs(np.subtract(got, want)).max() <= 1e-12 * want[0]


# -- float32: a JAX package fault the port does not copy ----------------------

FLOAT32_REFERENCE = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
from pyamg_tpu.aggregation import rootnode_solver
from pyamg_tpu.gallery import poisson
from pyamg_tpu.sparse.matrix import to_scipy
ml = rootnode_solver(poisson((24, 24)).astype(np.float32), max_coarse=10)
P = to_scipy(ml.levels[0].P).tocsr()
print(json.dumps({"rows": [int(l.A.shape[0]) for l in ml.levels],
                  "oc": float(ml.operator_complexity()),
                  "dtype": str(np.asarray(ml.levels[0].P.vals).dtype),
                  "indptr": P.indptr.tolist(), "indices": P.indices.tolist(),
                  "data": P.data.astype(float).tolist()}))
"""


def test_float32_hierarchy_matches_reference_without_x64():
    """With ``jax_enable_x64`` on, the JAX package's float32 root-node setup
    raises a TypeError in its minimisation (its scan starts from a float64
    sum, which promotes the iterate); with x64 off, as on a TPU, it builds
    576 / 102 / 12 / 2 rows.  The port runs the minimisation in the
    operator's dtype: its float32 hierarchy equals that one, and solves."""
    with pytest.raises(TypeError):
        ref_rootnode(ref_poisson((24, 24)).astype(np.float32), max_coarse=10)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", FLOAT32_REFERENCE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    ml = rootnode_solver(poisson((24, 24)).astype(np.float32), max_coarse=10)
    assert want["rows"] == [576, 102, 12, 2] == \
        [lvl.A.shape[0] for lvl in ml.levels]
    assert abs(ml.operator_complexity() - want["oc"]) <= 1e-12
    assert want["dtype"] == "float32" and ml.levels[0].P.vals.dtype == \
        np.float32 and all(lvl.A.vals.dtype == np.float32
                           for lvl in ml.levels)
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    P = to_scipy(ml.levels[0].P).tocsr()
    np.testing.assert_array_equal(P.indptr, want["indptr"])
    np.testing.assert_array_equal(P.indices, want["indices"])
    data = np.asarray(want["data"])
    assert np.abs(P.data - data).max() <= 1e-5 * np.abs(data).max()
    b = np.random.default_rng(0).standard_normal(576)
    res = []
    on_cpu(ml).solve(b, tol=1e-5, maxiter=50, accel="cg", residuals=res)
    assert res[-1] < 1e-5 * res[0] and len(res) - 1 < 20


@pytest.mark.parametrize("modname", ["pyamg_tpu_torch.aggregation.rootnode",
                                     "pyamg_tpu_torch.aggregation.pairwise"])
def test_examples_run(modname):
    import doctest
    import importlib
    results = doctest.testmod(importlib.import_module(modname),
                              optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
