"""The port's classical family (Ruge-Stuben and AIR) against the JAX
package's, on the CPU.

Held bit for bit (equal arrays): classical strength of connection (every
norm), every C/F splitting (RS with and without its second pass, PMIS,
PMISc, CLJP, CLJPc, MIS and CR), the maximal independent set and the
vertex colorings (JP, LDF, MIS), the direct, classical (modified and not),
injection and one-point interpolations, the strong F-F filter,
``filter_matrix_rows`` in every mode, ``binormalize`` and
``advection_2d``; and the whole setup of ``ruge_stuben_solver`` on 2-D
Poisson 48^2 and ``air_solver`` on ``advection_2d((32, 32))`` with and
without ``filter_operator``: the levels, the operator complexity, the
splittings and every A, P and R.  Both sides run the same float32 or
float64 arithmetic in the same order, so nothing less than equality is
asked.  lAIR's local solves are held to 1e-12 of the largest entry in
float64 (LAPACK's batched solve, and the batched dense GMRES that
``use_gmres`` runs in jnp there and in torch here).

Solves: the RS path (``solve_refined(accel="cg")``) and the AIR path
(``accel="gmres"``) take the JAX package's iterations, and the JAX
package's AIR hierarchy fed through ``hierarchy_from_arrays`` with its
splittings gives its F/C Jacobi V-cycle to 1e-12 in float64.  The
reference's own contracts are re-asserted on the port, and RS raises
rather than falls back when its native library cannot be built.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu import graph as ref_graph
from pyamg_tpu.classical import air_solver as ref_air
from pyamg_tpu.classical import interpolate as ref_itp
from pyamg_tpu.classical import ruge_stuben_solver as ref_rs
from pyamg_tpu.classical import split as ref_split
from pyamg_tpu.classical.cr import CR as ref_CR
from pyamg_tpu.classical.cr import binormalize as ref_binormalize
from pyamg_tpu.gallery import advection_2d as ref_advection_2d
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.strength import \
    classical_strength_of_connection as ref_classical_soc
from pyamg_tpu.util.utils import filter_matrix_rows as ref_filter_rows

from pyamg_tpu_torch import _native, air_solver, graph, hierarchy_from_arrays
from pyamg_tpu_torch import ruge_stuben_solver
from pyamg_tpu_torch.classical import interpolate as itp
from pyamg_tpu_torch.classical import split
from pyamg_tpu_torch.classical.cr import CR, binormalize
from pyamg_tpu_torch.gallery import advection_2d, poisson
from pyamg_tpu_torch.ops.rowops import drop_explicit_zeros, row_lookup
from pyamg_tpu_torch.sparse.matrix import ELL, from_scipy, to_scipy
from pyamg_tpu_torch.strength import (classical_strength_of_connection,
                                      strength_measure)
from pyamg_tpu_torch.util.utils import filter_matrix_rows

from test_torch_cycles import _ell, _smoother

torch.set_num_threads(1)


def _random_nonsymmetric(n=300, seed=3):
    """A nonsymmetric sparse matrix with about 9 entries a row of mixed
    sign and a dominant diagonal."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=8.0 / n, random_state=rng,
                  data_rvs=rng.standard_normal, format="csr")
    M = M + sp.diags_array(np.asarray(abs(M).sum(axis=1)).ravel() + 1.0)
    return sp.csr_matrix(M)


MATRICES = {
    "poisson": lambda: to_scipy(poisson((20, 20))),
    "advection": lambda: advection_2d((24, 24), format="csr")[0],
    "random": _random_nonsymmetric,
}


def _pair(S, dtype=np.float64):
    S = sp.csr_matrix(S).astype(dtype)
    return from_scipy(S), ref_from_scipy(S)


def _same(got, want):
    """Two ELL matrices with equal shape, row counts, columns and values."""
    assert tuple(got.shape) == tuple(want.shape)
    rn = np.asarray(want.row_nnz)
    np.testing.assert_array_equal(np.asarray(got.row_nnz), rn)
    mask = got.valid_mask()
    np.testing.assert_array_equal(np.asarray(got.cols)[mask],
                                  np.asarray(want.cols)[mask])
    gv, wv = np.asarray(got.vals)[mask], np.asarray(want.vals)[mask]
    assert gv.dtype == wv.dtype
    np.testing.assert_array_equal(gv, wv)


STRENGTH = [("abs", 0.25), ("min", 0.25), ("fro", 0.5), ("min", 0.3)]


@functools.cache
def _strength_of(name):
    """(port C, JAX C, port A, JAX A) of a matrix: classical strength,
    theta 0.25 'min' (0.3 for advection), float64."""
    A, Ar = _pair(MATRICES[name]())
    theta = 0.3 if name == "advection" else 0.25
    return (classical_strength_of_connection(A, theta=theta, norm="min"),
            ref_classical_soc(Ar, theta=theta, norm="min"), A, Ar)


@pytest.fixture(scope="module", params=sorted(MATRICES))
def strength(request):
    """(name, port C, JAX C, port A, JAX A)."""
    return (request.param,) + _strength_of(request.param)


# -- strength, row operations ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("norm,theta", STRENGTH)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_classical_strength_matches_reference(name, norm, theta, dtype):
    A, Ar = _pair(MATRICES[name](), dtype)
    C = classical_strength_of_connection(A, theta=theta, norm=norm)
    _same(C, ref_classical_soc(Ar, theta=theta, norm=norm))
    _same(strength_measure(A, ("classical", {"theta": theta, "norm": norm})),
          C)


def test_classical_strength_checks_its_input():
    A, _ = _pair(MATRICES["poisson"]())
    with pytest.raises(ValueError):
        classical_strength_of_connection(A, norm="max")
    # a block operator is measured on its blocks, as the reference does:
    # equal to the JAX package's block strength, every norm
    Sb = to_scipy(A).tobsr((2, 2))
    Ab, Abr = from_scipy(Sb), ref_from_scipy(Sb)
    for norm, theta in STRENGTH:
        _same(classical_strength_of_connection(Ab, theta=theta, norm=norm),
              ref_classical_soc(Abr, theta=theta, norm=norm))


def test_row_lookup_and_drop_explicit_zeros():
    S = _random_nonsymmetric(60)
    A = from_scipy(S)
    D = S.toarray()
    q = np.random.default_rng(1).integers(0, 60, (60, 7))
    np.testing.assert_array_equal(row_lookup(A, q),
                                  np.take_along_axis(D, q, axis=1))
    qvalid = q % 2 == 0
    np.testing.assert_array_equal(
        row_lookup(A, q, qvalid),
        np.where(qvalid, np.take_along_axis(D, q, axis=1), 0))
    Z = ELL(A.cols, np.where(np.abs(A.vals) < 0.5, 0.0, A.vals), A.row_nnz,
            A.shape)
    kept = to_scipy(drop_explicit_zeros(Z, tol=0.0))
    assert kept.nnz == np.count_nonzero(to_scipy(Z).data)
    np.testing.assert_array_equal(kept.toarray(), to_scipy(Z).toarray())


@pytest.mark.parametrize("lump", [False, True])
@pytest.mark.parametrize("diagonal", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_filter_matrix_rows_matches_reference(diagonal, lump, dtype):
    """On a matrix whose rows drop several entries each, so that the
    lumped mass is a sum of three or more terms."""
    A, Ar = _pair(_random_nonsymmetric(200, seed=7), dtype)
    for theta in (0.1, 0.4):
        got = filter_matrix_rows(A, theta, diagonal=diagonal, lump=lump)
        _same(got, ref_filter_rows(Ar, theta, diagonal=diagonal,
                                   lump=lump))
    assert got.nnz < A.nnz


# -- graph: maximal independent set and vertex coloring -------------------------

@pytest.mark.parametrize("method", ["JP", "LDF", "MIS"])
def test_vertex_coloring_matches_reference(strength, method):
    _, C, Cr, A, Ar = strength
    for G, Gr in ((C, Cr), (A, Ar)):
        colors = graph.vertex_coloring(G, method=method, seed=4)
        np.testing.assert_array_equal(
            colors, ref_graph.vertex_coloring(Gr, method=method, seed=4))
        S = to_scipy(G)
        S.setdiag(0)
        if (abs(S) != abs(S.T)).nnz == 0:     # a proper coloring where the
            i, j = S.nonzero()                # pattern is symmetric
            assert (colors[i] != colors[j]).all()


@pytest.mark.parametrize("k,weighted", [(1, False), (2, False), (1, True)])
def test_maximal_independent_set_matches_reference(strength, k, weighted):
    _, C, Cr, _, _ = strength
    w = np.random.default_rng(2).random(C.shape[0]) if weighted else None
    got = graph.maximal_independent_set(C, k=k, weights=w, seed=5)
    np.testing.assert_array_equal(
        got, ref_graph.maximal_independent_set(Cr, k=k, weights=w, seed=5))


# -- C/F splittings ------------------------------------------------------------

SPLITS = [("RS", {}), ("RS", {"second_pass": True}), ("PMIS", {}),
          ("PMISc", {}), ("PMISc", {"method": "LDF"}), ("CLJP", {}),
          ("CLJPc", {}), ("MIS", {})]


@pytest.mark.parametrize("spec", SPLITS,
                         ids=lambda s: s[0] + "".join(f"-{v}" for v in
                                                      s[1].values()))
def test_splitting_matches_reference(strength, spec):
    _, C, Cr, _, _ = strength
    for seed in (0, 3):
        got = split.split_dispatch(C, spec, seed=seed)
        want = ref_split.split_dispatch(Cr, spec, seed=seed)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_mis_with_weights_matches_reference(strength):
    _, C, Cr, _, _ = strength
    w = np.random.default_rng(8).random(C.shape[0])
    np.testing.assert_array_equal(split.MIS(C, w), ref_split.MIS(Cr, w))


def test_splitting_callable_and_unknown_name(strength):
    _, C, _, _, _ = strength
    np.testing.assert_array_equal(
        split.split_dispatch(C, (split.PMIS, {"seed": 2})),
        split.PMIS(C, seed=2))
    with pytest.raises(ValueError):
        split.split_dispatch(C, "XYZ")


@pytest.mark.parametrize("name", ["poisson", "random"])
def test_cr_matches_reference(name):
    A, Ar = _pair(MATRICES[name]())
    for method in ("habituated", "concurrent"):
        np.testing.assert_array_equal(CR(A, method=method),
                                      ref_CR(Ar, method=method))


def test_binormalize_matches_reference():
    A, Ar = _pair(_random_nonsymmetric(120, seed=9))
    got, want = to_scipy(binormalize(A)), to_scipy(ref_binormalize(Ar))
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_rs_raises_without_its_native_library(strength, monkeypatch):
    """No g++: RS and the classical interpolation raise; neither falls
    back to another algorithm (which would change the hierarchy)."""
    _, C, _, A, _ = strength
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    _native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            split.RS(C)
        splitting = split.PMIS(C)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            itp.classical_interpolation(A, C, splitting)
    finally:
        _native._lib.cache_clear()


# -- interpolation and restriction ----------------------------------------------

def _splittings(C, Cr):
    rs = split.RS(C)
    np.testing.assert_array_equal(rs, ref_split.RS(Cr))
    return {"RS": rs, "PMIS": split.PMIS(C)}


INTERP = [("direct", {}), ("classical", {"modified": True}),
          ("classical", {"modified": False}), ("injection", {}),
          ("one_point", {}), ("one_point", {"by_val": True}),
          ("direct", {"theta": 0.5}), ("classical", {"theta": 0.5})]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spec", INTERP,
                         ids=lambda s: s[0] + "".join(f"-{k}{v}" for k, v in
                                                      s[1].items()))
def test_interpolation_matches_reference(strength, spec, dtype):
    name, C, Cr, A, Ar = strength
    A, Ar = _pair(to_scipy(A), dtype)
    fn, kw = spec
    for which, splitting in _splittings(C, Cr).items():
        if fn == "injection":
            got = itp.injection_interpolation(A, splitting)
            want = ref_itp.injection_interpolation(Ar, splitting)
        else:
            got = getattr(itp, f"{fn}_interpolation")(A, C, splitting, **kw)
            want = getattr(ref_itp, f"{fn}_interpolation")(Ar, Cr,
                                                           splitting, **kw)
        _same(got, want)
        assert got.shape == (A.shape[0], int(splitting.sum()))


def test_remove_strong_ff_connections_matches_reference(strength):
    _, C, Cr, A, Ar = strength
    for splitting in _splittings(C, Cr).values():
        got = itp.remove_strong_FF_connections(A, C, splitting)
        _same(got, ref_itp.remove_strong_FF_connections(Ar, Cr, splitting))
        assert np.count_nonzero(got.vals) <= np.count_nonzero(C.vals)


LAIR = [("poisson", {}), ("advection", {}), ("random", {}),
        ("advection", {"degree": 2, "theta": 0.05}),
        ("random", {"degree": 2, "theta": 0.05}),
        ("poisson", {"use_gmres": True}), ("advection", {"use_gmres": True}),
        ("random", {"use_gmres": True}),
        ("advection", {"use_gmres": True, "maxiter": 0}),
        ("poisson", {"use_gmres": True, "precondition": False})]


@pytest.mark.parametrize("name,kw", LAIR, ids=lambda v: v if isinstance(
    v, str) else "-".join(f"{k}{x}" for k, x in v.items()) or "exact")
def test_local_air_matches_reference(name, kw):
    """float64; 1e-12 of the largest entry (batched solves)."""
    C, Cr, A, Ar = _strength_of(name)
    for splitting in _splittings(C, Cr).values():
        got = itp.local_air(A, splitting, **kw)
        want = ref_itp.local_air(Ar, splitting, **kw)
        assert got.shape == (int(splitting.sum()), A.shape[0])
        g, w = to_scipy(got), to_scipy(want)
        assert abs(g - w).max() <= 1e-12 * abs(w).max()


def test_block_and_complex_operators_raise(strength):
    _, C, _, A, _ = strength
    splitting = split.PMIS(C)
    Z = A.astype(np.complex128)
    for call in (lambda: itp.direct_interpolation(Z, C, splitting),
                 lambda: itp.classical_interpolation(Z, C, splitting),
                 lambda: itp.local_air(Z, splitting)):
        with pytest.raises(NotImplementedError):
            call()


def test_advection_matches_reference():
    for grid, kw in (((24, 24), {}), ((16, 20), {"theta": np.pi / 6,
                                                  "l_bdry": 2.0})):
        A, rhs = advection_2d(grid, **kw)
        Ar, rhs_r = ref_advection_2d(grid, **kw)
        _same(A, Ar)
        np.testing.assert_array_equal(rhs, np.asarray(rhs_r))
    S, _ = advection_2d((8, 8), format="csr")
    assert sp.issparse(S) and S.shape == (49, 49)


# -- the solvers -------------------------------------------------------------------

def _same_hierarchy(ml, mr):
    assert [l.A.shape for l in ml.levels] == \
        [tuple(l.A.shape) for l in mr.levels]
    assert ml.operator_complexity() == mr.operator_complexity()
    for lp, lr in zip(ml.levels, mr.levels):
        _same(lp.A, lr.A)
        if lr is mr.levels[-1]:
            continue
        np.testing.assert_array_equal(lp.splitting, lr.splitting)
        _same(lp.P, lr.P)
        _same(lp.R, lr.R)
    assert set(ml.setup_timings()) == set(mr.setup_timings())


RS_CASES = [{}, {"CF": "PMIS"}, {"CF": ("RS", {"second_pass": True})},
            {"CF": "CLJPc", "interpolation": "direct"},
            {"CF": "PMISc", "interpolation": "one_point"},
            {"CF": "MIS", "interpolation": ("classical",
                                            {"modified": False})},
            {"CF": "CR", "interpolation": "injection"}]


@pytest.mark.parametrize("kw", RS_CASES, ids=lambda kw: "-".join(
    str(v if isinstance(v, str) else v[0]) for v in kw.values()) or
    "default")
def test_ruge_stuben_hierarchy_matches_reference(kw):
    A64 = poisson((48, 48))
    ml = ruge_stuben_solver(A64.astype(np.float32), keep=True, **kw)
    mr = ref_rs(ref_from_scipy(to_scipy(A64)).astype(jnp.float32), **kw)
    assert len(ml.levels) >= 2
    _same_hierarchy(ml, mr)
    assert isinstance(ml.levels[0].C, ELL)


@pytest.mark.parametrize("filt", [None, (False, 0.1), (True, 0.1)],
                         ids=["unfiltered", "filtered", "lumped"])
@pytest.mark.parametrize("CF", ["PMIS", "RS"])
def test_air_hierarchy_matches_reference(filt, CF):
    A64, _ = advection_2d((32, 32))
    S = to_scipy(A64)
    ml = air_solver(A64.astype(np.float32), CF=CF, filter_operator=filt)
    mr = ref_air(ref_from_scipy(S).astype(jnp.float32), CF=CF,
                 filter_operator=filt)
    assert len(ml.levels) > 2
    _same_hierarchy(ml, mr)
    for lp, lr in zip(ml.levels[:-1], mr.levels[:-1]):
        np.testing.assert_array_equal(lp.Cpts, np.asarray(lr.Cpts))
        np.testing.assert_array_equal(lp.Fpts, np.asarray(lr.Fpts))
        assert lp.post[0] == "fc_jacobi"


def _inner_counts(ml):
    counts = []
    solve = ml.solve

    def counted(b, **kw):
        res = kw.pop("residuals", [])     # the port passes a list of its own
        x = solve(b, residuals=res, **kw)
        counts.append(len(res) - 1)
        return x

    ml.solve = counted
    return counts


@pytest.mark.parametrize("path", ["RS", "AIR"])
def test_solve_takes_the_reference_iterations(path):
    """RS on 2-D Poisson 48^2 with CG, AIR on advection 32^2 with GMRES:
    ``solve_refined`` to 1e-10 as ``bench_suite.py`` runs them, the same
    outer and inner counts as the JAX package."""
    if path == "RS":
        A64 = poisson((48, 48))
        b = np.random.default_rng(0).standard_normal(A64.shape[0])
        build = (ruge_stuben_solver, ref_rs)
        kw = {"accel": "cg"}
    else:
        A64, b = advection_2d((32, 32))
        build = (lambda A: air_solver(A, CF="PMIS",
                                      filter_operator=(False, 0.1)),
                 lambda A: ref_air(A, CF="PMIS",
                                   filter_operator=(False, 0.1)))
        kw = {"accel": "gmres", "inner_maxiter": 40, "max_outer": 20}
    S = to_scipy(A64)
    ml = build[0](A64.astype(np.float32)).compress_stencils()
    ml.to_device("cpu")
    mr = build[1](ref_from_scipy(S).astype(jnp.float32))
    mr.compress_stencils()
    got_in, want_in = _inner_counts(ml), _inner_counts(mr)
    it = {}
    x = ml.solve_refined(b, A_fine=S, tol=1e-10, iterations_out=it, **kw)
    mr.solve_refined(b, A_fine=S, tol=1e-10, **kw)
    assert it["outer"] == len(want_in) == 2
    assert got_in == want_in
    assert np.linalg.norm(b - S @ x) / np.linalg.norm(b) < 1e-10


def _air_spec(mr, with_masks):
    levels = []
    for i, lvl in enumerate(mr.levels):
        d = {"A": _ell(lvl.A)}
        if i < len(mr.levels) - 1:
            d.update(P=_ell(lvl.P), R=_ell(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post),
                     splitting=np.asarray(lvl.splitting))
            if not with_masks:
                for k in ("Cmask", "Fmask"):
                    d["post"].pop(k)
        levels.append(d)
    return {"levels": levels,
            "coarse": {"kind": "pinv",
                       "op": np.asarray(mr.coarse_solver.params["op"])}}


@pytest.mark.parametrize("with_masks", [False, True],
                         ids=["from-splitting", "masks-given"])
def test_reference_air_hierarchy_through_hierarchy_from_arrays(with_masks):
    """The JAX package's float64 AIR hierarchy (F/C Jacobi post-smoothing)
    in the port: one V-cycle to 1e-12 of max |x|, and the same GMRES
    iterations."""
    A64, b = advection_2d((32, 32))
    mr = ref_air(ref_from_scipy(to_scipy(A64)), CF="PMIS")
    ml = hierarchy_from_arrays(_air_spec(mr, with_masks), device="cpu")
    for lp, lr in zip(ml.levels[:-1], mr.levels[:-1]):
        np.testing.assert_array_equal(lp.splitting, lr.splitting)
        np.testing.assert_array_equal(lp.post[2]["Cmask"].numpy(),
                                      lr.splitting)
    n = A64.shape[0]
    x0 = np.random.default_rng(1).standard_normal(n)
    want = np.asarray(mr._make_cycle("V")(mr._dyn(), jnp.asarray(x0),
                                          jnp.asarray(b)))
    got = ml._make_cycle("V")(torch.as_tensor(x0), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    res_p, res_r = [], []
    ml.solve(b, tol=1e-8, accel="gmres", residuals=res_p)
    mr.solve(jnp.asarray(b), tol=1e-8, accel="gmres", residuals=res_r)
    assert len(res_p) == len(res_r)


def test_fc_jacobi_needs_masks_or_a_splitting():
    A64, _ = advection_2d((16, 16))
    mr = ref_air(ref_from_scipy(to_scipy(A64)), CF="PMIS")
    spec = _air_spec(mr, with_masks=False)
    spec["levels"][0].pop("splitting")
    with pytest.raises(ValueError, match="splitting"):
        hierarchy_from_arrays(spec, device="cpu")


# -- the reference's own contracts ---------------------------------------------

def test_rs_convergence_factor():
    """``tests/test_classical.py:134-145``: factor < 0.20 on 32^2."""
    A = poisson((32, 32))
    ml = ruge_stuben_solver(A, max_coarse=40)
    ml.to_device("cpu")
    n = A.shape[0]
    res = []
    ml.solve(np.zeros(n), x0=np.random.default_rng(0).standard_normal(n),
             maxiter=20, tol=1e-12, residuals=res)
    factor = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
    assert factor < 0.20


def test_lair_two_level_exactness_on_1d_advection():
    """``tests/test_classical.py:172-183``: lAIR makes a two-level solve of
    bidiagonal upwind advection exact."""
    n = 64
    A = sp.diags_array([np.ones(n), -np.ones(n - 1)], offsets=[0, -1]).tocsr()
    ml = air_solver(from_scipy(A), max_coarse=8)
    ml.to_device("cpu")
    res = []
    ml.solve(np.zeros(n), x0=np.random.default_rng(2).standard_normal(n),
             maxiter=4, tol=1e-14, residuals=res)
    assert res[1] < 1e-12


def test_air_filtered_operator_complexity():
    """``tests/test_classical.py:298-320``: PMIS and the filter keep AIR's
    operator complexity at most 2.05 on 64^2, solved to 1e-9 in at most 4
    outer steps."""
    A64, rhs = advection_2d((64, 64))
    S = to_scipy(A64)
    ml = air_solver(A64.astype(np.float32), CF="PMIS",
                    filter_operator=(False, 0.1))
    assert ml.operator_complexity() <= 2.05
    ml.compress_stencils().to_device("cpu")
    res = []
    x = ml.solve_refined(rhs, A_fine=S, tol=1e-9, accel="gmres",
                         inner_maxiter=40, max_outer=20, residuals=res)
    assert np.linalg.norm(rhs - S @ x) / np.linalg.norm(rhs) < 1e-9
    assert len(res) - 1 <= 4


@pytest.mark.parametrize("modname", ["pyamg_tpu_torch.classical.classical",
                                     "pyamg_tpu_torch.classical.air"])
def test_examples_run(modname):
    import doctest
    import importlib
    results = doctest.testmod(importlib.import_module(modname),
                              optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
