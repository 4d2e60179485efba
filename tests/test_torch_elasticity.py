"""The port's 2-D linear elasticity path (BASELINE config 4) against the JAX
package's, on the CPU: ``gallery/elasticity.py``, ``fit_candidates`` with
several candidates, Jacobi smoothing of a block prolongator, the block
smoothers and their setups, the whole smoothed-aggregation hierarchy on
BELL levels with its ``solve_refined``, and one V-cycle of the JAX
package's float64 hierarchy fed through ``hierarchy_from_arrays``.

Tolerances: the gallery, the tentative prolongator (T and Bc), the
smoother setups and the host sweeps run the same numpy/scipy arithmetic as
the JAX package's host paths and are held equal.  Jacobi smoothing of a
block P: equal pattern, values within 1e-12 of the largest in float64
and 1e-6 in float32 (the reference scales in jnp and merges X - Y through
running sums; the port adds each column's two blocks).  The sweeps as
torch ops and the V-cycle: 1e-12 of the largest entry in float64.  The
hierarchy: rows, blocksizes and layouts equal, operator complexity to
1e-12; the solve: the JAX package's outer count exactly, each inner count
within 1, and a true relative residual below 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.aggregation.smooth import \
    jacobi_prolongation_smoother as ref_jacobi_smoother
from pyamg_tpu.aggregation.tentative import fit_candidates as ref_fit
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import linear_elasticity_p1 as ref_elasticity_p1
from pyamg_tpu.relaxation import relaxation as ref_rx
from pyamg_tpu.relaxation.smoothing import make_smoother as ref_make
from pyamg_tpu.sparse.matrix import ELL as RefELL
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy

from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
from pyamg_tpu_torch.aggregation.smooth import (_bell_sub,
                                                jacobi_prolongation_smoother)
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.gallery import linear_elasticity, linear_elasticity_p1
from pyamg_tpu_torch.multilevel import _put
from pyamg_tpu_torch.relaxation import relaxation as rx
from pyamg_tpu_torch.relaxation.smoothing import apply_smoother, make_smoother
from pyamg_tpu_torch.sparse.matrix import BELL, ELL, from_scipy, to_scipy
from pyamg_tpu_torch.strength import symmetric_strength_of_connection

from test_torch_bell import _same_bell
from test_torch_cycles import _coarse_spec, _smoother
from test_torch_relaxation import forbid_host_reads

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


# -- gallery/elasticity.py -----------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"spacing": (0.5, 2.0)},
                                {"E": 3.0, "nu": 0.25}])
@pytest.mark.parametrize("grid", [(4, 4), (7, 5), (1, 3)])
def test_linear_elasticity_matches_reference(grid, kw):
    A, B = linear_elasticity(grid, **kw)
    Ar, Br = ref_elasticity(grid, **kw)
    _same_bell(A, Ar)
    np.testing.assert_array_equal(B, Br)
    S, _ = linear_elasticity(grid, format="csr", **kw)
    assert S.format == "csr"
    np.testing.assert_array_equal(S.toarray(), to_scipy(A).toarray())


def test_linear_elasticity_checks_its_grid():
    with pytest.raises(NotImplementedError):
        linear_elasticity((3, 3, 3))
    with pytest.raises(ValueError):
        linear_elasticity((0, 3))


def _tet_mesh():
    """Two tetrahedra sharing a face, and a unit square of two triangles."""
    V3 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1.]])
    E3 = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    V2 = np.array([[0, 0], [1, 0], [0, 1], [1, 1.]])
    E2 = np.array([[0, 1, 2], [1, 3, 2]])
    return (V2, E2), (V3, E3)


@pytest.mark.parametrize("dim", [2, 3])
def test_linear_elasticity_p1_matches_reference(dim):
    V, E = _tet_mesh()[dim - 2]
    A, B = linear_elasticity_p1(V, E, E=10.0, nu=0.2)
    Ar, Br = ref_elasticity_p1(V, E, E=10.0, nu=0.2)
    _same_bell(A, Ar)
    np.testing.assert_array_equal(B, Br)
    with pytest.raises(ValueError):
        linear_elasticity_p1(V, E[:, :dim])


# -- fit_candidates ------------------------------------------------------------

def _aggregation(N=6):
    """(elasticity A, B, its node aggregation, the JAX package's AggOp)."""
    A, B = linear_elasticity((N, N))
    AggOp, _ = standard_aggregation(symmetric_strength_of_connection(A))
    ref_agg = RefELL(AggOp.cols, AggOp.vals, AggOp.row_nnz, AggOp.shape)
    return A, B, AggOp, ref_agg


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["rigid", "deficient", "two_scalar",
                                  "one_scalar"])
def test_fit_candidates_matches_reference(case, dtype):
    A, B, AggOp, ref_agg = _aggregation()
    if case == "deficient":
        # the rotation is a translation on the first aggregate's nodes:
        # its column falls below tol there and is dropped
        first = np.flatnonzero(AggOp.cols[:, 0] == 0)
        B = B.copy()
        for node in first:
            B[2 * node:2 * node + 2, 2] = B[2 * node:2 * node + 2, 0]
    elif case == "two_scalar":
        B = B[0::2, :2]             # 2 candidates on scalar nodes
    elif case == "one_scalar":
        B = B[0::2, 0]
    B = B.astype(dtype)
    T, Bc = fit_candidates(AggOp, B)
    Tr, Bcr = ref_fit(ref_agg, B)
    np.testing.assert_array_equal(Bc, np.asarray(Bcr))
    if case == "one_scalar":
        assert isinstance(T, ELL)
        np.testing.assert_array_equal(T.vals, np.asarray(Tr.vals))
        np.testing.assert_array_equal(T.cols, np.asarray(Tr.cols))
        return
    assert isinstance(T, BELL)
    _same_bell(T, Tr)
    if case == "deficient":
        assert Bc[2, 2] == 0 and not T.vals[first, 0, :, 2].any()
    # B = T Bc on the aggregated rows, T's columns orthonormal
    St = to_scipy(T).toarray()
    _close(St @ Bc, B.reshape(St.shape[0], -1), 100 * TOL[dtype])
    if case == "rigid":
        _close(St.T @ St, np.eye(St.shape[1]), 100 * TOL[dtype])


# -- Jacobi smoothing of a block prolongator -----------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("case", ["block", "scalar_operator"])
def test_jacobi_smoothing_of_a_block_prolongator(case, degree, dtype):
    A, B, AggOp, ref_agg = _aggregation()
    if case == "scalar_operator":
        A = from_scipy(to_scipy(A).tocsr()[0::2, 0::2])
        Ar = ref_from_scipy(to_scipy(A))
        B = B[0::2, :2]
    else:
        Ar = ref_from_scipy(to_scipy(A))
    A, Ar = A.astype(dtype), Ar.astype(dtype)
    B = B.astype(dtype)
    T, Bc = fit_candidates(AggOp, B)
    Tr, _ = ref_fit(ref_agg, B)
    P = jacobi_prolongation_smoother(A, T, None, Bc, degree=degree)
    Pr = ref_jacobi_smoother(Ar, Tr, None, Bc, degree=degree)
    assert isinstance(P, BELL) and P.blocksize == tuple(Pr.blocksize)
    np.testing.assert_array_equal(P.row_nnz, np.asarray(Pr.row_nnz))
    mask = P.valid_mask()
    np.testing.assert_array_equal(P.cols[mask], np.asarray(Pr.cols)[mask])
    assert P.vals.dtype == np.asarray(Pr.vals).dtype
    _close(P.vals, np.asarray(Pr.vals), TOL[dtype])


def test_bell_sub_is_the_difference():
    A, B, AggOp, _ = _aggregation()
    T, _ = fit_candidates(AggOp, B)
    X = from_scipy(sp.bsr_matrix(to_scipy(A) @ to_scipy(T),
                                 blocksize=(2, 3)))
    D = _bell_sub(T, X)
    np.testing.assert_array_equal(
        to_scipy(D).toarray(), to_scipy(T).toarray() - to_scipy(X).toarray())
    assert list(D.cols[0, :D.row_nnz[0]]) == \
        sorted(D.cols[0, :D.row_nnz[0]])


# -- block smoothers -----------------------------------------------------------

def _system(N=5, seed=7):
    A, _ = linear_elasticity((N, N))
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    return A, ref_from_scipy(to_scipy(A)), rng.standard_normal(n), \
        rng.standard_normal(n), rng.standard_normal((n, 2))


def _cases(A, rows):
    """(name, port call, JAX call) of every block sweep of the test."""
    colors, nc = rx.make_coloring(rx.block_pattern(A))
    idx = np.arange(0, A.n_block_rows, 3)
    mask = np.zeros(A.n_block_rows, bool)
    mask[idx] = True
    out = [("block_jacobi", dict(iterations=2, omega=0.7),
            "block_jacobi", ())]
    for sweep in ("forward", "backward", "symmetric"):
        for omega, it in ((1.0, 1), (0.9, 2)):
            out.append((f"block_gauss_seidel_{sweep}_{omega}",
                        dict(iterations=it, sweep=sweep, colors=colors,
                             ncolors=nc, omega=omega),
                        "block_gauss_seidel", ()))
    out.append(("indexed_by_index", dict(iterations=2, omega=0.8),
                "block_jacobi_indexed", (idx,)))
    out.append(("indexed_by_mask", dict(iterations=1), "block_jacobi_indexed",
                (mask,)))
    for kind in ("cf_block_jacobi", "fc_block_jacobi"):
        out.append((kind, dict(iterations=2, c_iterations=2, omega=0.9),
                    kind, (mask, ~mask)))
    return out


@pytest.mark.parametrize("columns", [1, 2])
@pytest.mark.parametrize("case", range(11))
def test_block_sweeps_match_reference(case, columns):
    A, Ar, x, b, X = _system()
    name, kw, fn, extra = _cases(A, None)[case]
    if columns == 2:
        x, b = X, X[::-1].copy()
    want = getattr(ref_rx, fn)(Ar, x, b, *extra, **kw)
    # host: the same numpy and scipy arithmetic
    got = getattr(rx, fn)(A, x, b, *extra, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    # torch ops on CPU tensors
    kw_t = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    extra_t = tuple(torch.as_tensor(e) for e in extra)
    got_t = getattr(rx, fn)(A.to("cpu"), torch.as_tensor(x),
                            torch.as_tensor(b), *extra_t, **kw_t)
    _close(got_t.numpy(), np.asarray(want), TOL[np.float64])


def test_block_smoothers_take_only_a_bell():
    A, _, x, b, _ = _system()
    with pytest.raises(TypeError):
        rx.block_jacobi(from_scipy(to_scipy(A).tocsr()), x, b)
    with pytest.raises(ValueError):
        rx.block_gauss_seidel(A, x, b, sweep="sideways")


SETUPS = [("gauss_seidel", {"sweep": "symmetric", "iterations": 2}),
          ("block_gauss_seidel", {"sweep": "forward"}),
          ("sor", {"omega": 1.3, "sweep": "backward"}),
          ("block_jacobi", {"omega": 0.8}),
          ("block_jacobi", {"omega": 0.8, "withrho": False}),
          ("cf_block_jacobi", {"iterations": 2}),
          ("fc_block_jacobi", {"c_iterations": 2})]


def _level(A):
    import types
    split = np.zeros(A.n_block_rows, np.int32)
    split[::4] = 1
    return types.SimpleNamespace(splitting=np.repeat(split, 2))


@pytest.mark.parametrize("spec", SETUPS, ids=[s[0] + str(i)
                                              for i, s in enumerate(SETUPS)])
def test_block_smoother_setups_match_reference(spec):
    A, Ar, x, b, _ = _system()
    level = _level(A)
    kind, sopts, params = make_smoother(level, A, spec)
    rkind, rsopts, rparams = ref_make(level, Ar, spec)
    assert kind == rkind and sopts == rsopts
    assert set(params) == set(rparams)
    for k in params:
        if np.isscalar(params[k]):
            assert params[k] == pytest.approx(rparams[k], rel=1e-12)
        else:
            np.testing.assert_array_equal(params[k], np.asarray(rparams[k]))
    from pyamg_tpu.relaxation.smoothing import apply_smoother as ref_apply
    want = np.asarray(ref_apply(rkind, rsopts, rparams, Ar, x, b))
    np.testing.assert_array_equal(
        apply_smoother(kind, sopts, params, A, x, b), want)
    got = apply_smoother(kind, sopts, _put(params, "cpu"), A.to("cpu"),
                         torch.as_tensor(x), torch.as_tensor(b))
    _close(got.numpy(), want, TOL[np.float64])


@pytest.mark.parametrize("columns", [1, 2])
def test_block_smoothers_read_nothing_on_the_host(columns, monkeypatch):
    A, _, x, b, X = _system()
    level = _level(A)
    smoothers = [make_smoother(level, A, spec) for spec in SETUPS]
    smoothers = [(k, s, _put(p, "cpu")) for k, s, p in smoothers]
    op = A.to("cpu")
    if columns == 2:
        x, b = X, X[::-1].copy()
    x, b = torch.as_tensor(x), torch.as_tensor(b)
    forbid_host_reads(monkeypatch)
    for sm in smoothers:
        x = apply_smoother(*sm, op, x, b)
    monkeypatch.undo()
    assert bool(torch.isfinite(x).all())


# -- the hierarchy and the solve (BASELINE config 4 at 24^2) -------------------

SOLVE = dict(tol=1e-10, inner_maxiter=60, max_outer=20)


@pytest.fixture(scope="module")
def hierarchies():
    A, B = linear_elasticity((24, 24))
    Ar, Br = ref_elasticity((24, 24))
    ml = smoothed_aggregation_solver(A.astype(np.float32), B=B,
                                     max_coarse=50)
    mr = ref_sa(Ar.astype(jnp.float32), B=np.asarray(Br), max_coarse=50)
    return A, ml.compress_stencils(), mr.compress_stencils()


def test_elasticity_hierarchy_matches_reference(hierarchies):
    _, ml, mr = hierarchies
    assert [l.A.shape[0] for l in ml.levels] == \
        [int(l.A.shape[0]) for l in mr.levels] == [1152, 192, 27]
    assert [l.A.blocksize for l in ml.levels] == \
        [tuple(l.A.blocksize) for l in mr.levels] == \
        [(2, 2), (3, 3), (3, 3)]
    assert abs(ml.operator_complexity() - mr.operator_complexity()) <= 1e-12
    layouts = [tuple(type(getattr(l, a, None)).__name__ for a in "APR")
               for l in ml.levels]
    assert layouts == [tuple(type(getattr(l, a, None)).__name__
                             for a in "APR") for l in mr.levels] == \
        [("BELL", "BELL", "BELL")] * 2 + [("BELL", "NoneType", "NoneType")]
    for lp, lr in zip(ml.levels, mr.levels):
        a, r = to_scipy(lp.A).toarray(), ref_to_scipy(lr.A).toarray()
        _close(a, r, TOL[np.float32])
        assert lp.pre[0] == lr.pre[0] == "block_gauss_seidel" or \
            lp is ml.levels[-1]
    assert set(ml.setup_timings()) == set(mr.setup_timings())


def test_elasticity_solve_takes_the_reference_iterations(hierarchies):
    A, ml, mr = hierarchies
    S = to_scipy(A).tocsr()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    ml.to_device("cpu")
    it = {}
    x = ml.solve_refined(b, A_fine=S, iterations_out=it, **SOLVE)
    inner = []
    solve = mr.solve

    def counted(rhs, **kw):
        res = []
        out = solve(rhs, residuals=res, **kw)
        inner.append(len(res) - 1)
        return out

    mr.solve = counted
    hist = []
    mr.solve_refined(b, A_fine=S, residuals=hist, **SOLVE)
    assert it["outer"] == len(hist) - 1 == 2
    assert len(it["inner"]) == len(inner) and \
        all(abs(a - c) <= 1 for a, c in zip(it["inner"], inner))
    assert np.linalg.norm(b - S @ x) / np.linalg.norm(b) < 1e-10
    twin = ml.as_dtype(torch.float64)
    assert all(isinstance(l.A, BELL) and l.A.vals.dtype == torch.float64
               for l in twin.levels)
    assert twin.levels[0].pre[2]["Dinv"].dtype == torch.float64
    assert twin.levels[0].pre[2]["colors"].dtype == torch.int32


# -- the JAX package's float64 hierarchy through hierarchy_from_arrays ---------

def _bell(op):
    return {"cols": np.asarray(op.cols), "vals": np.asarray(op.vals),
            "row_nnz": np.asarray(op.row_nnz), "shape": tuple(op.shape),
            "blocksize": tuple(op.blocksize)}


PRE = [("block_gauss_seidel", {"sweep": "symmetric"}),
       ("block_jacobi", {"omega": 0.8})]
POST = [("block_gauss_seidel", {"sweep": "symmetric"}),
        ("sor", {"omega": 1.2, "sweep": "backward"})]


@pytest.mark.parametrize("coarse", ["pinv", "block_gauss_seidel"])
@pytest.mark.parametrize("smoothers", ["default", "mixed"])
def test_reference_hierarchy_cycles_alike(smoothers, coarse):
    Ar, Br = ref_elasticity((12, 12))
    kw = dict(presmoother=PRE, postsmoother=POST) if smoothers == "mixed" \
        else {}
    mr = ref_sa(Ar, B=np.asarray(Br), max_coarse=10, coarse_solver=coarse,
                **kw)
    assert len(mr.levels) >= 3
    levels = []
    for i, lvl in enumerate(mr.levels):
        d = {"A": _bell(lvl.A)}
        if i < len(mr.levels) - 1:
            d.update(P=_bell(lvl.P), R=_bell(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post))
        levels.append(d)
    ml = hierarchy_from_arrays({"levels": levels,
                                "coarse": _coarse_spec(mr.coarse_solver)},
                               device="cpu")
    rng = np.random.default_rng(11)
    b = rng.standard_normal(Ar.shape[0])
    want = np.asarray(mr.aspreconditioner().matvec(jnp.asarray(b)))
    got = ml.psolve(b).numpy()
    _close(got, want, TOL[np.float64])
    # the cycle reads nothing on the host (what a captured solve needs)
    cycle, bt = ml._make_cycle("V"), torch.as_tensor(b)
    with pytest.MonkeyPatch.context() as mp:
        forbid_host_reads(mp)
        again = cycle(torch.zeros_like(bt), bt)
    _close(again.numpy(), want, TOL[np.float64])
    res_r, res_p = [], []
    mr.solve(b, tol=1e-8, maxiter=20, accel="cg", residuals=res_r)
    ml.solve(b, tol=1e-8, maxiter=20, accel="cg", residuals=res_p)
    assert len(res_p) == len(res_r)
