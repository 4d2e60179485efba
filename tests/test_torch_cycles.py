"""The port's multigrid cycles, coarse solvers and solve against the JAX
package's, on the CPU.

The JAX package builds one float64 grid-SA hierarchy of 2-D Poisson 32^2
(ELL levels) with a different smoother pair on each level; the port gets
it through ``hierarchy_from_arrays``, every smoother descriptor and coarse
solver carried over.  Then, from the same x and b:

* one V, W, F and AMLI cycle with ``cycles_per_level`` 1 and 2, and one
  V-cycle with each coarse solver kind: float64 relative 1e-12;
* ``solve`` with each ``accel`` (and a callable) and standalone cycling:
  equal iteration counts and ``info``, x and the residual history to
  1e-8 relative;
* the complexities and ``__repr__`` of the port's own setup, and
  ``symmetric_smoothing`` with the CG warning, for the pairs the
  reference flags.

Held against the port's own paths, not the reference's: standalone
cycling that converges on its last allowed cycle returns ``info`` 0, and
``change_solve_matrix`` rebuilds each smoother from its user spec (or
raises).
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu import krylov as ref_krylov
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.multilevel import coarse_grid_solver as ref_coarse
from pyamg_tpu.relaxation.smoothing import change_smoothers as ref_change

from pyamg_tpu_torch import hierarchy_from_arrays, krylov
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.multilevel import CoarseSolver, coarse_grid_solver
from pyamg_tpu_torch.relaxation.smoothing import make_smoother
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy

from test_torch_relaxation import forbid_host_reads

torch.set_num_threads(1)

N = 32
PRE = [("sor", {"omega": 1.2, "sweep": "forward"}),
       ("chebyshev", {"degree": 2}), ("jacobi", {"omega": 0.8})]
POST = [("sor", {"omega": 1.2, "sweep": "backward"}),
        ("gauss_seidel", {"sweep": "symmetric", "iterations": 2}),
        ("jacobi", {"omega": 0.8})]


def _vec(seed, n):
    return np.random.default_rng(seed).standard_normal(n)


def _ref_custom(A, b):
    return 0.5 * b


def _port_custom(A, b):
    return 0.5 * b


COARSE = ["pinv", "pinv2", "lu", "splu", "cholesky", "jacobi",
          ("gauss_seidel", {"iterations": 3}), "block_gauss_seidel", "none",
          "cg", ("gmres", {"maxiter": 4}), "custom"]


def _coarse_id(kind):
    return kind[0] if isinstance(kind, tuple) else kind


# -- the reference's hierarchy as plain arrays ---------------------------------

def _ell(op):
    return {"cols": np.asarray(op.cols), "vals": np.asarray(op.vals),
            "row_nnz": np.asarray(op.row_nnz), "shape": tuple(op.shape)}


def _ref_order(sopts):
    """The color passes the JAX package's ``gauss_seidel`` sweeps on an
    ELL level (``pyamg_tpu/relaxation/relaxation.py:159-179``)."""
    fwd = list(range(int(sopts["ncolors"])))
    seq = {"forward": fwd, "backward": fwd[::-1],
           "symmetric": fwd + fwd[::-1]}[sopts["sweep"]]
    order = seq * int(sopts["iterations"])
    if float(sopts["omega"]) == 1.0 and len(order) > 1:
        order = [order[0]] + [c for i, c in enumerate(order[1:])
                              if c != order[i]]
    return order


def _smoother(sm):
    kind, sopts, params = sm
    d = {"kind": kind, "opts": dict(sopts)}
    for k, v in params.items():
        d[k] = _ell(v) if k == "AH" else \
            v if np.isscalar(v) or callable(v) else np.asarray(v)
    if kind == "gauss_seidel":
        d["order"] = _ref_order(sopts)
    return d


def _coarse_spec(cs):
    kind, p = cs.kind, cs.params
    if callable(kind):
        return {"kind": _port_custom}
    if kind in ("pinv", "pinv2"):
        return {"kind": kind, "op": np.asarray(p["op"])}
    if kind in ("lu", "splu"):
        return {"kind": kind, "lu": np.asarray(p["lu"]),
                "piv": np.asarray(p["piv"])}
    if kind == "cholesky":
        return {"kind": kind, "c": np.asarray(p["c"]),
                "lower": cs._cho_lower}
    if kind in ("cg", "gmres"):
        return {"kind": kind, "maxiter": p["maxiter"]}
    return {"kind": kind, "smoother": _smoother(
        cs._smoother_static + (p["smoother_params"],))}


def _spec(ml):
    levels = []
    for i, lvl in enumerate(ml.levels):
        d = {"A": _ell(lvl.A)}
        if i < len(ml.levels) - 1:
            d.update(P=_ell(lvl.P), R=_ell(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post))
        levels.append(d)
    return {"levels": levels, "coarse": _coarse_spec(ml.coarse_solver)}


@pytest.fixture(scope="module")
def ref():
    ml = ref_sa(ref_poisson((N, N)), aggregate=("grid", {}), max_coarse=10,
                presmoother=PRE, postsmoother=POST)
    assert len(ml.levels) == 4
    return ml


@pytest.fixture(scope="module")
def port(ref):
    return hierarchy_from_arrays(_spec(ref), device="cpu")


def _with_coarse(ref, kind):
    ref.coarse_solver = ref_coarse(_ref_custom if kind == "custom" else kind)
    ref.coarse_solver.setup(ref.levels[-1].A)
    ref._cycle_cache.clear()
    return hierarchy_from_arrays(_spec(ref), device="cpu")


@pytest.fixture
def restore_coarse(ref):
    old = ref.coarse_solver
    yield
    ref.coarse_solver = old
    ref._cycle_cache.clear()


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


# -- cycles and coarse solvers ---------------------------------------------------

@pytest.mark.parametrize("cycles_per_level", [1, 2])
@pytest.mark.parametrize("cycle", ["V", "W", "F", "AMLI"])
def test_one_cycle_matches_reference(ref, port, cycle, cycles_per_level):
    n = ref.levels[0].A.shape[0]
    x, b = _vec(1, n), _vec(2, n)
    want = ref._make_cycle(cycle, cycles_per_level)(
        ref._dyn(), jnp.asarray(x), jnp.asarray(b))
    got = port._make_cycle(cycle, cycles_per_level)(torch.as_tensor(x),
                                                    torch.as_tensor(b))
    _close(got, want, 1e-12)


def test_cycle_kind_is_checked(port):
    with pytest.raises(TypeError):
        port._make_cycle("X")


@pytest.mark.parametrize("kind", COARSE, ids=_coarse_id)
def test_coarse_solver_matches_reference(ref, kind, restore_coarse):
    ml = _with_coarse(ref, kind)
    Ac = ref.levels[-1].A
    bc = _vec(3, Ac.shape[0])
    want = ref.coarse_solver(Ac, jnp.asarray(bc))
    got = ml.coarse_solver(ml.levels[-1].A, torch.as_tensor(bc))
    _close(got, want, 1e-12)
    n = ref.levels[0].A.shape[0]
    b = _vec(4, n)
    want = ref._make_cycle("V")(ref._dyn(), jnp.zeros(n), jnp.asarray(b))
    got = ml._make_cycle("V")(torch.zeros(n, dtype=torch.float64),
                              torch.as_tensor(b))
    _close(got, want, 1e-12)


def _dense_ell(M):
    return from_scipy(sp.csr_matrix(M))


def test_lu_pivots_become_the_factors_row_order():
    """A matrix that needs row interchanges: scipy's 0-based pivots become
    the row order of the factors, A[perm] = L U, and the solve is exact."""
    import scipy.linalg
    rng = np.random.default_rng(5)
    M = rng.standard_normal((30, 30))
    lu, piv = scipy.linalg.lu_factor(M)
    assert np.any(piv != np.arange(30))
    cs = coarse_grid_solver("lu")
    assert isinstance(cs, CoarseSolver)
    cs.setup(_dense_ell(M))
    perm = cs.params["perm"]
    L, U = np.tril(lu, -1) + np.eye(30), np.triu(lu)
    np.testing.assert_allclose(M[perm], L @ U, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.sort(perm), np.arange(30))
    b = rng.standard_normal((30,))
    params = {k: torch.as_tensor(v) for k, v in cs.params.items()}
    cs.params = params
    _close(cs(None, torch.as_tensor(b)), np.linalg.solve(M, b), 1e-12)
    B = rng.standard_normal((30, 2))
    _close(cs(None, torch.as_tensor(B)), np.linalg.solve(M, B), 1e-12)


@pytest.mark.parametrize("lower", [False, True])
def test_cholesky_uses_one_triangle(lower, monkeypatch):
    """``cho_factor`` leaves the matrix's entries in its other triangle;
    the port keeps the factor's triangle only and solves with it."""
    import scipy.linalg
    rng = np.random.default_rng(6)
    G = rng.standard_normal((25, 25))
    M = G @ G.T + 25 * np.eye(25)
    real = scipy.linalg.cho_factor
    monkeypatch.setattr(scipy.linalg, "cho_factor",
                        lambda a: real(a, lower=lower))
    c, _ = real(M, lower=lower)
    assert np.abs(np.tril(c, -1) if not lower else np.triu(c, 1)).max() > 0
    cs = coarse_grid_solver("cholesky")
    cs.setup(_dense_ell(M))
    c_port = cs.params["c"]
    other = np.tril(c_port, -1) if not lower else np.triu(c_port, 1)
    assert cs.static["lower"] == lower and not other.any()
    cs.params = {"c": torch.as_tensor(c_port)}
    b = rng.standard_normal(25)
    _close(cs(None, torch.as_tensor(b)), np.linalg.solve(M, b), 1e-12)


def test_unknown_coarse_solver_raises():
    A = from_scipy(to_scipy(poisson((4, 4))))
    with pytest.raises(ValueError):
        coarse_grid_solver("no_such_solver").setup(A)
    # Schwarz is ported: it sets up on an ELL and refuses a compressed one
    cs = coarse_grid_solver("schwarz")
    cs.setup(A)
    assert cs.static["smoother"][0] == "schwarz"
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell
    with pytest.raises(TypeError):
        coarse_grid_solver("schwarz").setup(dia_from_ell(A))


@pytest.mark.parametrize("kind", COARSE, ids=_coarse_id)
def test_cycles_read_nothing_on_the_host(ref, kind, restore_coarse,
                                         monkeypatch):
    ml = _with_coarse(ref, kind)
    n = ml.levels[0].A.shape[0]
    x, b = torch.zeros(n, dtype=torch.float64), torch.as_tensor(_vec(7, n))
    cycles = [ml._make_cycle(c, 2) for c in ("V", "W", "F", "AMLI")]
    forbid_host_reads(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for cyc in cycles:
            x = cyc(x, b)
    monkeypatch.undo()
    # nor inside a library call (torch.linalg.lu_solve would read here)
    assert not [e.name for e in prof.events()
                if e.name in ("aten::item", "aten::_local_scalar_dense")]
    assert bool(torch.isfinite(x).all())


# -- solve -----------------------------------------------------------------------

def _ref_callable(A, b, **kw):
    return ref_krylov.cr(A, b, **kw)


def _port_callable(A, b, **kw):
    return krylov.cr(A, b, **kw)


ACCELS = [None, "cg", "gmres", "fgmres", "bicgstab", "cr",
          "minimal_residual", "steepest_descent", "cgne", "cgnr",
          "gmres_mgs", "callable"]


@pytest.mark.parametrize("accel", ACCELS, ids=str)
def test_solve_matches_reference(ref, port, accel):
    n = ref.levels[0].A.shape[0]
    b = _vec(8, n)
    want_res, got_res = [], []
    kw = {"tol": 1e-8, "maxiter": 40}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, want_info = ref.solve(
            jnp.asarray(b), accel=_ref_callable if accel == "callable"
            else accel, residuals=want_res, return_info=True, **kw)
        got, info = port.solve(
            b, accel=_port_callable if accel == "callable" else accel,
            residuals=got_res, return_info=True, **kw)
    assert info == want_info and len(got_res) == len(want_res) > 2
    _close(got_res, want_res, 1e-8)
    _close(got, want, 1e-8)


@pytest.mark.parametrize("cycles_per_level", [1, 2])
@pytest.mark.parametrize("cycle", ["W", "F", "AMLI"])
def test_standalone_cycling_matches_reference(ref, port, cycle,
                                              cycles_per_level):
    n = ref.levels[0].A.shape[0]
    b = _vec(9, n)
    want_res, got_res = [], []
    want, want_info = ref.solve(jnp.asarray(b), tol=1e-8, maxiter=40,
                                cycle=cycle,
                                cycles_per_level=cycles_per_level,
                                residuals=want_res, return_info=True)
    got, info = port.solve(b, tol=1e-8, maxiter=40, cycle=cycle,
                           cycles_per_level=cycles_per_level,
                           residuals=got_res, return_info=True)
    assert info == want_info == 0 and len(got_res) == len(want_res)
    _close(got_res, want_res, 1e-8)
    _close(got, want, 1e-8)


def test_converging_on_the_last_cycle_returns_zero(port):
    """The reference returns ``maxiter`` here
    (``pyamg_tpu/multilevel.py:913``); the port returns 0, as the
    reference's callback path does."""
    b = _vec(10, port.levels[0].A.shape[0])
    res = []
    port.solve(b, tol=1e-8, maxiter=100, residuals=res)
    k = len(res) - 1
    assert 2 < k < 100 and res[-1] < 1e-8 * np.linalg.norm(b) <= res[-2]
    _, info = port.solve(b, tol=1e-8, maxiter=k, return_info=True)
    assert info == 0
    _, info = port.solve(b, tol=1e-8, maxiter=k - 1, return_info=True)
    assert info == k - 1


def test_psolve_is_one_v_cycle(port):
    b = _vec(11, port.levels[0].A.shape[0])
    want = port._make_cycle("V")(torch.zeros(b.shape[0],
                                             dtype=torch.float64),
                                 torch.as_tensor(b))
    assert torch.equal(port.psolve(b), want)


def test_unknown_accel_raises(port):
    with pytest.raises(ValueError):
        port.solve(_vec(12, port.levels[0].A.shape[0]), accel="no_such")


# -- complexity, repr, symmetric smoothing -------------------------------------

SA = {"aggregate": ("grid", {}), "max_coarse": 10}


@pytest.fixture(scope="module")
def pair():
    return (ref_sa(ref_poisson((N, N)), **SA),
            smoothed_aggregation_solver(poisson((N, N)), **SA))


def test_complexities_and_repr_match_reference(pair):
    ref_ml, ml = pair
    assert ml.grid_complexity() == pytest.approx(ref_ml.grid_complexity(),
                                                 rel=1e-12)
    for cycle in ("V", "W", "F", "AMLI"):
        assert ml.cycle_complexity(cycle) == pytest.approx(
            ref_ml.cycle_complexity(cycle), rel=1e-12)
    with pytest.raises(TypeError):
        ml.cycle_complexity("X")
    assert repr(ml) == repr(ref_ml)
    # the setup records its phases by key, as the reference's does
    assert set(ml.setup_timings()) == set(ref_ml.setup_timings())


PAIRS = [
    (("gauss_seidel", {"sweep": "symmetric"}),) * 2,
    (("gauss_seidel", {"sweep": "forward"}),
     ("gauss_seidel", {"sweep": "backward"})),
    (("gauss_seidel", {"sweep": "forward"}),) * 2,
    (("sor", {"omega": 1.2, "sweep": "forward"}),
     ("sor", {"omega": 1.2, "sweep": "backward"})),
    (("jacobi", {"omega": 0.8}),) * 2,
    (("jacobi", {"iterations": 1}), ("jacobi", {"iterations": 2})),
    (("jacobi", {}), ("gauss_seidel", {"sweep": "symmetric"})),
    (("chebyshev", {"degree": 3}),) * 2,
    (("richardson", {}),) * 2,
    (("jacobi_ne", {}),) * 2,
    (("cg", {}),) * 2,
    (None, None),
]


@pytest.mark.parametrize("pre, post", PAIRS,
                         ids=lambda s: s[0] if isinstance(s, tuple) else "")
def test_symmetric_smoothing_and_cg_warning(pair, pre, post):
    ref_ml = pair[0]
    ref_change(ref_ml, pre, post)
    ml = smoothed_aggregation_solver(poisson((N, N)), presmoother=pre,
                                     postsmoother=post, **SA)
    assert ml.symmetric_smoothing == ref_ml.symmetric_smoothing
    ml.to_device("cpu")
    b = _vec(13, ml.levels[0].A.shape[0])
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ml.solve(b, accel="cg", maxiter=2)
        ml.solve(b, accel="gmres", maxiter=2)
    cg_warned = [w for w in seen if "CG requires SPD" in str(w.message)]
    assert len(cg_warned) == (0 if ref_ml.symmetric_smoothing else 1)


# -- change_solve_matrix ---------------------------------------------------------

SPECS = [("jacobi", {"omega": 0.8}),
         ("sor", {"omega": 1.3, "sweep": "forward"}),
         ("chebyshev", {"degree": 3})]


def _same_smoother(got, want):
    assert got[:2] == want[:2]
    assert got[2].keys() == want[2].keys()
    for k, v in want[2].items():
        np.testing.assert_array_equal(np.asarray(got[2][k]), np.asarray(v))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s[0])
def test_change_solve_matrix_rebuilds_from_the_spec(spec):
    """Each rebuilt smoother equals a fresh ``make_smoother`` of the new
    matrix from the user's spec: Jacobi keeps its omega (the reference
    resets it to 1), SOR its omega (the reference's rebuild drops it),
    Chebyshev takes the new spectral interval (the reference keeps the
    old polynomial)."""
    A = poisson((16, 16))
    ml = smoothed_aggregation_solver(A, aggregate=("grid", {}),
                                     max_coarse=10, presmoother=spec,
                                     postsmoother=spec)
    ml.compress_stencils().to_device("cpu")
    A2 = from_scipy(3.0 * to_scipy(A) + sp.identity(A.shape[0]))
    old = ml.levels[0].pre
    ml.change_solve_matrix(A2)
    want = make_smoother(ml.levels[0], A2, spec)
    for got in (ml.levels[0].pre, ml.levels[0].post):
        _same_smoother(got, want)
    assert not all(np.array_equal(np.asarray(old[2][k]),
                                  np.asarray(want[2][k]))
                   for k in want[2]) or old[1] != want[1]
    assert type(ml.levels[0].A).__name__ == "DIA"
    np.testing.assert_array_equal(
        to_scipy(ml.levels[0].A_ell).toarray(), to_scipy(A2).toarray())
    b = _vec(14, A.shape[0])
    x = ml.solve(b, tol=1e-8, accel="gmres").numpy()
    assert np.linalg.norm(b - to_scipy(A2) @ x) < 1e-6 * np.linalg.norm(b)


def test_change_solve_matrix_raises_when_the_rebuild_fails():
    A = poisson((16, 16))
    ml = smoothed_aggregation_solver(A, aggregate=("grid", {}),
                                     max_coarse=10,
                                     presmoother=("chebyshev", {}),
                                     postsmoother=("chebyshev", {}))
    before = ml.levels[0].A
    with pytest.raises(ValueError):
        ml.change_solve_matrix(0.0 * to_scipy(A))   # spectral radius 0
    assert ml.levels[0].A is before
