"""The port's public surface against the JAX package's: every name of each
``__all__`` and every public member of the containers resolves in the
port, and each function or option added to close that gap is held against
the JAX package's on the CPU.
"""

import dataclasses
import importlib
import inspect
import pkgutil
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import pyamg_tpu
import pyamg_tpu_torch

torch.set_num_threads(1)

# every name of every reference __all__ is ported
STILL_TO_PORT = {}

# parallel/, part 2 (the distributed setup), the last names ported
DIST_SETUP_NAMES = ["distributed_sa_setup", "distributed_classical_setup",
                    "dist_stencil_grid", "dist_from_scipy", "DistHierarchy",
                    "DistLevel"]


def _reference_modules():
    out = ["pyamg_tpu"]
    for m in pkgutil.walk_packages(pyamg_tpu.__path__, "pyamg_tpu."):
        if m.ispkg and not m.name.startswith("pyamg_tpu._native"):
            out.append(m.name)
    return [n for n in out
            if hasattr(importlib.import_module(n), "__all__")]


REFERENCE_MODULES = _reference_modules()


def _port(name):
    return importlib.import_module("pyamg_tpu_torch" + name[len("pyamg_tpu"):])


def test_every_reference_package_with_names_is_checked():
    assert len(REFERENCE_MODULES) == 12
    assert "pyamg_tpu.parallel" in REFERENCE_MODULES


@pytest.mark.parametrize("name", REFERENCE_MODULES)
def test_reference_names_resolve_in_the_port(name):
    ref = importlib.import_module(name)
    port = _port(name)
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert missing == STILL_TO_PORT.get(name, [])


def test_names_still_to_port_are_absent_and_listed():
    """No name is still to port: part 2's names resolve to the port's own
    ``parallel.dist_setup`` objects, and the package docstring no longer
    lists any name as still to port."""
    import pyamg_tpu_torch.parallel as par
    from pyamg_tpu_torch.parallel import dist_setup
    assert STILL_TO_PORT == {}
    for n in DIST_SETUP_NAMES:
        assert getattr(par, n) is getattr(dist_setup, n)
        assert getattr(par, n).__module__ == "pyamg_tpu_torch.parallel." \
            "dist_setup"
    assert "not ported" not in par.__doc__.lower()
    assert "to port" not in par.__doc__.lower()


def _members(obj):
    names = {n for n in dir(obj) if not n.startswith("_")}
    if dataclasses.is_dataclass(obj):
        names |= {f.name for f in dataclasses.fields(obj)
                  if not f.name.startswith("_")}
    return names


def _pairs():
    from pyamg_tpu import multilevel as jml
    from pyamg_tpu.sparse import matrix as jm, sell as js
    from pyamg_tpu_torch import multilevel as ml
    from pyamg_tpu_torch.sparse import matrix as m, sell as s
    return {"ELL": (jm.ELL, m.ELL), "BELL": (jm.BELL, m.BELL),
            "DIA": (jm.DIA, m.DIA), "SELL": (js.SELL, s.SELL),
            "PhaseStencil": (jm.PhaseStencil, m.PhaseStencil),
            "Level": (jml.Level(), ml.Level())}


@pytest.mark.parametrize("cls", ["ELL", "BELL", "DIA", "SELL",
                                 "PhaseStencil", "Level"])
def test_container_members_resolve(cls):
    ref, port = _pairs()[cls]
    assert _members(ref) - _members(port) == set()
    if cls != "Level":
        assert hasattr(port, "__matmul__")


def _reference_objects():
    """{(module, name): object} of each public function and class that a
    module of the JAX package defines (its packages' modules, ``_native``
    aside)."""
    out = {}
    for pkg in REFERENCE_MODULES:
        for name in [pkg] + [m.name for m in pkgutil.iter_modules(
                importlib.import_module(pkg).__path__, pkg + ".")]:
            if name.startswith("pyamg_tpu._native"):
                continue
            for n, obj in vars(importlib.import_module(name)).items():
                if not n.startswith("_") and getattr(
                        obj, "__module__", None) == name and \
                        (inspect.isfunction(obj) or inspect.isclass(obj)):
                    out[name, n] = obj
    return out


# the port's signatures differ from the JAX package's here by design, and
# only here: JAX-only helpers and module (absent), the ``interpret`` flags
# of the Pallas wrappers, a torch.distributed group and device in place of
# JAX devices, an H100's 80 GB, and the port's dtypes as defaults
ABSENT_BY_DESIGN = {
    ("pyamg_tpu.ops.pallas_kernels", None),
    ("pyamg_tpu.ops.sell_kernels", "pallas_available"),
    ("pyamg_tpu.sparse.matrix", "is_concrete"),
    ("pyamg_tpu.sparse.matrix", "trace_state_clean"),
    ("pyamg_tpu.sparse.matrix", "setup_device"),
    ("pyamg_tpu.sparse.matrix", "on_setup_device"),
}
PARAMETERS_BY_DESIGN = {
    ("pyamg_tpu.ops.sell_kernels", "sell_spmv"): {"interpret"},
    ("pyamg_tpu.ops.sell_kernels", "sell_gs_sweep"): {"interpret"},
    ("pyamg_tpu.parallel.partition", "make_row_mesh"): {"devices"},
}
DEFAULTS_BY_DESIGN = {
    ("pyamg_tpu.parallel.scale_model", "summarize"): {"hbm_bytes"},
    ("pyamg_tpu.parallel.dist_setup", "dist_stencil_grid"): {"dtype"},
    ("pyamg_tpu.parallel.dist_setup", "dist_from_scipy"): {"dtype"},
    ("pyamg_tpu.sparse.matrix", "eye"): {"dtype"},
}


def _signature_differences():
    """(absent, parameters, defaults): reference objects the port lacks;
    reference parameter names the port's signature lacks (unless it takes
    ``**kwargs``); parameters both have whose defaults differ."""
    absent, params, defaults = set(), {}, {}
    for (mod, name), obj in _reference_objects().items():
        try:
            port_mod = _port(mod)
        except ModuleNotFoundError:
            absent.add((mod, None))
            continue
        if not hasattr(port_mod, name):
            absent.add((mod, name))
            continue
        want = inspect.signature(obj).parameters
        got = inspect.signature(getattr(port_mod, name)).parameters
        missing = set(want) - set(got)
        if missing and not any(p.kind == p.VAR_KEYWORD
                               for p in got.values()):
            params[mod, name] = missing
        moved = {p for p in set(want) & set(got)
                 if repr(want[p].default) != repr(got[p].default)}
        if moved:
            defaults[mod, name] = moved
    return absent, params, defaults


def test_reference_signatures_resolve_in_the_port():
    """Every parameter name of each reference function and class is in
    the port's signature (or the port's takes ``**kwargs``), with the
    same default, but for the differences listed by design: those and no
    other."""
    absent, params, defaults = _signature_differences()
    assert absent == ABSENT_BY_DESIGN
    assert params == PARAMETERS_BY_DESIGN
    assert defaults == DEFAULTS_BY_DESIGN


def test_keywords_the_reference_takes():
    """``strength_measure(default=)`` and ``eliminate_local_candidates``'s
    extra keywords are accepted and ignored, as in the reference."""
    from pyamg_tpu.aggregation.adaptive import \
        eliminate_local_candidates as jelim
    from pyamg_tpu.strength import strength_measure as jmeasure
    from pyamg_tpu_torch.aggregation.adaptive import \
        eliminate_local_candidates
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.strength import strength_measure
    A = poisson((12, 12))
    jA = pyamg_tpu.gallery.poisson((12, 12))
    for spec in (None, "symmetric", ("classical", {"theta": 0.3})):
        _same_ell(strength_measure(A, spec, default=("classical", {})),
                  strength_measure(A, spec))
    _same_ell(strength_measure(A, "symmetric", default=("classical", {})),
              jmeasure(jA, "symmetric", default=("classical", {})))
    from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
    from pyamg_tpu_torch.aggregation.tentative import fit_candidates
    AggOp, _ = standard_aggregation(strength_measure(A, "symmetric"))
    T, _ = fit_candidates(AggOp, np.ones((A.shape[0], 1)))
    x = np.random.default_rng(4).standard_normal(A.shape[0])
    got = eliminate_local_candidates(x, AggOp, A, T, thresh=0.5, extra=1)
    np.testing.assert_array_equal(
        got, eliminate_local_candidates(x, AggOp, A, T, thresh=0.5))
    from pyamg_tpu.sparse.matrix import from_scipy as jfrom_scipy
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    want = jelim(x, jfrom_scipy(to_scipy(AggOp)), jA,
                 jfrom_scipy(to_scipy(T)), thresh=0.5, extra=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("kind", ["ELL", "BELL", "DIA"])
def test_to_scipy_of_a_placed_operator(kind):
    """``to_scipy`` copies a placed operator's tensors to the host: on
    ``device="cpu"`` it equals ``to_scipy`` of the host operator exactly
    (on the card, ``chip_smoke.py`` holds it)."""
    from pyamg_tpu_torch.gallery import linear_elasticity, poisson
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, to_scipy
    A = {"ELL": lambda: poisson((12, 12)),
         "BELL": lambda: linear_elasticity((6, 6))[0],
         "DIA": lambda: dia_from_ell(poisson((12, 12)))}[kind]()
    want, got = to_scipy(A), to_scipy(A.to("cpu"))
    assert got.format == want.format and got.shape == want.shape
    assert (got != want).nnz == 0
    for f in ("indptr", "indices", "data"):
        _same(getattr(got, f), getattr(want, f))


# -- the functions and members added ---------------------------------------------

def _pair(S):
    from pyamg_tpu.sparse.matrix import from_scipy as jfrom_scipy
    from pyamg_tpu_torch.sparse.matrix import from_scipy
    return jfrom_scipy(S), from_scipy(S)


def _matrix(seed=0, n=30, m=None):
    rng = np.random.default_rng(seed)
    S = sp.random(n, m or n, density=0.2, random_state=rng, format="csr")
    if m is None:
        S = S + sp.eye(n) * 3.0
    return S.tocsr()


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_ell(got, want):
    for f in ("cols", "vals", "row_nnz"):
        _same(getattr(got, f), getattr(want, f))
    assert tuple(got.shape) == tuple(want.shape)


def test_rspmv():
    from pyamg_tpu.ops.spmv import rspmv as jrspmv
    from pyamg_tpu_torch.ops import rspmv
    S = _matrix(1, 30, 20)
    jA, A = _pair(S)
    x = np.random.default_rng(2).standard_normal(30)
    want = np.asarray(jrspmv(jA, jnp.asarray(x)))
    np.testing.assert_allclose(rspmv(A, x), want, rtol=1e-13)
    np.testing.assert_allclose(rspmv(A.to("cpu"), torch.as_tensor(x)),
                               want, rtol=1e-13)


def test_row_max_abs_offdiag():
    from pyamg_tpu.ops.spmv import row_max_abs_offdiag as jf
    from pyamg_tpu_torch.ops import row_max_abs_offdiag
    jA, A = _pair(_matrix(3))
    want = np.asarray(jf(jA))
    _same(row_max_abs_offdiag(A), want)
    _same(row_max_abs_offdiag(A.to("cpu")), want)


def test_arith_additions():
    from pyamg_tpu.ops import arith as ja
    from pyamg_tpu_torch.ops import (filter_rows_by_mask, remove_diagonal,
                                     scale_cols)
    jA, A = _pair(_matrix(4))
    d = np.random.default_rng(5).standard_normal(30)
    _same_ell(scale_cols(A, d), ja.scale_cols(jA, d))
    _same_ell(remove_diagonal(A), ja.remove_diagonal(jA))
    keep = np.abs(np.asarray(A.vals)) > 0.5
    _same_ell(filter_rows_by_mask(A, keep),
              ja.filter_rows_by_mask(jA, jnp.asarray(keep)))


def test_rowops_host_forms():
    from pyamg_tpu.ops import rowops as jr
    from pyamg_tpu_torch.ops import dedup_rows
    from pyamg_tpu_torch.ops.rowops import compact_width
    rng = np.random.default_rng(6)
    cols = rng.integers(0, 12, (20, 7)).astype(np.int32)
    vals = rng.standard_normal((20, 7))
    valid = rng.random((20, 7)) < 0.8
    got = dedup_rows(cols, vals, valid, 12)
    want = jr.dedup_rows_host(cols, vals, valid, 12)
    for g, w in zip(got, want):
        _same(g, w)
    _same_ell(compact_width(*got, (20, 12)),
              jr.compact_width(*want, (20, 12)))
    _same_ell(compact_width(*got, (20, 12), width=3, min_width=1),
              jr.compact_width(*want, (20, 12), width=3, min_width=1))
    # tensors take the device form: the same columns and counts, values
    # as differences of running sums
    dc, dv, drn = dedup_rows(torch.as_tensor(cols), torch.as_tensor(vals),
                             torch.as_tensor(valid), 12)
    _same(dc, want[0])
    _same(drn, want[2])
    np.testing.assert_allclose(dv.numpy(), want[1], rtol=1e-12, atol=1e-14)


def test_inv_device():
    from pyamg_tpu.ops.dense import inv_device as jinv
    from pyamg_tpu_torch.ops.dense import inv_device
    jA, A = _pair(_matrix(7))
    np.testing.assert_allclose(inv_device(A, device="cpu").numpy(),
                               np.asarray(jinv(jA)), rtol=1e-10, atol=1e-12)


def test_sparse_constructors():
    from pyamg_tpu.sparse import matrix as jm
    from pyamg_tpu_torch.sparse import ell_from_coo, eye
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, ell_from_dia
    _same_ell(eye(7, width=3), jm.eye(7, width=3))
    assert eye(7).vals.dtype == np.float32
    rng = np.random.default_rng(8)
    r = rng.integers(0, 10, 40)
    r[::9] = 10                      # padding entries, dropped
    c = rng.integers(0, 8, 40)
    v = rng.standard_normal(40)
    for dup in (True, False):
        _same_ell(ell_from_coo(r, c, v, (10, 8), sum_duplicates=dup),
                  jm.ell_from_coo(jnp.asarray(r), jnp.asarray(c),
                                  jnp.asarray(v), (10, 8),
                                  sum_duplicates=dup))
    jA, A = _pair(_matrix(9))
    _same_ell(ell_from_dia(dia_from_ell(A)), jm.ell_from_dia(
        jm.dia_from_ell(jA)))
    _same_ell(ell_from_dia(dia_from_ell(A).to("cpu")),
              jm.ell_from_dia(jm.dia_from_ell(jA)))


def test_matmul_and_ell_members():
    from pyamg_tpu_torch.ops import matmul
    S = _matrix(10)
    jA, A = _pair(S)
    x = np.random.default_rng(11).standard_normal(30)
    want = np.asarray(jA @ jnp.asarray(x))
    np.testing.assert_allclose(A @ x, want, rtol=1e-13)
    np.testing.assert_allclose(A.mv(x), want, rtol=1e-13)
    np.testing.assert_allclose(A.to("cpu") @ torch.as_tensor(x), want,
                               rtol=1e-13)
    _same_ell(matmul(A, A), jA @ jA)
    _same_ell(A.T, jA.T)
    _same_ell(A.H, jA.H)
    _same(A.diagonal(), jA.diagonal())
    assert (A.n_rows, A.n_cols, A.blocksize) == (jA.n_rows, jA.n_cols,
                                                 jA.blocksize)
    with pytest.raises(TypeError):
        matmul(A, _pair(sp.bsr_matrix(S.toarray()[:30, :30],
                                      blocksize=(2, 2)))[1])


def test_bell_members():
    S = sp.bsr_matrix(_matrix(12).toarray(), blocksize=(3, 3))
    jB, B = _pair(S)
    x = np.random.default_rng(13).standard_normal(30)
    want = np.asarray(jB @ jnp.asarray(x))
    np.testing.assert_allclose(B @ x, want, rtol=1e-13)
    np.testing.assert_allclose(B.mv(x), want, rtol=1e-13)
    for attr in ("T", "H"):
        got, ref = getattr(B, attr), getattr(jB, attr)
        _same(got.cols, ref.cols)
        _same(got.vals, ref.vals)
        _same(got.row_nnz, ref.row_nnz)
    BB, jBB = B @ B, jB @ jB
    _same(BB.cols, jBB.cols)
    np.testing.assert_allclose(BB.vals, np.asarray(jBB.vals), rtol=1e-13)
    assert (B.n_rows, B.n_cols) == (jB.n_rows, jB.n_cols)


def test_dia_sell_phase_members():
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell
    from pyamg_tpu_torch.sparse.sell import sell_from_ell
    A = poisson((20, 20))
    D = dia_from_ell(A)
    assert (D.n_rows, D.n_cols, D.blocksize) == (400, 400, (1, 1))
    assert D.astype(np.float32).data.dtype == np.float32
    assert D.to("cpu").astype(torch.float32).data.dtype == torch.float32
    Sl = sell_from_ell(A.astype(np.float32), max_passes=None)
    if Sl is not None:
        assert (Sl.n_rows, Sl.n_cols, Sl.blocksize) == (400, 400, (1, 1))
        S64 = Sl.astype(np.float64)
        assert S64.vals.dtype == np.float64 and S64.diag.dtype == np.float64
        _same(S64.vals, Sl.vals.astype(np.float64))


def test_phase_stencil_members():
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse.matrix import PhaseStencil
    ml = smoothed_aggregation_solver(poisson((12, 12)),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils()
    P = ml.levels[0].P
    assert isinstance(P, PhaseStencil)
    assert P.blocksize == (1, 1)
    assert P.H.trans != P.trans and P.H.arrays is P.arrays
    P32 = P.astype(np.float32)
    assert all(a.dtype == np.float32 for a in P32.arrays)
    Pc = P.to("cpu")
    Pz = dataclasses.replace(Pc, arrays=tuple(a.to(torch.complex128) * 1j
                                              for a in Pc.arrays))
    assert torch.equal(Pz.H.arrays[0], Pz.arrays[0].conj())
    assert ml.levels[0].nnz == ml.levels[0].A.nnz


# -- the options the port now takes --------------------------------------------

def test_spectral_radius_options():
    from pyamg_tpu.util.linalg import approximate_spectral_radius as jasr
    from pyamg_tpu_torch.util.linalg import approximate_spectral_radius
    jA, A = _pair(_matrix(14))
    g = np.random.default_rng(15).random(30)
    for kw in ({}, {"symmetric": True}, {"initial_guess": g},
               {"initial_guess": g, "symmetric": False}):
        assert approximate_spectral_radius(A, **kw) == pytest.approx(
            jasr(jA, **kw), rel=1e-12)
    rho, v = approximate_spectral_radius(A, initial_guess=g,
                                         return_vector=True)
    jrho, jv = jasr(jA, initial_guess=g, return_vector=True)
    assert rho == pytest.approx(jrho, rel=1e-12)
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-10, atol=1e-12)


def test_pinv_array_takes_tol():
    from pyamg_tpu.util.linalg import pinv_array as jpinv
    from pyamg_tpu_torch.util.linalg import pinv_array
    blocks = np.random.default_rng(16).standard_normal((5, 3, 3))
    np.testing.assert_allclose(pinv_array(blocks, tol=1e-8),
                               np.asarray(jpinv(blocks, tol=1e-8)),
                               rtol=1e-12)


def test_gauss_seidel_without_colors_on_a_device_ell():
    """The JAX package colors a concrete ELL (its arrays placed or not) by
    first-fit; the port's placed ELL does the same, and the sweep equals
    the JAX package's."""
    from pyamg_tpu.relaxation import relaxation as jrx
    from pyamg_tpu.sparse.matrix import ELL as JELL
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.relaxation import relaxation as rx
    A = poisson((9, 7))
    jA = JELL(jnp.asarray(A.cols), jnp.asarray(A.vals),
              jnp.asarray(A.row_nnz), A.shape)
    b = np.random.default_rng(17).standard_normal(63)
    want = np.asarray(jrx.gauss_seidel(jA, jnp.zeros(63), jnp.asarray(b),
                                       sweep="symmetric"))
    Ad = A.to("cpu")
    got = rx.gauss_seidel(Ad, torch.zeros(63, dtype=torch.float64),
                          torch.as_tensor(b), sweep="symmetric")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-15)
    colors, nc = rx.make_coloring(Ad)
    assert isinstance(colors, torch.Tensor)
    jc, jnc = jrx.make_coloring(jA)
    _same(colors, jc)
    assert nc == jnc


@pytest.mark.parametrize("method,seed", [("JP", 0), ("JP", 3), ("LDF", 1)])
def test_make_coloring_on_a_dia(method, seed):
    """A DIA has no ELL arrays to color by first-fit (the JAX package's
    raises an AttributeError there); the port colors its graph by
    ``vertex_coloring(method, seed)``, as the JAX package's colors the
    same graph."""
    from pyamg_tpu.graph import vertex_coloring as jvc
    from pyamg_tpu.sparse.matrix import from_scipy as jfrom_scipy
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.relaxation.relaxation import make_coloring
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, to_scipy
    A = poisson((11, 9))
    D = dia_from_ell(A)
    want = jvc(jfrom_scipy(to_scipy(D)), method=method, seed=seed)
    for op in (D, D.to("cpu")):
        colors, nc = make_coloring(op, method=method, seed=seed)
        _same(colors, want)
        assert nc == int(np.max(want)) + 1
    S = to_scipy(A)
    rows, cols = S.nonzero()
    c = np.asarray(colors)
    assert not np.any((c[rows] == c[cols]) & (rows != cols))


@pytest.mark.parametrize("factory", ["smoothed_aggregation_solver",
                                     "rootnode_solver", "pairwise_solver"])
def test_solver_factories_accept_and_ignore_kwargs(factory):
    """As the JAX package's factories do: an unknown keyword changes
    nothing."""
    from pyamg_tpu_torch import aggregation
    from pyamg_tpu_torch.gallery import poisson
    A = poisson((16, 16))
    make = getattr(aggregation, factory)
    a = make(A, max_coarse=10)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = make(A, max_coarse=10, not_an_option=3, verb=False)
    assert [l.A.shape for l in a.levels] == [l.A.shape for l in b.levels]
    for la, lb in zip(a.levels, b.levels):
        _same(la.A.vals, lb.A.vals)


def test_the_tester_runs_the_ports_tests(monkeypatch):
    """``pyamg_tpu_torch.test`` hands pytest the port's own test files
    (``tests/test_torch_*.py``) and returns whether they passed."""
    import pytest as pt
    seen = []
    monkeypatch.setattr(pt, "main", lambda args: seen.append(args) or 0)
    assert pyamg_tpu_torch.test("-k halo") is True
    args = seen[0]
    assert args[:3] == ["-q", "-k", "halo"]
    files = [a for a in args if a.endswith(".py")]
    assert files and all("test_torch_" in f for f in files)
    assert any(f.endswith("test_torch_surface.py") for f in files)
    monkeypatch.setattr(pt, "main", lambda args: 1)
    assert pyamg_tpu_torch.test() is False
    assert "test_torch_" in pyamg_tpu_torch.test.__class__.__doc__
