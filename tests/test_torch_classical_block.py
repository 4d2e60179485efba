"""Block (BELL) and complex operators in the classical family against the
JAX package (``pyamg_tpu/classical/interpolate.py:214-275``, ``:442-530``;
``:113-211``) on the CPU, at 24^2 or less.

* Injection and one-point interpolation of a BELL (2-D linear elasticity,
  2 x 2 blocks), and block lAIR (degree 1 and 2; ``use_gmres`` warns and
  solves directly), on the same node-level splitting: equal to 1e-12 of
  the largest entry.
* Direct, classical (modified and not) interpolation and the strong F-F
  filter of complex operators (Poisson times 1 + 0.5i, and a random
  nonsymmetric matrix times a phase): to 1e-12.
* Whole block AIR and complex RS/AIR hierarchies: rows, blocksizes,
  layouts, operator complexity equal, every A, P and R to 1e-12; their
  GMRES solves in complex128 the same iterations, x to 1e-8.
* F/C Jacobi on a block AIR level (the default post-smoother, whose
  node-level C/F points the port expands by the blocksize) against a
  dense scipy Jacobi on the expanded rows.  It is not held to the JAX
  package, whose ``fc_jacobi`` raises on a block level.
* The JAX package's block AIR and complex hierarchies fed through
  ``hierarchy_from_arrays``: one V-cycle to 1e-12 and the same GMRES
  iterations.
* A complex level compressed to DIA, as the JAX package compresses it,
  runs torch operations, never K1 or K2, whose wrappers raise on complex
  tensors.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.classical import air_solver as ref_air
from pyamg_tpu.classical import interpolate as ref_itp
from pyamg_tpu.classical import ruge_stuben_solver as ref_rs
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy
from pyamg_tpu.strength import \
    classical_strength_of_connection as ref_classical_soc

from pyamg_tpu_torch import air_solver, hierarchy_from_arrays
from pyamg_tpu_torch import ruge_stuben_solver
from pyamg_tpu_torch.classical import interpolate as itp
from pyamg_tpu_torch.classical import split
from pyamg_tpu_torch.gallery import linear_elasticity, poisson
from pyamg_tpu_torch.ops import dia_kernels
from pyamg_tpu_torch.sparse.matrix import BELL, from_scipy, to_scipy
from pyamg_tpu_torch.strength import classical_strength_of_connection

from test_torch_cycles import _ell, _smoother

torch.set_num_threads(1)

PHASE = 1 + 0.5j


def _near(got, want, rel=1e-12):
    g, w = to_scipy(got).toarray(), ref_to_scipy(want).toarray()
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-300)


def _elasticity(n=8):
    A, _ = linear_elasticity((n, n), format="bsr")
    Ar, _ = ref_elasticity((n, n), format="bsr")
    return from_scipy(A), ref_from_scipy(Ar)


def _complex(name):
    if name == "poisson":
        S = to_scipy(poisson((16, 16))).astype(np.complex128) * PHASE
    else:
        rng = np.random.default_rng(3)
        n = 240
        M = sp.random(n, n, density=8.0 / n, random_state=rng,
                      data_rvs=rng.standard_normal, format="csr")
        M = M + sp.diags_array(np.asarray(abs(M).sum(axis=1)).ravel() + 1)
        S = sp.csr_matrix(M).astype(np.complex128) * np.exp(0.3j)
    S = sp.csr_matrix(S)
    return from_scipy(S), ref_from_scipy(S)


# -- block interpolation -------------------------------------------------------

@pytest.mark.parametrize("kind", ["injection", "one_point",
                                  "one_point_by_val"])
def test_block_interpolation_matches_reference(kind):
    A, Ar = _elasticity()
    C = classical_strength_of_connection(A, theta=0.25)
    Cr = ref_classical_soc(Ar, theta=0.25)
    splitting = split.RS(C)
    if kind == "injection":
        got = itp.injection_interpolation(A, splitting)
        want = ref_itp.injection_interpolation(Ar, splitting)
    else:
        by_val = kind.endswith("by_val")
        got = itp.one_point_interpolation(A, C, splitting, by_val=by_val)
        want = ref_itp.one_point_interpolation(Ar, Cr, splitting,
                                               by_val=by_val)
    assert isinstance(got, BELL) and got.blocksize == (2, 2)
    assert got.shape == (A.shape[0], 2 * int(splitting.sum()))
    _near(got, want)


@pytest.mark.parametrize("kw", [{"degree": 1}, {"degree": 2},
                                {"degree": 2, "theta": 0.05},
                                {"use_gmres": True}], ids=str)
def test_block_local_air_matches_reference(kw):
    A, Ar = _elasticity()
    C = classical_strength_of_connection(A, theta=0.25)
    splitting = split.RS(C)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = itp.local_air(A, splitting, **kw)
    assert any("block lAIR" in str(w.message) for w in seen) == \
        bool(kw.get("use_gmres"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_itp.local_air(Ar, splitting, **kw)
    assert isinstance(got, BELL)
    np.testing.assert_array_equal(np.asarray(got.cols),
                                  np.asarray(want.cols))
    np.testing.assert_array_equal(np.asarray(got.row_nnz),
                                  np.asarray(want.row_nnz))
    _near(got, want)


# -- complex interpolation -----------------------------------------------------

@pytest.mark.parametrize("name", ["poisson", "random"])
@pytest.mark.parametrize("kind", ["direct", "classical", "classical_plain",
                                  "remove_strong_FF"])
def test_complex_interpolation_matches_reference(name, kind):
    """The strong F-F filter takes a complex strength (A itself), whose
    values send both packages to their vectorised twins."""
    A, Ar = _complex(name)
    C = classical_strength_of_connection(A, theta=0.25)
    Cr = ref_classical_soc(Ar, theta=0.25)
    splitting = split.RS(C)
    if kind == "direct":
        got = itp.direct_interpolation(A, C, splitting)
        want = ref_itp.direct_interpolation(Ar, Cr, splitting)
    elif kind == "remove_strong_FF":
        got = itp.remove_strong_FF_connections(A, A, splitting)
        want = ref_itp.remove_strong_FF_connections(Ar, Ar,
                                                    jnp.asarray(splitting))
        dropped = (np.asarray(got.vals) == 0).sum() - \
            (np.asarray(A.vals) == 0).sum()
        assert dropped > 0 or name == "poisson"
    else:
        modified = kind == "classical"
        got = itp.classical_interpolation(A, C, splitting, modified=modified)
        want = ref_itp.classical_interpolation(Ar, Cr, splitting,
                                               modified=modified)
    assert np.iscomplexobj(np.asarray(got.vals))
    _near(got, want)


@pytest.mark.parametrize("kind", ["classical", "remove_strong_FF"])
def test_complex_twin_in_small_chunks_matches(kind, monkeypatch):
    """The complex twins give the same result in chunks of a few rows."""
    A, _ = _complex("random")
    C = classical_strength_of_connection(A, theta=0.25)
    splitting = split.RS(C)

    def run():
        if kind == "classical":
            return itp.classical_interpolation(A, C, splitting)
        return itp.remove_strong_FF_connections(A, A, splitting)

    whole = run()
    monkeypatch.setattr(itp, "_TWIN_CHUNK", 7 * A.width ** 3)
    assert itp._row_chunks(A.shape[0], A.width ** 3)[0] == (0, 7)
    chunked = run()
    assert np.array_equal(to_scipy(whole).toarray(),
                          to_scipy(chunked).toarray())


# -- whole hierarchies -----------------------------------------------------------

def _hierarchies(name):
    if name == "block_air":
        A, Ar = _elasticity(12)
        return (air_solver(A, max_coarse=20, postsmoother="block_jacobi"),
                ref_air(Ar, max_coarse=20, postsmoother="block_jacobi"))
    A, Ar = _complex("poisson")
    if name == "complex_rs":
        return ruge_stuben_solver(A, max_coarse=10), ref_rs(Ar, max_coarse=10)
    return air_solver(A, max_coarse=20), ref_air(Ar, max_coarse=20)


HIERARCHIES = ["block_air", "complex_rs", "complex_air"]


@pytest.mark.parametrize("name", HIERARCHIES)
def test_hierarchy_matches_reference(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml, mr = _hierarchies(name)
    assert len(ml.levels) == len(mr.levels) > 2
    assert abs(ml.operator_complexity() - mr.operator_complexity()) <= 1e-12
    for lp, lr in zip(ml.levels, mr.levels):
        for attr in "APR":
            op, opr = getattr(lp, attr, None), getattr(lr, attr, None)
            assert type(op).__name__ == type(opr).__name__
            if op is not None:
                assert tuple(getattr(op, "blocksize", (1, 1))) == \
                    tuple(getattr(opr, "blocksize", (1, 1)))
                _near(op, opr)
    if name == "block_air":
        assert isinstance(ml.levels[0].A, BELL) and \
            not isinstance(ml.levels[1].A, BELL)


@pytest.mark.parametrize("name", HIERARCHIES)
def test_solve_matches_reference(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml, mr = _hierarchies(name)
        n = ml.levels[0].A.shape[0]
        b = np.random.default_rng(4).standard_normal(n)
        if name != "block_air":
            b = b.astype(np.complex128)
        res, res_r = [], []
        x = ml.to_device("cpu").solve(b, tol=1e-8, accel="gmres",
                                      residuals=res)
        xr = mr.solve(jnp.asarray(b), tol=1e-8, accel="gmres",
                      residuals=res_r)
    assert x.dtype == (torch.float64 if name == "block_air" else
                       torch.complex128)
    assert len(res) == len(res_r) > 3
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(xr)).max())


def test_block_fc_jacobi_matches_dense_reference():
    """F/C Jacobi on block AIR level 0: F rows (node-level F points, both
    unknowns) relaxed twice, then C rows once, omega 1, against dense
    Jacobi restricted to the expanded rows."""
    A, _ = _elasticity(12)
    ml = air_solver(A, max_coarse=20).to_device("cpu")
    lvl = ml.levels[0]
    kind, sopts, params = lvl.post
    assert kind == "fc_jacobi"
    assert (sopts["f_iterations"], sopts["c_iterations"]) == (2, 1)
    S = to_scipy(A).toarray()
    Fu = np.repeat(lvl.splitting == 0, 2)
    rng = np.random.default_rng(5)
    x0, b = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    want = x0.copy()
    d = np.diag(S)
    for rows, times in ((Fu, 2), (~Fu, 1)):
        for _ in range(times):
            want = np.where(rows, want + (b - S @ want) / d, want)
    from pyamg_tpu_torch.relaxation.smoothing import apply_smoother
    got = apply_smoother(*lvl.post, ml.levels[0].A, torch.as_tensor(x0),
                         torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# -- the JAX package's hierarchies through hierarchy_from_arrays ---------------

def _op(op):
    if hasattr(op, "blocksize") and tuple(op.blocksize) != (1, 1):
        return {"cols": np.asarray(op.cols), "vals": np.asarray(op.vals),
                "row_nnz": np.asarray(op.row_nnz), "shape": tuple(op.shape),
                "blocksize": tuple(op.blocksize)}
    return _ell(op)


def _spec(mr):
    levels = []
    for i, lvl in enumerate(mr.levels):
        d = {"A": _op(lvl.A)}
        if i < len(mr.levels) - 1:
            d.update(P=_op(lvl.P), R=_op(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post))
            if getattr(lvl, "splitting", None) is not None:
                d["splitting"] = np.asarray(lvl.splitting)
        levels.append(d)
    return {"levels": levels,
            "coarse": {"kind": "pinv",
                       "op": np.asarray(mr.coarse_solver.params["op"])}}


@pytest.mark.parametrize("name", HIERARCHIES)
def test_reference_hierarchy_through_hierarchy_from_arrays(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, mr = _hierarchies(name)
        ml = hierarchy_from_arrays(_spec(mr), device="cpu")
        n = ml.levels[0].A.shape[0]
        rng = np.random.default_rng(6)
        dt = np.float64 if name == "block_air" else np.complex128
        x0 = rng.standard_normal(n).astype(dt)
        b = rng.standard_normal(n).astype(dt)
        want = np.asarray(mr._make_cycle("V")(mr._dyn(), jnp.asarray(x0),
                                              jnp.asarray(b)))
        got = ml._make_cycle("V")(torch.as_tensor(x0), torch.as_tensor(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        res, res_r = [], []
        ml.solve(b, tol=1e-8, accel="gmres", residuals=res)
        mr.solve(jnp.asarray(b), tol=1e-8, accel="gmres", residuals=res_r)
    assert len(res) == len(res_r) > 3


# -- complex levels on DIA ---------------------------------------------------------

def test_compressed_complex_levels_run_no_kernel(monkeypatch):
    """``compress_stencils`` makes complex DIA levels, as the JAX package
    does; their products and sweeps are torch operations (the JAX
    package's jnp path), so a solve reaches neither K1 nor K2 (patched to
    raise), and the wrappers refuse a complex band themselves."""
    A, Ar = _complex("poisson")
    ml, mr = ruge_stuben_solver(A, max_coarse=10), ref_rs(Ar, max_coarse=10)
    ml.compress_stencils()
    mr.compress_stencils()

    def layout(m):
        return [tuple(type(getattr(lvl, a, None)).__name__ for a in "APR")
                for lvl in m.levels]

    assert layout(ml) == layout(mr) and layout(ml)[0][0] == "DIA"
    D = ml.levels[0].A
    x = torch.ones(D.shape[0], dtype=torch.complex128)
    with pytest.raises(TypeError):
        dia_kernels.dia_spmv(torch.as_tensor(D.data), D.offsets, D.shape[0],
                             x)

    def refuse(*args, **kwargs):
        raise AssertionError("a complex level reached a DIA kernel")

    monkeypatch.setattr(dia_kernels, "dia_spmv", refuse)
    monkeypatch.setattr(dia_kernels, "dia_gs_sweep", refuse)
    b = np.random.default_rng(7).standard_normal(A.shape[0]) * PHASE
    res = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xc = ml.to_device("cpu").solve(b, tol=1e-8, accel="gmres",
                                       residuals=res)
    S = to_scipy(A)
    assert np.linalg.norm(b - S @ xc.numpy()) / np.linalg.norm(b) < 1e-6
