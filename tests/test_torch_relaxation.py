"""The port's smoothers against the JAX package's, on the CPU.

Every ported smoother kind is set up by both packages on the same host
operator (2-D Poisson 20^2 plus a random symmetric perturbation, so that
the normal-equation smoothers see unequal row norms) and applied to the
same x and b from a numpy seed: the JAX package's on its ELL, the port's
on a placed ELL and on a placed DIA (K1/K2's plain versions on the CPU).
Tolerances: float64 relative 1e-12, float32 1e-5, of max |x|.  The same
smoothers, applied to tensors, read nothing on the host.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.relaxation import relaxation as ref_rx
from pyamg_tpu.relaxation.chebyshev import \
    chebyshev_polynomial_coefficients as ref_cheb
from pyamg_tpu.relaxation.smoothing import (apply_smoother as ref_apply,
                                            make_smoother as ref_make)
from pyamg_tpu.relaxation.utils import \
    relaxation_as_linear_operator as ref_relax_op
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy

from pyamg_tpu_torch.multilevel import _put
from pyamg_tpu_torch.relaxation import relaxation as rx
from pyamg_tpu_torch.relaxation.chebyshev import \
    chebyshev_polynomial_coefficients
from pyamg_tpu_torch.relaxation.smoothing import apply_smoother, make_smoother
from pyamg_tpu_torch.relaxation.utils import relaxation_as_linear_operator
from pyamg_tpu_torch.sparse.matrix import dia_from_ell, from_scipy

torch.set_num_threads(1)

N = 20


def _matrix(dtype):
    """2-D Poisson N^2 with a symmetric perturbation on its stencil."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    S = to_scipy(poisson((N, N))).tocoo()
    rng = np.random.default_rng(11)
    noise = sp.coo_matrix((0.1 * rng.random(S.nnz), (S.row, S.col)),
                          shape=S.shape)
    return (S + noise + noise.T).tocsr().astype(dtype)


def _splitting():
    return (np.random.default_rng(12).random(N * N) < 0.3).astype(np.int8)


def _custom(A, x, b):
    """A callable smoother: one undamped Richardson step with 0.1."""
    from pyamg_tpu_torch.ops.spmv import matvec
    return x + 0.1 * (b - matvec(A, x))


def _ref_custom(A, x, b):
    from pyamg_tpu.ops.spmv import matvec
    return x + 0.1 * (b - matvec(A, x))


SPECS = [
    ("jacobi", {"omega": 0.8}),
    ("jacobi", {"omega": 4.0 / 3.0, "iterations": 2, "withrho": False}),
    ("richardson", {"omega": 1.0, "iterations": 2}),
    ("gauss_seidel", {"sweep": "forward"}),
    ("gauss_seidel", {"sweep": "backward", "iterations": 2}),
    ("gauss_seidel", {"sweep": "symmetric"}),
    ("sor", {"omega": 1.3, "sweep": "forward"}),
    ("sor", {"omega": 0.8, "sweep": "symmetric"}),
    ("block_gauss_seidel", {"sweep": "symmetric"}),
    ("block_jacobi", {"omega": 0.7}),
    ("chebyshev", {"degree": 3}),
    ("chebyshev", {"degree": 4, "iterations": 2, "lower_bound": 0.1}),
    ("polynomial", {"coefficients": [0.1, -0.5, 1.2]}),
    ("jacobi_ne", {"omega": 0.9, "iterations": 2}),
    ("gauss_seidel_ne", {"sweep": "backward"}),
    ("gauss_seidel_nr", {"omega": 1.1, "iterations": 2}),
    ("cf_jacobi", {"omega": 0.8}),
    ("fc_jacobi", {"iterations": 2, "f_iterations": 2}),
    ("cg", {"maxiter": 3}),
    ("gmres", {"maxiter": 3}),
    ("cgne", {"maxiter": 3}),
    ("cgnr", {"maxiter": 3}),
    ("custom", {}),
]


def _id(spec):
    return spec[0] + "".join(f"-{k}={v}" for k, v in spec[1].items()
                             if k != "coefficients")


def _inputs(dtype, k=1):
    rng = np.random.default_rng(13)
    shape = (N * N,) if k == 1 else (N * N, k)
    return rng.standard_normal(shape).astype(dtype), \
        rng.standard_normal(shape).astype(dtype)


def _reference(spec, S, x, b):
    name, opts = spec
    level = types.SimpleNamespace(splitting=_splitting())
    A = ref_from_scipy(S)
    sm = ref_make(level, A, _ref_custom if name == "custom" else
                  (name, opts))
    return np.asarray(ref_apply(*sm, A, jnp.asarray(x), jnp.asarray(b)))


def _port(spec, S, x, b, layout):
    name, opts = spec
    level = types.SimpleNamespace(splitting=_splitting())
    A = from_scipy(S)
    kind, sopts, params = make_smoother(
        level, A, _custom if name == "custom" else (name, opts))
    op = dia_from_ell(A) if layout == "dia" else A
    assert op is not None
    return apply_smoother(kind, sopts, _put(params, "cpu"), op.to("cpu"),
                          torch.as_tensor(x), torch.as_tensor(b)).numpy()


@pytest.mark.parametrize("layout", ["ell", "dia"])
@pytest.mark.parametrize("spec", SPECS, ids=_id)
def test_smoother_matches_reference_float64(spec, layout):
    S = _matrix(np.float64)
    x, b = _inputs(np.float64)
    want = _reference(spec, S, x, b)
    got = _port(spec, S, x, b, layout)
    assert not np.allclose(want, x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("layout", ["ell", "dia"])
@pytest.mark.parametrize("spec", [SPECS[0], SPECS[6], SPECS[10],
                                  SPECS[13]], ids=_id)
def test_smoother_matches_reference_float32(spec, layout):
    S = _matrix(np.float32)
    x, b = _inputs(np.float32)
    want = _reference(spec, S, x, b)
    got = _port(spec, S, x, b, layout)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("spec", [SPECS[0], SPECS[5], SPECS[6], SPECS[12]],
                         ids=_id)
def test_smoother_on_host_arrays_matches_reference(spec):
    """The setup phase's host (numpy) operands take the same path."""
    S = _matrix(np.float64)
    x, b = _inputs(np.float64)
    name, opts = spec
    A = from_scipy(S)
    got = apply_smoother(*make_smoother(None, A, (name, opts)), A, x, b)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, _reference(spec, S, x, b), rtol=0,
                               atol=1e-12 * np.abs(got).max())


@pytest.mark.parametrize("fn", ["jacobi_indexed", "gauss_seidel_indexed"])
@pytest.mark.parametrize("index", ["array", "mask"])
@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_indexed_smoothers_match_reference(fn, index, layout):
    S = _matrix(np.float64)
    x, b = _inputs(np.float64)
    mask = _splitting().astype(bool)
    idx = mask if index == "mask" else np.flatnonzero(mask)
    kw = {"iterations": 2}
    if fn == "gauss_seidel_indexed":
        kw["sweep"] = "backward"
    want = np.asarray(getattr(ref_rx, fn)(ref_from_scipy(S), jnp.asarray(x),
                                          jnp.asarray(b), jnp.asarray(idx),
                                          **kw))
    A = from_scipy(S)
    op = (dia_from_ell(A) if layout == "dia" else A).to("cpu")
    if fn == "gauss_seidel_indexed":
        kw["colors"], kw["ncolors"] = rx.make_coloring(A)
        kw["Dinv"] = torch.as_tensor(rx.dinv_vec(A))
    got = getattr(rx, fn)(op, torch.as_tensor(x), torch.as_tensor(b),
                          torch.as_tensor(idx), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(got[~mask], x[~mask])


@pytest.mark.parametrize("a, b, degree", [(0.1, 2.0, 3), (1 / 30, 1.1, 5)])
def test_chebyshev_coefficients_match_reference(a, b, degree):
    np.testing.assert_array_equal(chebyshev_polynomial_coefficients(
        a, b, degree), ref_cheb(a, b, degree))


def test_relaxation_as_linear_operator_matches_reference():
    S = _matrix(np.float64)
    v, rhs = _inputs(np.float64)
    spec = ("gauss_seidel", {"sweep": "symmetric", "iterations": 2})
    want = np.asarray(ref_relax_op(spec, ref_from_scipy(S), rhs) @ v)
    op = relaxation_as_linear_operator(spec, from_scipy(S), rhs)
    assert op.shape == S.shape
    np.testing.assert_allclose(op @ v, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_make_smoother_raises_like_reference():
    A = from_scipy(_matrix(np.float64))
    with pytest.raises(ValueError):
        make_smoother(None, A, ("no_such_smoother", {}))
    with pytest.raises(ValueError):
        ref_make(None, ref_from_scipy(_matrix(np.float64)),
                 ("no_such_smoother", {}))
    # Schwarz is ported: a compressed (DIA) or block operator raises
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell
    from pyamg_tpu_torch.gallery import linear_elasticity
    for name in ("schwarz", "strength_based_schwarz"):
        assert make_smoother(None, A, (name, {}))[0] == "schwarz"
        for op in (dia_from_ell(A), linear_elasticity((4, 4))[0]):
            with pytest.raises(TypeError):
                make_smoother(None, op, (name, {}))


READS = ("__bool__", "__float__", "__int__", "__index__", "item", "tolist",
         "numpy")


def forbid_host_reads(monkeypatch):
    """Make every way of reading a tensor on the host raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read on the host")
    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_smoothers_read_nothing_on_the_host(layout, monkeypatch):
    S = _matrix(np.float64)
    A = from_scipy(S)
    op = (dia_from_ell(A) if layout == "dia" else A).to("cpu")
    level = types.SimpleNamespace(splitting=_splitting())
    smoothers = [make_smoother(level, A, _custom if n == "custom" else (n, o))
                 for n, o in SPECS]
    smoothers = [(k, s, _put(p, "cpu")) for k, s, p in smoothers]
    x, b = (torch.as_tensor(v) for v in _inputs(np.float64))
    forbid_host_reads(monkeypatch)
    for sm in smoothers:
        x = apply_smoother(*sm, op, x, b)
    monkeypatch.undo()
    assert bool(torch.isfinite(x).all())
