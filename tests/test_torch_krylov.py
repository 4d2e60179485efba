"""The port's Krylov methods against the JAX package's, on the CPU.

Each method runs on the same float64 system from a numpy seed, with and
without a Jacobi preconditioner: the symmetric ones on 2-D Poisson 12^2,
GMRES, FGMRES, BiCGStab, CGNE and CGNR on a nonsymmetric
convection-diffusion operator of the same size.  Equal ``info`` and
iteration counts, x and the residual history to 1e-8 relative; the
float32 run of each holds ``info`` and x to 1e-5.  A CPU count of host
reads shows each loop reads the host once per iteration (and a few
times in all around it).
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu import krylov as ref_krylov
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy

from pyamg_tpu_torch import krylov
from pyamg_tpu_torch.krylov.gmres import gmres_loop
from pyamg_tpu_torch.sparse.matrix import dia_from_ell, from_scipy

from test_torch_relaxation import READS

torch.set_num_threads(1)

N = 12


def _system(symmetric, dtype=np.float64):
    I = sp.identity(N)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N))
    S = sp.kron(I, T) + sp.kron(T, I)
    if not symmetric:
        C = sp.diags([-1.0, 1.0], [-1, 1], shape=(N, N))
        S = S + 0.4 * (sp.kron(I, C) + 0.5 * sp.kron(C, I))
    S = S.tocsr().astype(dtype)
    b = np.random.default_rng(21).standard_normal(S.shape[0]).astype(dtype)
    return S, b


def _jacobi(S, ref):
    d = 1.0 / S.diagonal()
    if ref:
        dj = jnp.asarray(d)
        return types.SimpleNamespace(matvec=lambda v: dj * v, shape=S.shape)
    dt = torch.as_tensor(d)
    return types.SimpleNamespace(matvec=lambda v: dt * v, shape=S.shape)


CASES = [
    ("cg", True, {}), ("cg", True, {"criteria": "rr+"}),
    ("cr", True, {}), ("cr", True, {"criteria": "MrMr"}),
    # minimal residual amplifies rounding differences tenfold every few
    # steps once it stagnates: 30 steps keep the two histories within
    # 1e-8 (they agree to 1e-15 for the first 14)
    ("minimal_residual", True, {"maxiter": 30}),
    ("steepest_descent", True, {"maxiter": 60, "criteria": "rMr"}),
    ("bicgstab", False, {}), ("bicgstab", False, {"criteria": "rr+"}),
    ("cgne", False, {}), ("cgnr", False, {}),
    ("gmres", False, {}), ("gmres", False, {"orthog": "cgs2"}),
    ("gmres", False, {"orthog": "householder"}),
    ("gmres", False, {"restart": 8, "maxiter": 6}),
    ("gmres_mgs", False, {"restart": 8, "maxiter": 6}),
    ("gmres_householder", False, {"restart": 8, "maxiter": 6}),
    ("fgmres", False, {}), ("fgmres", False, {"restart": 8, "maxiter": 6}),
]


def _id(case):
    name, _, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("precond", [False, True], ids=["M=None", "M=jacobi"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_method_matches_reference(case, precond):
    name, symmetric, kw = case
    S, b = _system(symmetric)
    tol = 1e-10
    want_res, got_res = [], []
    want, want_info = getattr(ref_krylov, name)(
        ref_from_scipy(S), b, tol=tol, residuals=want_res,
        M=_jacobi(S, True) if precond else None, **kw)
    got, info = getattr(krylov, name)(
        from_scipy(S), b, tol=tol, residuals=got_res, device="cpu",
        M=_jacobi(S, False) if precond else None, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert info == want_info and len(got_res) == len(want_res) > 2
    want_res = np.asarray(want_res)
    np.testing.assert_allclose(got_res, want_res, rtol=1e-8,
                               atol=1e-8 * want_res[0])
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("case", [CASES[0], CASES[6], CASES[10],
                                  CASES[16]], ids=_id)
def test_method_matches_reference_float32(case):
    name, symmetric, kw = case
    S, b = _system(symmetric, np.float32)
    want, want_info = getattr(ref_krylov, name)(ref_from_scipy(S), b,
                                                tol=1e-5, **kw)
    got, info = getattr(krylov, name)(from_scipy(S), b, tol=1e-5,
                                      device="cpu", **kw)
    assert got.dtype == torch.float32 and info == want_info
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres", "cgnr", "cgne"])
def test_operators_stay_where_they_are(name):
    """A placed DIA (K1's plain version here) and a dense tensor give the
    host ELL's result; b follows the operator."""
    S, b = _system(name == "cg")
    want, info = getattr(krylov, name)(from_scipy(S), b, tol=1e-10,
                                       device="cpu")
    for A in (dia_from_ell(from_scipy(S)).to("cpu"),
              torch.as_tensor(S.toarray())):
        got, info2 = getattr(krylov, name)(A, b, tol=1e-10)
        assert info2 == info
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-10 * want.abs().max().item())


def test_host_operator_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    S, b = _system(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        krylov.cg(from_scipy(S), b)


def test_callback_sees_every_iteration():
    S, b = _system(False)
    seen, res = [], []
    x, info = krylov.bicgstab(from_scipy(S), b, tol=1e-10, device="cpu",
                              callback=seen.append, residuals=res)
    assert info == 0 and len(seen) == len(res) - 1
    assert torch.equal(seen[-1], x)


def _count_reads(monkeypatch):
    counts = {"n": 0}
    for name in READS:
        real = getattr(torch.Tensor, name)

        def counted(*args, _real=real, **kwargs):
            counts["n"] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return counts


@pytest.mark.parametrize("name", ["cg", "bicgstab", "cr", "minimal_residual",
                                  "steepest_descent", "gmres", "fgmres"])
def test_one_host_read_per_iteration(name, monkeypatch):
    """The loop reads one stop flag per iteration; the set-up and the
    result (``info`` and the residual list) read a few more."""
    S, b = _system(name in ("cg", "cr", "minimal_residual",
                            "steepest_descent"))
    A = from_scipy(S).to("cpu")
    bt = torch.as_tensor(b)
    counts = _count_reads(monkeypatch)
    x, info = getattr(krylov, name)(A, bt, tol=1e-10, maxiter=200)
    reads = counts["n"]
    monkeypatch.undo()
    res = []
    getattr(krylov, name)(A, bt, tol=1e-10, maxiter=200, residuals=res)
    iterations = len(res) - 1
    assert iterations > 5 and iterations <= reads <= iterations + 3


def test_gmres_loop_keeps_one_basis(monkeypatch):
    """The basis is allocated once per call, (restart + 1, n)."""
    S, b = _system(False)
    A = torch.as_tensor(S.toarray())
    bt = torch.as_tensor(b)
    made = []
    real = torch.zeros

    def zeros(*shape, **kw):
        out = real(*shape, **kw)
        if out.ndim == 2 and out.shape[1] == S.shape[0]:
            made.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "zeros", zeros)
    x, info, _, nres = gmres_loop(lambda v: A @ v, lambda v: v,
                                  torch.zeros_like(bt), bt, 1e-8, 20, 10)
    monkeypatch.undo()
    assert int(info) == 0 and nres > 21 and made == [(21, S.shape[0])]
