"""Norms, spectral and condition estimates, the Hermitian test and the
batched pseudo-inverse (counterpart of ``pyamg_tpu/util/linalg.py``;
setup phase).

Restarted Arnoldi on the host with numpy: the Ritz value of largest
magnitude of the small Hessenberg matrix estimates rho(A).
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import BELL, ELL
from pyamg_tpu_torch.ops.spmv import matvec


def norm(x, pnorm="2"):
    """The 2-norm (``'2'``) or the largest magnitude (``'inf'``) of a
    vector, as a numpy scalar for an array and a tensor for a tensor
    (reference ``linalg.py:13``)."""
    if isinstance(x, torch.Tensor):
        if pnorm == "2":
            return torch.sqrt(torch.real(torch.vdot(x.reshape(-1),
                                                    x.reshape(-1))))
        if pnorm == "inf":
            return torch.max(torch.abs(x))
    else:
        x = np.asarray(x)
        if pnorm == "2":
            return np.sqrt(np.real(np.vdot(x, x)))
        if pnorm == "inf":
            return np.max(np.abs(x))
    raise ValueError(f"unsupported norm {pnorm!r}")


def infinity_norm(A) -> float:
    """The largest row sum of |A| (reference ``linalg.py:53``)."""
    if isinstance(A, BELL):
        from pyamg_tpu_torch.sparse.matrix import to_scipy
        return float(abs(to_scipy(A)).sum(axis=1).max())
    if isinstance(A, ELL):
        return float(np.max(np.sum(np.abs(np.asarray(A.vals)), axis=1)))
    return float(np.abs(np.asarray(A)).sum(axis=1).max())


def _as_matvec(A):
    """(matvec, n, dtype) of a host ELL or BELL, of an object with
    ``matvec``, ``shape`` and ``dtype``, or of a dense array."""
    if isinstance(A, (ELL, BELL)):
        return (lambda v: matvec(A, v)), A.shape[0], A.dtype
    if callable(getattr(A, "matvec", None)):
        return A.matvec, A.shape[0], getattr(A, "dtype", np.float64)
    A = np.asarray(A)
    return (lambda v: A @ v), A.shape[0], A.dtype


def _arnoldi(mv, n, maxiter, v0):
    """Arnoldi with classical Gram-Schmidt applied twice: (H, V,
    breakdown)."""
    V = np.empty((maxiter + 1, n), dtype=v0.dtype)
    V[0] = v0 / float(np.sqrt(np.real(np.vdot(v0, v0))))
    H = np.zeros((maxiter + 1, maxiter),
                 dtype=np.complex128 if np.iscomplexobj(v0) else np.float64)
    breakdown = False
    k = maxiter
    for j in range(maxiter):
        w = np.asarray(mv(V[j]))
        Vj = V[:j + 1]
        h1 = Vj.conj() @ w
        w = w - Vj.T @ h1
        h2 = Vj.conj() @ w
        w = w - Vj.T @ h2
        H[:j + 1, j] = h1 + h2
        beta = float(np.linalg.norm(w))
        H[j + 1, j] = beta
        if beta < 1e-14 * max(1.0, abs(H[j, j])):
            breakdown = True
            k = j + 1
            break
        V[j + 1] = w / beta
    return H[:k + 1, :k], V[:k + 1], breakdown


def approximate_spectral_radius(A, tol=0.01, maxiter=15, restart=5,
                                symmetric=None, initial_guess=None,
                                return_vector=False, seed=0):
    """Estimate rho(A): restart from the dominant Ritz vector until the
    eigen-residual estimate ``H[k, k-1] * evect[-1]`` is below ``tol``
    relative (reference ``util/linalg.py:255``).  The start vector is
    ``initial_guess``, else drawn from ``default_rng(seed)``; with
    ``return_vector`` returns (rho, the last Ritz vector).  ``symmetric``
    is accepted and ignored, as the JAX package does (Arnoldi serves
    both)."""
    mv, n, dtype = _as_matvec(A)
    if initial_guess is None:
        rng = np.random.default_rng(seed)
        v0 = rng.random(n)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            v0 = v0 + 1j * rng.random(n)
    else:
        v0 = np.asarray(initial_guess).reshape(-1)
    vec = np.asarray(v0, dtype=dtype)
    ev_max = 0.0
    for _ in range(restart + 1):
        H, V, breakdown = _arnoldi(mv, n, maxiter, vec)
        k = H.shape[1]
        if k == 0:
            break
        evals, evects = np.linalg.eig(H[:k, :k])
        mi = int(np.abs(evals).argmax())
        ev_max = float(np.abs(evals[mi]))
        err = abs(H[k, k - 1] * evects[-1, mi]) if H.shape[0] > k else 0.0
        Vm = V[:k].T
        vec = Vm @ np.asarray(evects[:, mi], dtype=Vm.dtype)
        if breakdown or (ev_max > 0 and err / ev_max < tol):
            break
    if return_vector:
        return ev_max, vec
    return ev_max


def condest(A, maxiter=25, symmetric=False, seed=0):
    """A rough 2-norm condition estimate: the ratio of the largest to the
    smallest Ritz value magnitude of ``min(maxiter, n)`` Arnoldi steps
    from ``default_rng(seed)`` (reference ``linalg.py:384``)."""
    mv, n, dtype = _as_matvec(A)
    v0 = np.asarray(np.random.default_rng(seed).random(n), dtype=dtype)
    H, _, _ = _arnoldi(mv, n, min(maxiter, n), v0)
    k = H.shape[1]
    ev = np.linalg.eigvals(H[:k, :k])
    return float(np.abs(ev).max() / np.abs(ev).min())


def ishermitian(A, fast_check=True, tol=1e-6, seed=0):
    """Whether A is Hermitian.  ``fast_check``: the probe of reference
    ``linalg.py:479``, ``|<x, A y> - <A x, y>| / (||A x|| ||y||) < tol``
    with x then y drawn by ``default_rng(seed).random`` in A's dtype;
    else the largest entry of ``|A - A^H|`` below tol."""
    mv, n, dtype = _as_matvec(A)
    if fast_check:
        rng = np.random.default_rng(seed)
        x = np.asarray(rng.random(n), dtype=dtype)
        y = np.asarray(rng.random(n), dtype=dtype)
        Ax = np.asarray(mv(x))
        lhs = complex(np.vdot(x, np.asarray(mv(y))))
        rhs = complex(np.vdot(Ax, y))
        scale = float(norm(Ax) * norm(y)) + 1e-300
        return bool(abs(lhs - rhs) / scale < tol)
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    M = to_scipy(A) if isinstance(A, (ELL, BELL)) else np.asarray(A)
    return bool(abs(M - M.conj().T).max() < tol)


def pinv_array(blocks, tol=None):
    """Pseudo-inverses of a batch of small square blocks, (m, k, k) ->
    (m, k, k); 1 x 1 blocks invert elementwise (0 stays 0).  ``tol`` is
    accepted and ignored, as the JAX package does (numpy's default
    cutoff)."""
    blocks = np.asarray(blocks)
    if blocks.shape[-1] == 1:
        d = blocks[..., 0, 0]
        inv = np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        return inv[..., None, None]
    return np.linalg.pinv(blocks)
