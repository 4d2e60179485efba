"""Spectral radius estimate and batched pseudo-inverse (counterpart of
``approximate_spectral_radius`` and ``pinv_array`` in
``pyamg_tpu/util/linalg.py``; setup phase).

Restarted Arnoldi on the host with numpy: the Ritz value of largest
magnitude of the small Hessenberg matrix estimates rho(A).
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL
from pyamg_tpu_torch.ops.spmv import matvec


def _as_matvec(A):
    """(matvec, n, dtype) of a host ELL or BELL or of an object with
    ``matvec``, ``shape`` and ``dtype``."""
    if isinstance(A, (ELL, BELL)):
        return (lambda v: matvec(A, v)), A.shape[0], A.dtype
    return A.matvec, A.shape[0], A.dtype


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
                                seed=0):
    """Estimate rho(A): restart from the dominant Ritz vector until the
    eigen-residual estimate ``H[k, k-1] * evect[-1]`` is below ``tol``
    relative (reference ``util/linalg.py:255``)."""
    mv, n, dtype = _as_matvec(A)
    rng = np.random.default_rng(seed)
    v0 = rng.random(n)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        v0 = v0 + 1j * rng.random(n)
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
    return ev_max


def pinv_array(blocks):
    """Pseudo-inverses of a batch of small square blocks, (m, k, k) ->
    (m, k, k); 1 x 1 blocks invert elementwise (0 stays 0)."""
    blocks = np.asarray(blocks)
    if blocks.shape[-1] == 1:
        d = blocks[..., 0, 0]
        inv = np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        return inv[..., None, None]
    return np.linalg.pinv(blocks)
