"""Fixed-iteration Krylov smoothers and coarse solvers (counterpart of
``pyamg_tpu/krylov/inner.py``).

Each runs a fixed number of steps from x, with no stop test: nothing is
read on the host, and the products go through the operator's kernel (K1
on a DIA, K3 on a SELL).
"""

from __future__ import annotations

import torch

from pyamg_tpu_torch.ops.spmv import matvec


def _safe(d):
    return torch.where(d == 0, 1, d)


def _rdot(a, b):
    return torch.real(torch.vdot(a, b))


def inner_cg(A, x, b, iterations):
    """``iterations`` CG steps on A x = b."""
    r = b - matvec(A, x)
    p = r
    rr = _rdot(r, r)
    for _ in range(iterations):
        Ap = matvec(A, p)
        alpha = rr / _safe(_rdot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rrn = _rdot(r, r)
        p = r + (rrn / _safe(rr)) * p
        rr = rrn
    return x


def inner_cgne(A, AH, x, b, iterations):
    """``iterations`` CGNE (Craig) steps: CG on A A^H y = b, x = A^H y;
    ``AH`` is A's conjugate transpose, built at setup."""
    r = b - matvec(A, x)
    p = matvec(AH, r)
    rr = _rdot(r, r)
    for _ in range(iterations):
        alpha = rr / _safe(_rdot(p, p))
        x = x + alpha * p
        r = r - alpha * matvec(A, p)
        rrn = _rdot(r, r)
        p = matvec(AH, r) + (rrn / _safe(rr)) * p
        rr = rrn
    return x


def inner_cgnr(A, AH, x, b, iterations):
    """``iterations`` CGNR steps: CG on A^H A x = A^H b."""
    r = b - matvec(A, x)
    z = matvec(AH, r)
    p = z
    zz = _rdot(z, z)
    for _ in range(iterations):
        Ap = matvec(A, p)
        alpha = zz / _safe(_rdot(Ap, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = matvec(AH, r)
        zzn = _rdot(z, z)
        p = z + (zzn / _safe(zz)) * p
        zz = zzn
    return x


def inner_gmres(A, x, b, iterations):
    """``iterations`` minimal-residual steps (GMRES(1) repeated)."""
    for _ in range(iterations):
        r = b - matvec(A, x)
        Ar = matvec(A, r)
        x = x + torch.vdot(Ar, r) / _safe(_rdot(Ar, Ar)) * r
    return x
