"""Preconditioned conjugate gradients (counterpart of ``cg_loop`` in
``pyamg_tpu/krylov/methods.py``).

The reference runs the iteration as one ``lax.while_loop``.  Here it is
a Python loop over tensor ops: every scalar stays on the device, and the
host reads one flag per iteration to decide whether to go on.
"""

from __future__ import annotations

import torch

from pyamg_tpu_torch.krylov.common import dot, norm, real_dtype


def _rtol(criteria, tol, normb, normMb, fro, x0norm):
    """Stopping threshold of ``criteria``."""
    if criteria == "rr":
        return tol * normb
    if criteria == "rr+":
        if fro is None:
            raise ValueError("criteria 'rr+' needs ||A||_F")
        froA = fro() if callable(fro) else fro
        return tol * (froA * x0norm + normb)
    if criteria == "MrMr":
        return tol * normMb
    if criteria == "rMr":
        return tol
    raise ValueError(f"invalid stopping criteria {criteria!r}")


def cg_loop(mv, Mv, x, b, tol, criteria, maxiter, fro=1.0,
            stall_window=8, callback=None):
    """Preconditioned CG from ``x``: ``(x_best, info, resbuf, nres)``.

    ``info`` is 0 on convergence, -1 on a curvature breakdown, and the
    iteration count when ``maxiter`` ran out.  ``resbuf[:nres]`` holds
    the 2-norm residual history.  The true residual is recomputed every
    8th iteration.  ``stall_window``: stop once the running-minimum
    residual has not improved by 1% for this many iterations (after it
    first fell below 10% of the start): f32 CG reaches its rounding floor
    before tight tolerances.  The best iterate seen is returned, because
    the 2-norm residual of CG is not monotone.  0 disables the stall
    test.  ``callback(x)`` is called with the iterate after every
    iteration.
    """
    rdt = real_dtype(b.dtype)
    normb = norm(b)
    normb = torch.where(normb == 0, 1.0, normb)
    normMb = norm(Mv(b)) if criteria == "MrMr" else None
    r = b - mv(x)
    z = Mv(r)
    p = z
    rz = torch.real(dot(r, z))
    normr0 = (norm(r) if criteria != "MrMr" else norm(z)).to(rdt)
    rtol = _rtol(criteria, tol, normb, normMb, fro, norm(x))
    resbuf = torch.zeros((maxiter + 1,), dtype=rdt, device=b.device)
    resbuf[0] = norm(r)
    minr, imp_it, xb = normr0, torch.zeros((), dtype=torch.int32,
                                           device=b.device), x
    info = torch.zeros((), dtype=torch.int32, device=b.device)
    done = bool(normr0 < rtol)
    it = 0
    while not done and it < maxiter:
        Ap = mv(p)
        pAp = torch.real(dot(Ap, p))
        bad_A = pAp <= 0.0
        alpha = rz / torch.where(pAp == 0, 1, pAp)
        xn = x + alpha * p
        rn = b - mv(xn) if (it + 1) % 8 == 0 else r - alpha * Ap
        zn = Mv(rn)
        rzn = torch.real(dot(rn, zn))
        bad_M = rzn < 0.0
        beta = rzn / torch.where(rz == 0, 1, rz)
        p = zn + beta * p
        it += 1
        if criteria == "MrMr":
            normr = norm(zn)
        elif criteria == "rMr":
            normr = torch.sqrt(torch.clamp(rzn, min=0.0))
        else:
            normr = norm(rn)
        resbuf[it] = norm(rn)
        conv = normr < rtol
        better = normr < minr
        xb = torch.where(better, xn, xb)
        improved = normr < 0.99 * minr
        minr = torch.where(better, normr, minr)
        imp_it = torch.where(improved, it, imp_it)
        stalled = (it - imp_it >= stall_window) & (minr < 0.1 * normr0) \
            if stall_window > 0 else torch.zeros_like(conv)
        stop = conv | bad_A | bad_M | stalled
        info = torch.where(bad_A | bad_M, -1, torch.where(conv, 0, info))
        x = torch.where(bad_A, x, xn)
        if callback is not None:
            callback(x)
        r, z, rz = rn, zn, rzn
        done = bool(stop)          # the one host read of the iteration
    if not done and it >= maxiter and int(info) == 0:
        info = torch.full_like(info, it)
    return xb, info, resbuf, it + 1
