"""Krylov methods: CG, BiCGStab, CGNE, CGNR, CR, minimal residual and
steepest descent (counterpart of ``pyamg_tpu/krylov/methods.py``).

The reference runs each iteration as one ``lax.while_loop``.  Here it is
a Python loop over tensor ops: every scalar stays on the device, and the
host reads one flag per iteration to decide whether to go on (and the
final ``info`` once).  ``callback(x)`` is called after every iteration.
"""

from __future__ import annotations

import torch

from pyamg_tpu_torch._device import as_tensor
from pyamg_tpu_torch.krylov.common import (
    LOCAL, as_matvec, as_precond, dot, final_info, finalize, norm, place,
    prepare, real_dtype, torch_dtype)
from pyamg_tpu_torch.sparse.matrix import DIA, ELL
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.ops.spmv import matvec as sp_matvec


def _rtol(criteria, tol, normb, normMb, fro, x0norm):
    """Stopping threshold of ``criteria`` (``x0norm()``: ||x0||, taken
    only for 'rr+')."""
    if criteria == "rr":
        return tol * normb
    if criteria == "rr+":
        if fro is None:
            raise ValueError("criteria 'rr+' needs ||A||_F")
        froA = fro() if callable(fro) else fro
        return tol * (froA * x0norm() + normb)
    if criteria == "MrMr":
        return tol * normMb
    if criteria == "rMr":
        return tol
    raise ValueError(f"invalid stopping criteria {criteria!r}")


def cg_loop(mv, Mv, x, b, tol, criteria, maxiter, fro=1.0,
            stall_window=8, callback=None, red=LOCAL):
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
    iteration.  ``red``: the inner products (``common.Reduction``;
    summed over the ranks on a row-sharded level, so that every rank reads
    the same stop flag).
    """
    rdt = real_dtype(b.dtype)
    normb = red.norm(b)
    normb = torch.where(normb == 0, 1.0, normb)
    normMb = red.norm(Mv(b)) if criteria == "MrMr" else None
    r = b - mv(x)
    z = Mv(r)
    p = z
    rz = torch.real(red.dot(r, z))
    nr0 = red.norm(r)
    normr0 = (nr0 if criteria != "MrMr" else red.norm(z)).to(rdt)
    rtol = _rtol(criteria, tol, normb, normMb, fro, lambda: red.norm(x))
    resbuf = torch.zeros((maxiter + 1,), dtype=rdt, device=b.device)
    resbuf[0] = nr0
    minr, imp_it, xb = normr0, torch.zeros((), dtype=torch.int32,
                                           device=b.device), x
    info = torch.zeros((), dtype=torch.int32, device=b.device)
    done = bool(normr0 < rtol)
    it = 0
    while not done and it < maxiter:
        Ap = mv(p)
        pAp = torch.real(red.dot(Ap, p))
        bad_A = pAp <= 0.0
        alpha = rz / torch.where(pAp == 0, 1, pAp)
        xn = x + alpha * p
        rn = b - mv(xn) if (it + 1) % 8 == 0 else r - alpha * Ap
        zn = Mv(rn)
        rzn = torch.real(red.dot(rn, zn))
        bad_M = rzn < 0.0
        beta = rzn / torch.where(rz == 0, 1, rz)
        p = zn + beta * p
        it += 1
        nrn = red.norm(rn)
        if criteria == "MrMr":
            normr = red.norm(zn)
        elif criteria == "rMr":
            normr = torch.sqrt(torch.clamp(rzn, min=0.0))
        else:
            normr = nrn
        resbuf[it] = nrn
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


def _criteria_fns(criteria, tol, b, x0, Mv, fro, allowed):
    """(measure(r), rtol) of ``criteria``; raises for criteria a method
    does not admit."""
    if criteria not in allowed:
        raise ValueError(f"invalid stopping criteria {criteria!r}")
    normb = norm(b)
    normb = torch.where(normb == 0, 1.0, normb)
    if criteria == "rr":
        return norm, tol * normb
    if criteria == "rr+":
        if fro is None:
            raise ValueError(
                "criteria 'rr+' needs a matrix with accessible entries")
        froA = fro() if callable(fro) else fro
        return norm, tol * (froA * norm(x0) + normb)
    if criteria == "MrMr":
        return (lambda r: norm(Mv(r))), tol * norm(Mv(b))
    return (lambda r: torch.sqrt(torch.clamp(torch.real(dot(r, Mv(r))),
                                             min=0.0))), tol


def _resbuf(maxiter, b, r0):
    buf = torch.zeros((maxiter + 1,), dtype=real_dtype(b.dtype),
                      device=b.device)
    buf[0] = norm(r0)
    return buf


def _zero_info(b):
    return torch.zeros((), dtype=torch.int32, device=b.device)


def cg(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
       callback=None, residuals=None, device=None):
    """Preconditioned conjugate gradients: ``cg_loop`` (best iterate,
    stall test, true residual every 8th iteration).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.krylov import cg
    >>> A = poisson((10, 10))
    >>> x, info = cg(A, np.ones(100), tol=1e-8, maxiter=100, device="cpu")
    >>> info
    0
    """
    A, mv, n, fro, b, x, maxiter = prepare(A, b, x0, maxiter, device)
    Mv = as_precond(M, b.device)
    x, info, resbuf, nres = cg_loop(mv, Mv, x, b, tol, criteria, maxiter,
                                    fro, callback=callback)
    finalize(residuals, resbuf, nres)
    return x, int(info)


def bicgstab(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
             callback=None, residuals=None, device=None):
    """Preconditioned BiCGStab; ``info`` -1 when a denominator vanishes."""
    A, mv, n, fro, b, x, maxiter = prepare(A, b, x0, maxiter, device)
    Mv = as_precond(M, b.device)
    meas, rtol = _criteria_fns(criteria, tol, b, x, Mv, fro, ("rr", "rr+"))
    r = b - mv(x)
    rstar, p = r, r
    rrstar = dot(rstar, r)
    resbuf = _resbuf(maxiter, b, r)
    info = _zero_info(b)
    done = bool(meas(r) < rtol)
    it = 0
    while not done and it < maxiter:
        Mp = Mv(p)
        AMp = mv(Mp)
        denom = dot(rstar, AMp)
        alpha = rrstar / torch.where(denom == 0, 1, denom)
        s = r - alpha * AMp
        Ms = Mv(s)
        AMs = mv(Ms)
        d2 = torch.real(dot(AMs, AMs))
        omega = dot(AMs, s) / torch.where(d2 == 0, 1, d2)
        x = x + alpha * Mp + omega * Ms
        rn = s - omega * AMs
        rrstar_n = dot(rstar, rn)
        beta = (rrstar_n / torch.where(rrstar == 0, 1, rrstar)) * \
            (alpha / torch.where(omega == 0, 1, omega))
        p = rn + beta * (p - omega * AMp)
        r, rrstar = rn, rrstar_n
        it += 1
        resbuf[it] = norm(r)
        conv = meas(r) < rtol
        brk = (denom == 0) | (omega == 0)
        info = torch.where(brk, -1, torch.where(conv, 0, info))
        if callback is not None:
            callback(x)
        done = bool(conv | brk)            # the one host read
    finalize(residuals, resbuf, it + 1)
    return x, final_info(info, it, maxiter, done)


def _dia_adjoint(A):
    """A^H of a placed DIA as a DIA on the same device (its diagonals
    shifted by their offsets, offsets negated and sorted)."""
    n = A.shape[0]
    out = torch.zeros_like(A.data)
    for d, o in enumerate(A.offsets):
        lo, hi = max(0, o), min(n, n + o)
        if hi > lo:
            out[d, lo:hi] = A.data[d, lo - o:hi - o].conj()
    order = sorted(range(len(A.offsets)), key=lambda d: -A.offsets[d])
    return DIA(out[order].contiguous(), tuple(-A.offsets[d] for d in order),
               (A.shape[1], A.shape[0]))


def _normal_equations(A):
    """(v -> A v, v -> A^H v) of a placed ELL or DIA, an operator with
    ``matvec`` and ``rmatvec``, or a dense tensor."""
    if isinstance(A, ELL):
        def mvAH(v):
            out = torch.zeros((A.shape[1],), dtype=v.dtype, device=v.device)
            return out.index_add_(0, A.cols.reshape(-1),
                                  (A.vals.conj() * v[:, None]).reshape(-1))
        return (lambda v: sp_matvec(A, v)), mvAH
    if isinstance(A, DIA):
        AH = _dia_adjoint(A)
        return (lambda v: sp_matvec(A, v)), (lambda v: sp_matvec(AH, v))
    if isinstance(A, SELL):
        raise TypeError("the normal equations need A^H; a SELL operator has "
                        "none (pass its ELL original)")
    if hasattr(A, "matvec") and hasattr(A, "rmatvec"):
        return A.matvec, A.rmatvec
    return (lambda v: A @ v), (lambda v: A.conj().T @ v)


class _NormalOp:
    """The operator v -> outer(inner(v)) of the normal equations, with the
    original A's Frobenius norm for 'rr+'."""

    def __init__(self, outer, inner, n, dtype, fro):
        self.shape = (n, n)
        self.dtype = dtype
        self.fro = fro
        self.matvec = lambda v: outer(inner(v))


def _placed(A, b, device):
    A, dev = place(A, device)
    if dev is None:
        raise TypeError("the normal equations take a matrix or an operator "
                        "with matvec and rmatvec already placed")
    _, _, dtype, fro = as_matvec(A)
    return A, dev, fro, as_tensor(b, dev, torch_dtype(dtype)).reshape(-1)


def cgne(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
         callback=None, residuals=None, device=None):
    """CG on A A^H y = b - A x0, x = x0 + A^H y (Craig's method)."""
    A, dev, fro, b = _placed(A, b, device)
    mvA, mvAH = _normal_equations(A)
    r = b if x0 is None else b - mvA(torch.as_tensor(
        x0, dtype=b.dtype, device=dev).reshape(-1))
    op = _NormalOp(mvA, mvAH, A.shape[0], b.dtype, fro)
    cb = None if callback is None else (lambda y: callback(mvAH(y)))
    y, info = cg(op, r, tol=tol, criteria=criteria, maxiter=maxiter, M=M,
                 callback=cb, residuals=residuals)
    x = mvAH(y)
    return (x if x0 is None else x + torch.as_tensor(
        x0, dtype=b.dtype, device=dev).reshape(-1)), info


def cgnr(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
         callback=None, residuals=None, device=None):
    """CG on A^H A x = A^H b."""
    A, dev, fro, b = _placed(A, b, device)
    mvA, mvAH = _normal_equations(A)
    op = _NormalOp(mvAH, mvA, A.shape[1], b.dtype, fro)
    return cg(op, mvAH(b), x0=x0, tol=tol, criteria=criteria,
              maxiter=maxiter, M=M, callback=callback, residuals=residuals)


def cr(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
       callback=None, residuals=None, device=None):
    """Preconditioned conjugate residuals; the residual history is that
    of the true residual b - A x."""
    A, mv, n, fro, b, x, maxiter = prepare(A, b, x0, maxiter, device)
    Mv = as_precond(M, b.device)
    meas, rtol = _criteria_fns(criteria, tol, b, x, Mv, fro,
                               ("rr", "rr+", "MrMr"))
    r0 = b - mv(x)
    r = Mv(r0)
    p = r
    rAr = dot(r, mv(r))
    resbuf = _resbuf(maxiter, b, r0)
    info = _zero_info(b)
    done = bool(meas(r0) < rtol)
    it = 0
    while not done and it < maxiter:
        Ap = mv(p)
        MAp = Mv(Ap)
        d = torch.real(dot(Ap, MAp))
        alpha = rAr / torch.where(d == 0, 1, d)
        x = x + alpha * p
        r = r - alpha * MAp
        rArn = dot(r, mv(r))
        beta = rArn / torch.where(rAr == 0, 1, rAr)
        p = r + beta * p
        rAr = rArn
        it += 1
        rtrue = b - mv(x)
        resbuf[it] = norm(rtrue)
        conv = meas(rtrue) < rtol
        info = torch.where(conv, 0, info)
        if callback is not None:
            callback(x)
        done = bool(conv | (d == 0))       # the one host read
    finalize(residuals, resbuf, it + 1)
    return x, final_info(info, it, maxiter, done)


def _descent(A, b, x0, tol, criteria, maxiter, M, callback, residuals,
             device, step):
    """The one-direction methods: x += alpha z with (z, alpha, stop) from
    ``step(r, Mv, mv)``; ``info`` -1 where ``step`` says so."""
    A, mv, n, fro, b, x, maxiter = prepare(A, b, x0, maxiter, device)
    Mv = as_precond(M, b.device)
    meas, rtol = _criteria_fns(criteria, tol, b, x, Mv, fro,
                               ("rr", "rr+", "MrMr", "rMr"))
    r = b - mv(x)
    resbuf = _resbuf(maxiter, b, r)
    info = _zero_info(b)
    done = bool(meas(r) < rtol)
    it = 0
    while not done and it < maxiter:
        z, alpha, brk, bad = step(r, Mv, mv)
        x = x + alpha * z
        it += 1
        r = b - mv(x)
        resbuf[it] = norm(r)
        conv = meas(r) < rtol
        info = torch.where(conv, 0, torch.where(bad, -1, info))
        if callback is not None:
            callback(x)
        done = bool(conv | brk)            # the one host read
    finalize(residuals, resbuf, it + 1)
    return x, final_info(info, it, maxiter, done)


def minimal_residual(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None,
                     M=None, callback=None, residuals=None, device=None):
    """Minimal residual iteration: z = M r, alpha = <Az, z> / <Az, Az>."""
    def step(r, Mv, mv):
        z = Mv(r)
        Az = mv(z)
        d = torch.real(dot(Az, Az))
        return z, dot(Az, z) / torch.where(d == 0, 1, d), d == 0, \
            torch.zeros_like(d == 0)

    return _descent(A, b, x0, tol, criteria, maxiter, M, callback,
                    residuals, device, step)


def steepest_descent(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None,
                     M=None, callback=None, residuals=None, device=None):
    """Steepest descent: z = M r, alpha = <r, z> / <Az, z>; ``info`` -1
    where <Az, z> <= 0."""
    def step(r, Mv, mv):
        z = Mv(r)
        d = torch.real(dot(mv(z), z))
        return z, dot(r, z) / torch.where(d == 0, 1, d), d <= 0, d <= 0

    return _descent(A, b, x0, tol, criteria, maxiter, M, callback,
                    residuals, device, step)
