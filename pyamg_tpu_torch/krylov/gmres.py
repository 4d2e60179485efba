"""Restarted GMRES, FGMRES and Householder GMRES (counterpart of
``pyamg_tpu/krylov/gmres.py``).

Left-preconditioned GMRES records the preconditioned residual norms, as
the reference does; FGMRES is right-preconditioned and flexible.  The
Arnoldi step orthogonalizes by classical Gram-Schmidt applied twice
(``orthog="cgs2"``: two products with the basis so far, what
``MultilevelSolver.solve(accel="gmres")`` uses) or by sequential modified
Gram-Schmidt (``"mgs"``, the default of ``gmres``).

The loops are Python over tensor ops.  The basis is allocated once per
call as ``(restart + 1, n)``; the Hessenberg matrix, the Givens rotations
and the residual estimate stay on the device.  The host reads the
estimate's stop flags once per Arnoldi step, once when a later restart
begins (its true preconditioned residual may already be below the
tolerance) and once for the final ``info``.
"""

from __future__ import annotations

from functools import partial

import torch

from pyamg_tpu_torch.krylov.common import (LOCAL, as_precond, finalize,
                                           norm, prepare, real_dtype)

TINY = 1e-300      # the reference's breakdown threshold (0 in float32)


def _conj(v):
    return v.conj() if v.is_complex() else v


def _givens(a, b):
    """A Givens rotation zeroing b against a: (c, s, r)."""
    absa, absb = torch.abs(a), torch.abs(b)
    r = torch.sqrt(absa ** 2 + absb ** 2)
    safe = r > 0
    rs = torch.where(safe, r, 1)
    c = torch.where(safe, absa / rs, 1.0)
    pha = torch.where(absa > 0, a / torch.where(absa > 0, absa, 1), 1.0)
    s = torch.where(safe, pha * _conj(b) / rs, 0.0)
    return c, s, torch.where(safe, pha * r, a)


def _read_flags(conv, done):
    """(conv, done) of two bool tensors, read on the host as one integer:
    the one host read of an Arnoldi step."""
    flags = int(conv.to(torch.int32) + 2 * done.to(torch.int32))
    return bool(flags & 1), bool(flags & 2)


def _rotate(col, G, j):
    """Apply the rotations G[0..j-1] to a Hessenberg column in place."""
    for i in range(j):
        c, s = G[i]
        hi, hi1 = col[i].clone(), col[i + 1].clone()
        col[i] = c * hi + s * hi1
        col[i + 1] = -_conj(s) * hi + c * hi1


def _rotate_and_estimate(col, w, j):
    """Rotate the Hessenberg column ``col`` (length R + 1) by the earlier
    rotations, make the j-th one zeroing ``col[j + 1]``, carry it into the
    least-squares right-hand side and record the new residual estimate:
    (estimate, the rotated ``col[j]``)."""
    G, g = w.G, w.g
    _rotate(col, G, j)
    c, s, rr = _givens(col[j], col[j + 1])
    col[j], col[j + 1] = rr, 0.0
    G[j, 0], G[j, 1] = c, s
    gj = g[j].clone()
    g[j] = c * gj
    g[j + 1] = -_conj(s) * gj
    w.H[:, j] = col[:w.H.shape[0]]
    normr = torch.abs(g[j + 1])
    w.cycres[j] = normr
    return normr, rr


class _Work:
    """The buffers of one GMRES call: the basis (and the preconditioned
    directions for FGMRES), the Hessenberg matrix, the rotations, the
    right-hand side of the least-squares problem and the estimates."""

    def __init__(self, R, b, flexible, householder=False):
        n, dtype, dev = b.shape[0], b.dtype, b.device
        self.V = torch.zeros((R + 1, n), dtype=dtype, device=dev)
        self.Z = torch.zeros_like(self.V) if flexible else self.V
        hrows = R if householder else R + 1
        self.H = torch.zeros((hrows, R), dtype=dtype, device=dev)
        self.G = torch.zeros((R, 2), dtype=dtype, device=dev)
        self.g = torch.zeros((R + 1,), dtype=dtype, device=dev)
        self.cycres = torch.zeros((R,), dtype=real_dtype(dtype), device=dev)

    def reset(self):
        for t in (self.H, self.G, self.g, self.cycres):
            t.zero_()


def _cycle(mv, Mv, b, R, w, flexible, orthog, red, x, rtol, check_start):
    """One restart cycle from x: (x, steps, converged), the estimates in
    ``w.cycres``; ``red`` takes the inner products."""
    r0 = b - mv(x)
    r = r0 if flexible else Mv(r0)
    beta = red.norm(r)
    w.reset()
    V, Z, H, g = w.V, w.Z, w.H, w.g
    V[0] = torch.where(beta > 0, r / torch.where(beta == 0, 1, beta), 0.0)
    g[0] = beta
    if check_start and bool(beta < rtol):
        return x, 0, True
    stall = torch.zeros((), dtype=torch.int32, device=b.device)
    j, conv = 0, False
    while j < R:
        if flexible:
            Z[j] = Mv(V[j])
            u = mv(Z[j])
        else:
            u = Mv(mv(V[j]))
        col = torch.zeros((R + 1,), dtype=b.dtype, device=b.device)
        if orthog == "mgs":
            for i in range(j + 1):
                hi = red.dot(V[i], u)
                u = u - hi * V[i]
                col[i] = hi
        else:
            Vj = V[:j + 1]
            h1 = red.dots(Vj, u)
            u = u - Vj.T @ h1
            h2 = red.dots(Vj, u)
            u = u - Vj.T @ h2
            col[:j + 1] = h1 + h2
        unorm = red.norm(u)
        col[j + 1] = unorm
        V[j + 1] = torch.where(unorm > TINY,
                               u / torch.where(unorm == 0, 1, unorm), 0.0)
        normr, _ = _rotate_and_estimate(col, w, j)
        # the estimate does not rise: no real drop over 4 steps is the
        # rounding floor
        prev = w.cycres[j - 1] if j > 0 else beta
        stall = torch.where(normr > 0.999 * prev, stall + 1, 0)
        hit = normr < rtol
        j += 1
        conv, done = _read_flags(hit, hit | (unorm <= TINY) | (stall >= 4))
        if done:
            break
    y = torch.linalg.solve_triangular(H[:j, :j], g[:j, None], upper=True)
    return x + Z[:j].T @ y[:, 0], j, conv


def _restarted(cycle, w, mv, pres, x, b, tol, R, max_outer, callback,
               norm=norm):
    """The restart loop around ``cycle(x, rtol, check_start)`` (one
    restart cycle on the work ``w``); ``pres`` maps a residual to the
    one the tolerance is on.  Returns ``(x, info, resbuf, nres)``."""
    normMb = norm(pres(b))
    rtol = tol * torch.where(normMb == 0, 1.0, normMb)
    npr0 = norm(pres(b - mv(x)))
    resbuf = torch.zeros((max_outer * R + 1,), dtype=real_dtype(b.dtype),
                         device=b.device)
    resbuf[0] = npr0
    it, nres, outer = 0, 1, 0
    done = bool(npr0 < rtol)
    while not done and outer < max_outer:
        x, j, conv = cycle(x, rtol, outer > 0)
        resbuf[nres:nres + j] = w.cycres[:j]
        it, nres, outer = it + j, nres + j, outer + 1
        if callback is not None:
            callback(x)
        done = conv or j == 0
    final = norm(pres(b - mv(x)))
    info = torch.where(final < rtol, 0, it).to(torch.int32)
    return x, info, resbuf, nres


def gmres_loop(mv, Mv, x, b, tol, R, max_outer, flexible=False,
               orthog="cgs2", callback=None, red=LOCAL):
    """Restarted GMRES from x with restart ``R`` and at most ``max_outer``
    cycles: ``(x, info, resbuf, nres)``.  ``resbuf[:nres]`` holds the
    preconditioned residual norms (the residual norms for FGMRES), the
    initial one first; ``info`` is 0 when the final true (preconditioned)
    residual is below ``tol`` times that of b, else the step count.
    ``callback(x)`` is called after every cycle.  ``red``: the inner
    products (``common.Reduction``; summed over the ranks on a row-sharded
    level, whose Hessenberg matrix and stop flags every rank then holds
    alike)."""
    if orthog not in ("cgs2", "mgs"):
        raise ValueError(f"unknown orthog {orthog!r}")
    w = _Work(R, b, flexible)
    return _restarted(partial(_cycle, mv, Mv, b, R, w, flexible, orthog,
                              red), w,
                      mv, (lambda r: r) if flexible else Mv, x, b, tol, R,
                      max_outer, callback, norm=red.norm)


def _msign(v):
    """The complex sign of v, 1 at 0."""
    a = torch.abs(v)
    return torch.where(a == 0, torch.ones_like(v), v / torch.where(a == 0, 1, a))


def _reflect(v, W, ks):
    """v <- (I - 2 w_k w_k^H) v for k in ``ks``, in that order."""
    for k in ks:
        v = v - 2.0 * torch.vdot(W[k], v) * W[k]
    return v


def _householder_cycle(mv, Mv, b, R, w, x, rtol, check_start):
    """One restart cycle of Householder GMRES (the contract of
    ``_cycle``): the basis held as a chain of reflectors, the update
    mapped back by Horner's scheme."""
    n = b.shape[0]
    W, H, g = w.V, w.H, w.g
    w.reset()
    r = Mv(b - mv(x))
    normr0 = norm(r)
    beta = _msign(r[0]) * normr0
    w0 = r.clone()
    w0[0] += beta
    w0n = norm(w0)
    W[0] = torch.where(w0n > TINY, w0 / torch.where(w0n == 0, 1, w0n), 0.0)
    g[0] = -beta
    if check_start and bool(normr0 < rtol):
        return x, 0, True
    j, conv = 0, False
    while j < R:
        v = (-2.0 * _conj(W[j][j])) * W[j]
        v[j] += 1.0
        v = _reflect(v, W, range(j - 1, -1, -1))
        v = _reflect(Mv(mv(v)), W, range(j + 1))
        tail = v[j + 1:]
        tail_norm = norm(tail)
        u = torch.zeros_like(v)
        if j + 1 < n:
            alpha = _msign(v[j + 1]) * tail_norm
            u[j + 1:] = tail
            u[j + 1] += alpha
        un = norm(u)
        W[j + 1] = torch.where(un > TINY, u / torch.where(un == 0, 1, un),
                               0.0)
        # the column: v[:j + 1], then -alpha (0 past the last row)
        col = torch.zeros((R + 1,), dtype=b.dtype, device=b.device)
        col[:j + 1] = v[:j + 1]
        if j + 1 < n:
            col[j + 1] = -alpha
        normr, rr = _rotate_and_estimate(col, w, j)
        hit = normr < rtol
        j += 1
        conv, done = _read_flags(
            hit, hit | ((tail_norm <= TINY) & (torch.abs(rr) <= TINY)))
        if done:
            break
    Hj = H[:j, :j].clone()
    d = torch.diagonal(Hj)
    d.copy_(torch.where(torch.abs(d) > TINY, d, 1.0))
    y = torch.linalg.solve_triangular(Hj, g[:j, None], upper=True)[:, 0]
    u = torch.zeros_like(b)
    for k in range(j - 1, -1, -1):
        u[k] += y[k]
        u = u - 2.0 * torch.vdot(W[k], u) * W[k]
    return x + u, j, conv


def householder_loop(mv, Mv, x, b, tol, R, max_outer, callback=None):
    """Restarted Householder GMRES: the contract of ``gmres_loop``."""
    w = _Work(R, b, False, householder=True)
    return _restarted(partial(_householder_cycle, mv, Mv, b, R, w), w, mv,
                      Mv, x, b, tol, R, max_outer, callback)


def _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback, residuals,
                  flexible, method, device):
    A, mv, n, _, b, x, _ = prepare(A, b, x0, 1, device)
    Mv = as_precond(M, b.device)
    if restart is None:
        R = min(n, maxiter if maxiter is not None else min(n, 40))
        max_outer = 1
    else:
        R = min(int(restart), n)
        max_outer = maxiter if maxiter is not None else max(1, min(
            10000 // max(R, 1), 100))
    if method == "householder":
        x, info, resbuf, nres = householder_loop(mv, Mv, x, b, tol, R,
                                                 max_outer, callback)
    else:
        x, info, resbuf, nres = gmres_loop(mv, Mv, x, b, tol, R, max_outer,
                                           flexible, method, callback)
    finalize(residuals, resbuf, nres)
    return x, int(info)


def gmres_mgs(A, b, x0=None, tol=1e-5, restart=None, maxiter=None, M=None,
              callback=None, residuals=None, reorth=False, restrt=None,
              device=None):
    """Left-preconditioned GMRES with modified Gram-Schmidt.  Without
    ``restart``, one cycle of ``maxiter`` (default min(n, 40)) steps;
    with it, ``maxiter`` cycles (default up to 10000 steps, 100
    cycles)."""
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, False, "mgs", device)


def gmres_householder(A, b, x0=None, tol=1e-5, restart=None, maxiter=None,
                      M=None, callback=None, residuals=None, restrt=None,
                      device=None):
    """Householder GMRES: the basis as a chain of reflectors, orthogonal
    to working precision."""
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, False, "householder", device)


def gmres(A, b, x0=None, tol=1e-5, restart=None, maxiter=None, M=None,
          callback=None, residuals=None, orthog="mgs", restrt=None,
          device=None, **kwargs):
    """GMRES; ``orthog`` is 'mgs', 'cgs2' or 'householder'."""
    if orthog == "householder":
        return gmres_householder(A, b, x0=x0, tol=tol, restart=restart,
                                 maxiter=maxiter, M=M, callback=callback,
                                 residuals=residuals, restrt=restrt,
                                 device=device)
    if orthog not in ("mgs", "cgs2"):
        raise ValueError(f"unknown orthog {orthog!r}")
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, False, orthog, device)


def fgmres(A, b, x0=None, tol=1e-5, restart=None, maxiter=None, M=None,
           callback=None, residuals=None, restrt=None, device=None):
    """Flexible GMRES: right-preconditioned, M may change between steps."""
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, True, "cgs2", device)
