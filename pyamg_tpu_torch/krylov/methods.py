"""Krylov methods: CG, BiCGStab, CGNE, CGNR, CR, minimal residual and
steepest descent (counterpart of ``pyamg_tpu/krylov/methods.py``).

The reference runs each iteration as one ``lax.while_loop``.  Here each
method is a tree of steps of a ``_graph.Program`` (``cg_nodes``,
``bicgstab_nodes``, ...): a ``start`` step, then one iteration a trip of
a ``While`` while the stop flag is clear and the iteration count, on the
device, is below ``maxiter``.  Every scalar stays on the device.  Op by op
(the free-standing functions, a callback, the CPU) the host reads one
flag per iteration and the result once; ``MultilevelSolver.solve`` runs
the same trees on its cached program, one CUDA graph with one read at
its end on a card.  ``callback(x)`` is called after every iteration.
"""

from __future__ import annotations

from functools import partial

import torch

from pyamg_tpu_torch._device import as_tensor
from pyamg_tpu_torch._graph import Every, Program, Step, While
from pyamg_tpu_torch.krylov.common import (
    LOCAL, as_matvec, as_precond, finalize, place, prepare, real_dtype,
    reduction, torch_dtype)
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


def cg_nodes(prog, mv, Mv, tol, criteria, maxiter, fro=1.0,
             stall_window=8, callback=None, red=LOCAL):
    """Preconditioned CG on ``prog``'s state (``x``, ``b``) as the tree of
    a ``_graph.Program`` (the contract of ``cg_loop``): ``start``, then
    one iteration a trip in two forms, ``plain`` and ``true`` (every 8th,
    the true residual), while ``stop`` is clear and ``it`` is below
    ``maxiter``.  The iteration count and the history index live on the
    device."""

    def start(s):
        x, b = s["x"], s["b"]
        rdt = real_dtype(b.dtype)
        normb = red.norm(b)
        normb = torch.where(normb == 0, 1.0, normb)
        normMb = red.norm(Mv(b)) if criteria == "MrMr" else None
        r = b - mv(x)
        z = Mv(r)
        rz = torch.real(red.dot(r, z))
        nr0 = red.norm(r)
        normr0 = (nr0 if criteria != "MrMr" else red.norm(z)).to(rdt)
        rtol = _rtol(criteria, tol, normb, normMb, fro, lambda: red.norm(x))
        resbuf = torch.zeros((maxiter + 1,), dtype=rdt, device=b.device)
        resbuf[0] = nr0
        zero = torch.zeros((), dtype=torch.int32, device=b.device)
        return {"r": r, "z": z, "p": z, "rz": rz, "normr0": normr0,
                "rtol": rtol if isinstance(rtol, torch.Tensor) else
                torch.full((), rtol, dtype=rdt, device=b.device),
                "resbuf": resbuf, "minr": normr0, "imp_it": zero, "xb": x,
                "info": zero.clone(), "it": zero.clone(),
                "stop": normr0 < rtol}

    def iteration(true_residual, s):
        x, b, r, p, rz, minr = (s[k] for k in ("x", "b", "r", "p", "rz",
                                               "minr"))
        it = s["it"] + 1
        Ap = mv(p)
        pAp = torch.real(red.dot(Ap, p))
        bad_A = pAp <= 0.0
        alpha = rz / torch.where(pAp == 0, 1, pAp)
        xn = x + alpha * p
        rn = b - mv(xn) if true_residual else r - alpha * Ap
        zn = Mv(rn)
        rzn = torch.real(red.dot(rn, zn))
        bad_M = rzn < 0.0
        beta = rzn / torch.where(rz == 0, 1, rz)
        p = zn + beta * p
        nrn = red.norm(rn)
        if criteria == "MrMr":
            normr = red.norm(zn)
        elif criteria == "rMr":
            normr = torch.sqrt(torch.clamp(rzn, min=0.0))
        else:
            normr = nrn
        s["resbuf"].index_copy_(0, it.reshape(1).long(),
                                nrn.reshape(1).to(s["resbuf"].dtype))
        conv = normr < s["rtol"]
        better = normr < minr
        improved = normr < 0.99 * minr
        imp_it = torch.where(improved, it, s["imp_it"])
        minr = torch.where(better, normr, minr)
        stalled = (it - imp_it >= stall_window) & \
            (minr < 0.1 * s["normr0"]) if stall_window > 0 else \
            torch.zeros_like(conv)
        info = torch.where(bad_A | bad_M, -1,
                           torch.where(conv, 0, s["info"]))
        return {"x": torch.where(bad_A, x, xn), "r": rn, "z": zn, "p": p,
                "rz": rzn, "minr": minr, "imp_it": imp_it,
                "xb": torch.where(better, xn, s["xb"]), "info": info,
                "it": it, "stop": conv | bad_A | bad_M | stalled}

    every = [Every(prog, 8, [Step(prog, "true", partial(iteration, True))],
                   [Step(prog, "plain", partial(iteration, False))])]
    return [Step(prog, "start", start),
            While(prog, every, maxiter, callback=None if callback is None
                  else lambda s: callback(s["x"]))]


def cg_loop(mv, Mv, x, b, tol, criteria, maxiter, fro=1.0,
            stall_window=8, callback=None, red=LOCAL, program=None,
            history=False):
    """Preconditioned CG from ``x``: ``(x_best, info, resbuf, nres)``.

    ``info`` (an int) is 0 on convergence, -1 on a curvature breakdown,
    and the iteration count when ``maxiter`` ran out.  ``resbuf[:nres]``
    holds the 2-norm residual history (a list read with the result where
    ``history``, else the device's buffer).  The true residual is
    recomputed every 8th iteration.  ``stall_window``: stop once the
    running-minimum residual has not improved by 1% for this many
    iterations (after it first fell below 10% of the start): f32 CG
    reaches its rounding floor before tight tolerances.  The best iterate
    seen is returned, because the 2-norm residual of CG is not monotone.
    0 disables the stall test.  ``callback(x)`` is called with the
    iterate after every iteration.  ``red``: the inner products
    (``common.Reduction``; summed over the ranks on a row-sharded level,
    so that every rank reads the same stop flag).

    The loop is the tree of ``cg_nodes`` in ``program`` (a
    ``_graph.Program``, by default an eager one, whose host reads the
    stop flag once an iteration); a captured program runs it on the
    device, and the result comes back in one read.  A captured program
    returns its static tensors, which its next run overwrites.
    """
    prog = Program() if program is None else program
    prog.put("x", x)
    prog.put("b", b)
    nodes = cg_nodes(prog, mv, Mv, tol, criteria, maxiter, fro,
                     stall_window, callback, red)
    info, resbuf, nres = _result(prog, "cg", nodes, maxiter, history)
    return prog.state["xb"], info, resbuf, nres


def _result(prog, name, nodes, maxiter, history):
    """Run the tree ``nodes`` (counter ``it``, flag ``stop``, ``info`` and
    the history ``resbuf`` in the state) and read it once: ``(info,
    resbuf, nres)``, ``info`` the iteration count where ``maxiter`` ran
    out with no verdict, ``resbuf`` a list where ``history``."""
    vals = prog.loop(name, nodes, ("it", "stop", "info") +
                     (("resbuf",) if history else ()))
    it, done, info = vals[:3]
    if not done and it >= maxiter and info == 0:
        info = it
    resbuf = vals[3] if history else prog.state["resbuf"]
    return info, resbuf, it + 1


def _measure(criteria, Mv, allowed, red=LOCAL):
    """The residual measure of ``criteria`` (raises for criteria a method
    does not admit)."""
    if criteria not in allowed:
        raise ValueError(f"invalid stopping criteria {criteria!r}")
    if criteria in ("rr", "rr+"):
        return red.norm
    if criteria == "MrMr":
        return lambda r: red.norm(Mv(r))
    return lambda r: torch.sqrt(torch.clamp(torch.real(red.dot(r, Mv(r))),
                                            min=0.0))


def _threshold(criteria, tol, b, x0, Mv, fro, red=LOCAL):
    """The stopping threshold of ``criteria`` for ``_measure``, a tensor."""
    if criteria == "rr+" and fro is None:
        raise ValueError(
            "criteria 'rr+' needs a matrix with accessible entries")
    normb = red.norm(b)
    normb = torch.where(normb == 0, 1.0, normb)
    normMb = red.norm(Mv(b)) if criteria == "MrMr" else None
    rtol = _rtol(criteria, tol, normb, normMb, fro, lambda: red.norm(x0))
    return rtol if isinstance(rtol, torch.Tensor) else \
        torch.full((), rtol, dtype=real_dtype(b.dtype), device=b.device)


def _start(b, r0, maxiter, red):
    """What every method's ``start`` sets besides its vectors: the
    history with ``||r0||`` first, and ``it`` and ``info`` 0."""
    resbuf = torch.zeros((maxiter + 1,), dtype=real_dtype(b.dtype),
                         device=b.device)
    resbuf[0] = red.norm(r0)
    zero = torch.zeros((), dtype=torch.int32, device=b.device)
    return {"resbuf": resbuf, "it": zero, "info": zero.clone()}


def _record(s, r, red):
    """The iteration count raised by one, and ``||r||`` written at it in
    the history."""
    it = s["it"] + 1
    s["resbuf"].index_copy_(0, it.reshape(1).long(),
                            red.norm(r).reshape(1).to(s["resbuf"].dtype))
    return it


def _loop(prog, start, iteration, maxiter, callback):
    return [Step(prog, "start", start),
            While(prog, [Step(prog, "iteration", iteration)], maxiter,
                  callback=None if callback is None
                  else lambda s: callback(s["x"]))]


def _solve(A, b, x0, maxiter, M, residuals, device, program, nodes):
    """Run a method's tree (``nodes(prog, mv, Mv, fro, red, maxiter)``) on
    ``program`` (a fresh eager one by default): ``(x, info)``."""
    A, mv, n, fro, b, x, maxiter = prepare(A, b, x0, maxiter, device)
    Mv = as_precond(M, b.device)
    prog = Program() if program is None else program
    prog.put("x", x)
    prog.put("b", b)
    info, resbuf, nres = _result(
        prog, "krylov", nodes(prog, mv, Mv, fro, reduction(A), maxiter),
        maxiter, residuals is not None)
    finalize(residuals, resbuf, nres)
    return prog.state["x"], info


def cg(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
       callback=None, residuals=None, device=None, program=None):
    """Preconditioned conjugate gradients: ``cg_loop`` (best iterate,
    stall test, true residual every 8th iteration).  ``program``: the
    ``_graph.Program`` the loop runs on (an eager one by default;
    ``MultilevelSolver.solve`` passes its cached one), as for every
    method here.

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
                                    fro, callback=callback, red=reduction(A),
                                    program=program,
                                    history=residuals is not None)
    finalize(residuals, resbuf, nres)
    return x, info


def bicgstab_nodes(prog, mv, Mv, tol, criteria, maxiter, fro=None,
                   callback=None, red=LOCAL):
    """Preconditioned BiCGStab on ``prog``'s state (``x``, ``b``) as a
    tree; ``info`` -1 when a denominator vanishes."""
    dot = red.dot
    meas = _measure(criteria, Mv, ("rr", "rr+"), red)

    def start(s):
        x, b = s["x"], s["b"]
        r = b - mv(x)
        rtol = _threshold(criteria, tol, b, x, Mv, fro, red)
        return {"r": r, "rstar": r, "p": r, "rrstar": dot(r, r),
                "rtol": rtol, **_start(b, r, maxiter, red),
                "stop": meas(r) < rtol}

    def iteration(s):
        x, r, rstar, p, rrstar = (s[k] for k in ("x", "r", "rstar", "p",
                                                 "rrstar"))
        Mp = Mv(p)
        AMp = mv(Mp)
        denom = dot(rstar, AMp)
        alpha = rrstar / torch.where(denom == 0, 1, denom)
        sv = r - alpha * AMp
        Ms = Mv(sv)
        AMs = mv(Ms)
        d2 = torch.real(dot(AMs, AMs))
        omega = dot(AMs, sv) / torch.where(d2 == 0, 1, d2)
        x = x + alpha * Mp + omega * Ms
        rn = sv - omega * AMs
        rrstar_n = dot(rstar, rn)
        beta = (rrstar_n / torch.where(rrstar == 0, 1, rrstar)) * \
            (alpha / torch.where(omega == 0, 1, omega))
        p = rn + beta * (p - omega * AMp)
        it = _record(s, rn, red)
        conv = meas(rn) < s["rtol"]
        brk = (denom == 0) | (omega == 0)
        return {"x": x, "r": rn, "p": p, "rrstar": rrstar_n, "it": it,
                "info": torch.where(brk, -1, torch.where(conv, 0, s["info"])),
                "stop": conv | brk}

    return _loop(prog, start, iteration, maxiter, callback)


def bicgstab(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
             callback=None, residuals=None, device=None, program=None):
    """Preconditioned BiCGStab; ``info`` -1 when a denominator vanishes."""
    return _solve(A, b, x0, maxiter, M, residuals, device, program,
                  lambda prog, mv, Mv, fro, red, maxiter: bicgstab_nodes(
                      prog, mv, Mv, tol, criteria, maxiter, fro, callback,
                      red))


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


class _Normal:
    """The products of the normal equations of A: ``mv`` (A v) and
    ``rmv`` (A^H v, its adjoint built once: a program keeps it)."""

    def __init__(self, A):
        self.mv, self.rmv = _normal_equations(A)


def _normal(A, b, x0, tol, criteria, maxiter, M, callback, residuals,
            device, program, craig):
    """CG on the normal equations of A: A A^H y = b - A x0, x = x0 + A^H y
    (``craig``, CGNE) or A^H A x = A^H b from x0 (CGNR), as a tree: the
    step ``normal`` (the system's right-hand side and start), CG's tree
    on the normal operator, and ``back`` (x)."""
    A, dev = place(A, device)
    if dev is None:
        raise TypeError("the normal equations take a matrix or an operator "
                        "with matvec and rmatvec already placed")
    _, _, dtype, fro = as_matvec(A)
    b = as_tensor(b, dev, torch_dtype(dtype)).reshape(-1)
    prog = Program() if program is None else program
    ne = prog.static(("normal",), lambda: _Normal(A))
    n = A.shape[0] if craig else A.shape[1]
    if maxiter is None:
        maxiter = int(min(max(1.3 * n, 5), 10000))
    maxiter = int(maxiter)
    given = x0 is not None
    x0 = torch.zeros((A.shape[1],), dtype=b.dtype, device=dev) \
        if not given else \
        torch.as_tensor(x0, dtype=b.dtype, device=dev).reshape(-1)
    prog.put("x0", x0)
    prog.put("b0", b)

    def normal(s):
        if craig:
            return {"x": torch.zeros_like(s["b0"]),
                    "b": s["b0"] - ne.mv(s["x0"]) if given else s["b0"]}
        return {"x": s["x0"], "b": ne.rmv(s["b0"])}

    def back(s):
        if not craig:
            return {"xn": s["xb"]}
        x = ne.rmv(s["xb"])
        return {"xn": x + s["x0"] if given else x}

    if craig:
        def op(v):
            return ne.mv(ne.rmv(v))
        cb = None if callback is None else (lambda y: callback(ne.rmv(y)))
    else:
        def op(v):
            return ne.rmv(ne.mv(v))
        cb = callback
    nodes = [Step(prog, "normal", normal),
             *cg_nodes(prog, op, as_precond(M, dev), tol, criteria, maxiter,
                       fro, callback=cb, red=reduction(A)),
             Step(prog, "back", back)]
    info, resbuf, nres = _result(prog, "krylov", nodes, maxiter,
                                 residuals is not None)
    finalize(residuals, resbuf, nres)
    return prog.state["xn"], info


def cgne(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
         callback=None, residuals=None, device=None, program=None):
    """CG on A A^H y = b - A x0, x = x0 + A^H y (Craig's method)."""
    return _normal(A, b, x0, tol, criteria, maxiter, M, callback, residuals,
                   device, program, craig=True)


def cgnr(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
         callback=None, residuals=None, device=None, program=None):
    """CG on A^H A x = A^H b."""
    return _normal(A, b, x0, tol, criteria, maxiter, M, callback, residuals,
                   device, program, craig=False)


def cr_nodes(prog, mv, Mv, tol, criteria, maxiter, fro=None, callback=None,
             red=LOCAL):
    """Preconditioned conjugate residuals as a tree; the history is that
    of the true residual b - A x."""
    dot = red.dot
    meas = _measure(criteria, Mv, ("rr", "rr+", "MrMr"), red)

    def start(s):
        x, b = s["x"], s["b"]
        r0 = b - mv(x)
        r = Mv(r0)
        rtol = _threshold(criteria, tol, b, x, Mv, fro, red)
        return {"r": r, "p": r, "rAr": dot(r, mv(r)), "rtol": rtol,
                **_start(b, r0, maxiter, red), "stop": meas(r0) < rtol}

    def iteration(s):
        x, r, p, rAr = (s[k] for k in ("x", "r", "p", "rAr"))
        Ap = mv(p)
        MAp = Mv(Ap)
        d = torch.real(dot(Ap, MAp))
        alpha = rAr / torch.where(d == 0, 1, d)
        x = x + alpha * p
        r = r - alpha * MAp
        rArn = dot(r, mv(r))
        beta = rArn / torch.where(rAr == 0, 1, rAr)
        p = r + beta * p
        rtrue = s["b"] - mv(x)
        it = _record(s, rtrue, red)
        conv = meas(rtrue) < s["rtol"]
        return {"x": x, "r": r, "p": p, "rAr": rArn, "it": it,
                "info": torch.where(conv, 0, s["info"]),
                "stop": conv | (d == 0)}

    return _loop(prog, start, iteration, maxiter, callback)


def cr(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None, M=None,
       callback=None, residuals=None, device=None, program=None):
    """Preconditioned conjugate residuals; the residual history is that
    of the true residual b - A x."""
    return _solve(A, b, x0, maxiter, M, residuals, device, program,
                  lambda prog, mv, Mv, fro, red, maxiter: cr_nodes(
                      prog, mv, Mv, tol, criteria, maxiter, fro, callback,
                      red))


def descent_nodes(prog, mv, Mv, tol, criteria, maxiter, step, fro=None,
                  callback=None, red=LOCAL):
    """The one-direction methods as a tree: x += alpha z with (z, alpha,
    stop, bad) from ``step(r, Mv, mv, dot)``; ``info`` -1 where ``bad``."""
    meas = _measure(criteria, Mv, ("rr", "rr+", "MrMr", "rMr"), red)

    def start(s):
        x, b = s["x"], s["b"]
        r = b - mv(x)
        rtol = _threshold(criteria, tol, b, x, Mv, fro, red)
        return {"r": r, "rtol": rtol, **_start(b, r, maxiter, red),
                "stop": meas(r) < rtol}

    def iteration(s):
        z, alpha, brk, bad = step(s["r"], Mv, mv, red.dot)
        x = s["x"] + alpha * z
        r = s["b"] - mv(x)
        it = _record(s, r, red)
        conv = meas(r) < s["rtol"]
        return {"x": x, "r": r, "it": it,
                "info": torch.where(conv, 0, torch.where(bad, -1, s["info"])),
                "stop": conv | brk}

    return _loop(prog, start, iteration, maxiter, callback)


def _minimal_residual_step(r, Mv, mv, dot):
    z = Mv(r)
    Az = mv(z)
    d = torch.real(dot(Az, Az))
    return z, dot(Az, z) / torch.where(d == 0, 1, d), d == 0, \
        torch.zeros_like(d == 0)


def _steepest_descent_step(r, Mv, mv, dot):
    z = Mv(r)
    d = torch.real(dot(mv(z), z))
    return z, dot(r, z) / torch.where(d == 0, 1, d), d <= 0, d <= 0


def minimal_residual(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None,
                     M=None, callback=None, residuals=None, device=None,
                     program=None):
    """Minimal residual iteration: z = M r, alpha = <Az, z> / <Az, Az>."""
    return _solve(A, b, x0, maxiter, M, residuals, device, program,
                  lambda prog, mv, Mv, fro, red, maxiter: descent_nodes(
                      prog, mv, Mv, tol, criteria, maxiter,
                      _minimal_residual_step, fro, callback, red))


def steepest_descent(A, b, x0=None, tol=1e-5, criteria="rr", maxiter=None,
                     M=None, callback=None, residuals=None, device=None,
                     program=None):
    """Steepest descent: z = M r, alpha = <r, z> / <Az, z>; ``info`` -1
    where <Az, z> <= 0."""
    return _solve(A, b, x0, maxiter, M, residuals, device, program,
                  lambda prog, mv, Mv, fro, red, maxiter: descent_nodes(
                      prog, mv, Mv, tol, criteria, maxiter,
                      _steepest_descent_step, fro, callback, red))
