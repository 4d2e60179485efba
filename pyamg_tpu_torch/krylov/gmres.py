"""Restarted GMRES, FGMRES and Householder GMRES (counterpart of
``pyamg_tpu/krylov/gmres.py``).

Left-preconditioned GMRES records the preconditioned residual norms, as
the reference does; FGMRES is right-preconditioned and flexible.  The
Arnoldi step orthogonalizes by classical Gram-Schmidt applied twice
(``orthog="cgs2"``: two products with the basis so far, what
``MultilevelSolver.solve(accel="gmres")`` uses) or by sequential modified
Gram-Schmidt (``"mgs"``, the default of ``gmres``).

Each loop is a tree of steps of a ``_graph.Program`` (``_restarted``):
the restart cycles, and in each the Arnoldi (or reflector) step j and the
update of j steps, one step for each j, chosen by the device's j through
a ``_graph.Switch``.  Op by op the host reads a stop flag a step and the
result once; ``MultilevelSolver`` captures the tree as one CUDA graph
with one read at its end.  The basis is allocated once per program as
``(restart + 1, n)``; the Hessenberg matrix, the Givens rotations, the
residual estimate, the step count and the history's length stay on the
device.
"""

from __future__ import annotations

from functools import partial

import torch

from pyamg_tpu_torch import _graph
from pyamg_tpu_torch._graph import Program
from pyamg_tpu_torch.krylov.common import (LOCAL, as_precond, finalize,
                                           norm, prepare, real_dtype,
                                           reduction)
from pyamg_tpu_torch.parallel import partition

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
    col[j] = rr
    col[j + 1].zero_()       # a Python 0.0 would be a host-to-device copy
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


def _restarted(prog, w, mv, pres, b, tol, R, max_outer, begin, trip,
               update, callback, red, history):
    """The restart loop of GMRES as a tree of ``prog``'s steps, run, and
    its result read once: ``(x, info, resbuf, nres)``.

    ``init``; while the stop flag is clear, at most ``max_outer`` restart
    cycles (counter ``outer``), each ``begin`` (the cycle's start, which
    also stops where a later restart starts below the tolerance), at most
    R steps (counter ``j``, raised by each; ``istop`` stops them) and the
    update of the k steps run, ``("update", k)`` / ``update(k, s)``, which
    also copies the cycle's estimates into the history at the device
    offset ``nres``; then ``final``.  A step is the parts ``trip``, each
    ``(name, fn, by_k)``: ``fn(s)`` as one step where it is the same for
    every k (the preconditioned product), else ``(name, k)`` /
    ``fn(k, s)``, one step for each k, a branch of a ``_graph.Switch`` on
    the device's k (as the updates are).  ``w``: the work (its
    ``cycres``, the cycle's estimates); ``pres`` maps a residual to the
    one the tolerance is on."""
    dev = b.device
    rdt = real_dtype(b.dtype)

    def init(s):
        x, b = s["x"], s["b"]
        normMb = red.norm(pres(b))
        rtol = tol * torch.where(normMb == 0, 1.0, normMb)
        npr0 = red.norm(pres(b - mv(x)))
        resbuf = torch.zeros((max_outer * R + 1,), dtype=rdt, device=dev)
        resbuf[0] = npr0
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return {"rtol": rtol, "resbuf": resbuf, "stop": npr0 < rtol,
                "nres": zero + 1, "iters": zero.clone(),
                "outer": zero.clone(), "j": zero.clone(),
                "conv": zero < 0, "istop": zero < 0}

    def finish(k, s):
        """The update of a cycle of k steps (k = 0: none, and stop)."""
        if k == 0:
            return {"stop": s["nres"] >= 0}
        out = update(k, s)
        at = s["nres"] + torch.arange(k, dtype=torch.int32, device=dev)
        s["resbuf"].index_copy_(0, at.long(), w.cycres[:k])
        out.update({"nres": s["nres"] + k, "iters": s["iters"] + k,
                    "stop": s["conv"]})
        return out

    def final(s):
        ok = red.norm(pres(s["b"] - mv(s["x"]))) < s["rtol"]
        return {"info": torch.where(ok, 0, s["iters"]).to(torch.int32)}

    def part(name, fn, by_k):
        if not by_k:
            return _graph.Step(prog, name, fn)
        return _graph.Switch(prog, "j", [[_graph.Step(prog, (name, k),
                                                      partial(fn, k))]
                                         for k in range(R)])

    steps = _graph.While(prog, [part(*p) for p in trip], R, stop="istop",
                         count="j")
    updates = _graph.Switch(
        prog, "j", [[_graph.Step(prog, ("update", k), partial(finish, k))]
                    for k in range(R + 1)])
    nodes = [_graph.Step(prog, "init", init),
             _graph.While(prog, [_graph.Step(prog, "begin", begin), steps,
                                 updates], max_outer, count="outer",
                          callback=None if callback is None
                          else lambda s: callback(s["x"])),
             _graph.Step(prog, "final", final)]
    vals = prog.loop("gmres", nodes, ("info", "nres") +
                     (("resbuf",) if history else ()))
    info, nres = vals[:2]
    return prog.state["x"], info, vals[2] if history else \
        prog.state["resbuf"], nres


def _start(s, beta):
    """What ``begin`` sets besides the basis: no step yet, and the stop
    of a later restart that starts below the tolerance."""
    zero = torch.zeros((), dtype=torch.int32, device=beta.device)
    start = (s["outer"] > 0) & (beta < s["rtol"])
    return {"j": zero, "istop": start, "stop": start, "outer": s["outer"] + 1}


def gmres_loop(mv, Mv, x, b, tol, R, max_outer, flexible=False,
               orthog="cgs2", callback=None, red=LOCAL, program=None,
               history=False):
    """Restarted GMRES from x with restart ``R`` and at most ``max_outer``
    cycles: ``(x, info, resbuf, nres)``.  ``resbuf[:nres]`` holds the
    preconditioned residual norms (the residual norms for FGMRES), the
    initial one first (a list read with the result where ``history``,
    else the device's buffer); ``info`` (an int) is 0 when the final true
    (preconditioned) residual is below ``tol`` times that of b, else the
    step count.  ``callback(x)`` is called after every cycle.  ``red``:
    the inner products (``common.Reduction``; summed over the ranks on a
    row-sharded level, whose Hessenberg matrix and stop flags every rank
    then holds alike).

    The loop is the tree of ``_restarted`` in ``program`` (a
    ``_graph.Program``, by default an eager one, whose host reads a stop
    flag a step): ``init``; for each restart cycle ``begin``, then for each
    j it reaches the product ``product`` (one step, v_j taken at the
    device's j) and the Arnoldi step ``("arnoldi", j)`` (the
    orthogonalisation against the j + 1 vectors so far makes each j a step
    of its own), and ``("update", j)``; then ``final``.  A captured
    program runs it on the device with one read at the end, and returns
    its static x and history, which its next run overwrites."""
    if orthog not in ("cgs2", "mgs"):
        raise ValueError(f"unknown orthog {orthog!r}")
    prog = Program() if program is None else program
    w = prog.static(("work", R, flexible), lambda: _Work(R, b, flexible))
    V, Z, H, g = w.V, w.Z, w.H, w.g
    dev = b.device
    prog.put("x", x)
    prog.put("b", b)

    def product(s):
        """The step's preconditioned product, the same graph for every j:
        M A v_j (A M v_j for FGMRES, whose M v_j is kept in Z)."""
        j = s["j"].reshape(1).long()
        vj = V.index_select(0, j)[0]
        if flexible:
            z = Mv(vj)
            Z.index_copy_(0, j, z[None])
            return {"u": mv(z)}
        return {"u": Mv(mv(vj))}

    def begin(s):
        r0 = s["b"] - mv(s["x"])
        r = r0 if flexible else Mv(r0)
        beta = red.norm(r)
        w.reset()
        V[0] = torch.where(beta > 0, r / torch.where(beta == 0, 1, beta),
                           0.0)
        g[0] = beta
        return {"beta": beta,
                "stall": torch.zeros((), dtype=torch.int32, device=dev),
                **_start(s, beta)}

    def arnoldi(j, s):
        u = s["u"]
        col = torch.zeros((R + 1,), dtype=b.dtype, device=dev)
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
        prev = w.cycres[j - 1] if j > 0 else s["beta"]
        stall = torch.where(normr > 0.999 * prev, s["stall"] + 1, 0)
        hit = normr < s["rtol"]
        return {"stall": stall, "j": s["j"] + 1, "conv": hit,
                "istop": hit | (unorm <= TINY) | (stall >= 4)}

    def update(j, s):
        y = torch.linalg.solve_triangular(H[:j, :j], g[:j, None], upper=True)
        return {"x": s["x"] + Z[:j].T @ y[:, 0]}

    return _restarted(prog, w, mv, (lambda r: r) if flexible else Mv, b, tol,
                      R, max_outer, begin, [("product", product, False),
                                            ("arnoldi", arnoldi, True)],
                      update, callback, red, history)


def _msign(v):
    """The complex sign of v, 1 at 0."""
    a = torch.abs(v)
    return torch.where(a == 0, torch.ones_like(v), v / torch.where(a == 0, 1, a))


class _Rows:
    """Global-row access to the vectors of one process: all of them."""

    def __init__(self, b):
        self.n = b.shape[0]
        self.norm, self.dot = norm, torch.vdot

    def elem(self, v, i):
        return v[i]

    def add_at(self, v, i, val):
        v = v.clone()
        v[i] += val
        return v

    def tail(self, v, j):
        """(v with its first j + 1 rows zeroed, the norm of the rest)."""
        u = torch.zeros_like(v)
        u[j + 1:] = v[j + 1:]
        return u, norm(v[j + 1:])

    def head(self, v, k):
        return v[:k]


class _SplitRows(_Rows):
    """Global-row access to vectors split by rows over a ``RowMesh``: a
    rank holds rows ``[rank n_loc, (rank + 1) n_loc)``; a read of a row,
    of the leading rows or of a norm is summed over the ranks (one
    ``all_reduce``; each rank adds zeros for the rows it does not
    hold)."""

    def __init__(self, b, red):
        mesh = red.mesh
        self.mesh = mesh
        self.n = b.shape[0] * mesh.size
        self.gidx = mesh.rank * b.shape[0] + torch.arange(b.shape[0],
                                                          device=b.device)
        self.norm, self.dot = red.norm, red.dot

    def elem(self, v, i):
        return partition.all_reduce(torch.sum(torch.where(
            self.gidx == i, v, 0)), self.mesh)

    def add_at(self, v, i, val):
        return v + torch.where(self.gidx == i, val, 0)

    def tail(self, v, j):
        u = torch.where(self.gidx > j, v, 0)
        return u, self.norm(u)

    def head(self, v, k):
        out = torch.zeros((k + 1,), dtype=v.dtype, device=v.device)
        out.index_add_(0, torch.clamp(self.gidx, max=k),
                       torch.where(self.gidx < k, v, 0))
        return partition.all_reduce(out, self.mesh)[:k]


def _reflect(v, W, ks, dot=torch.vdot):
    """v <- (I - 2 w_k w_k^H) v for k in ``ks``, in that order."""
    for k in ks:
        v = v - 2.0 * dot(W[k], v) * W[k]
    return v


def householder_loop(mv, Mv, x, b, tol, R, max_outer, callback=None,
                     red=LOCAL, program=None, history=False):
    """Restarted Householder GMRES: the contract of ``gmres_loop``, the
    basis held as a chain of reflectors and the update mapped back by
    Horner's scheme.  The steps: ``begin``, then for each j the reflectors
    applied to e_j, ``("reflector", j)``, the product ``product`` (one
    step for every j) and the reflectors applied to it,
    ``("reflect", j)``, and ``("update", j)``.  On vectors split by rows
    (``red`` a sharded reduction) the reflectors' leading rows and
    trailing norms are read by global row index (``_SplitRows``)."""
    prog = Program() if program is None else program
    w = prog.static(("householder", R),
                    lambda: _Work(R, b, False, householder=True))
    rows = prog.static(("rows", R), lambda: _Rows(b) if red is LOCAL
                       else _SplitRows(b, red))
    n = rows.n
    W, H, g = w.V, w.H, w.g
    prog.put("x", x)
    prog.put("b", b)

    def begin(s):
        w.reset()
        r = Mv(s["b"] - mv(s["x"]))
        normr0 = rows.norm(r)
        beta = _msign(rows.elem(r, 0)) * normr0
        w0 = rows.add_at(r, 0, beta)
        w0n = rows.norm(w0)
        W[0] = torch.where(w0n > TINY, w0 / torch.where(w0n == 0, 1, w0n),
                           0.0)
        g[0] = -beta
        return _start(s, normr0)

    def reflector(j, s):
        v = (-2.0 * _conj(rows.elem(W[j], j))) * W[j]
        v = rows.add_at(v, j, 1.0)
        return {"v": _reflect(v, W, range(j - 1, -1, -1), rows.dot)}

    def product(s):
        return {"u": Mv(mv(s["v"]))}

    def reflect(j, s):
        v = _reflect(s["u"], W, range(j + 1), rows.dot)
        u, tail_norm = rows.tail(v, j)
        if j + 1 < n:
            alpha = _msign(rows.elem(v, j + 1)) * tail_norm
            u = rows.add_at(u, j + 1, alpha)
        un = rows.norm(u)
        W[j + 1] = torch.where(un > TINY, u / torch.where(un == 0, 1, un),
                               0.0)
        # the column: v[:j + 1], then -alpha (0 past the last row)
        col = torch.zeros((R + 1,), dtype=b.dtype, device=b.device)
        col[:j + 1] = rows.head(v, j + 1)
        if j + 1 < n:
            col[j + 1] = -alpha
        normr, rr = _rotate_and_estimate(col, w, j)
        hit = normr < s["rtol"]
        return {"j": s["j"] + 1, "conv": hit,
                "istop": hit | ((tail_norm <= TINY) &
                                (torch.abs(rr) <= TINY))}

    def update(j, s):
        Hj = H[:j, :j].clone()
        d = torch.diagonal(Hj)
        d.copy_(torch.where(torch.abs(d) > TINY, d, 1.0))
        y = torch.linalg.solve_triangular(Hj, g[:j, None], upper=True)[:, 0]
        u = torch.zeros_like(s["b"])
        for k in range(j - 1, -1, -1):
            u = rows.add_at(u, k, y[k])
            u = u - 2.0 * rows.dot(W[k], u) * W[k]
        return {"x": s["x"] + u}

    return _restarted(prog, w, mv, Mv, b, tol, R, max_outer, begin,
                      [("reflector", reflector, True),
                       ("product", product, False),
                       ("reflect", reflect, True)], update, callback, red,
                      history)


def _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback, residuals,
                  flexible, method, device, program=None):
    A, mv, n, _, b, x, _ = prepare(A, b, x0, 1, device)
    Mv = as_precond(M, b.device)
    if restart is None:
        R = min(n, maxiter if maxiter is not None else min(n, 40))
        max_outer = 1
    else:
        R = min(int(restart), n)
        max_outer = maxiter if maxiter is not None else max(1, min(
            10000 // max(R, 1), 100))
    red = reduction(A)
    loop = partial(householder_loop) if method == "householder" else \
        partial(gmres_loop, flexible=flexible, orthog=method)
    x, info, resbuf, nres = loop(mv, Mv, x, b, tol, R, max_outer,
                                 callback=callback, red=red, program=program,
                                 history=residuals is not None)
    finalize(residuals, resbuf, nres)
    return x, info


def gmres_mgs(A, b, x0=None, tol=1e-5, restart=None, maxiter=None, M=None,
              callback=None, residuals=None, reorth=False, restrt=None,
              device=None, program=None):
    """Left-preconditioned GMRES with modified Gram-Schmidt.  Without
    ``restart``, one cycle of ``maxiter`` (default min(n, 40)) steps;
    with it, ``maxiter`` cycles (default up to 10000 steps, 100
    cycles).  ``program``: the ``_graph.Program`` the loop runs on (an
    eager one by default; ``MultilevelSolver.solve`` passes its cached
    one)."""
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, False, "mgs", device, program)


def gmres_householder(A, b, x0=None, tol=1e-5, restart=None, maxiter=None,
                      M=None, callback=None, residuals=None, restrt=None,
                      device=None, program=None):
    """Householder GMRES: the basis as a chain of reflectors, orthogonal
    to working precision."""
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, False, "householder", device, program)


def gmres(A, b, x0=None, tol=1e-5, restart=None, maxiter=None, M=None,
          callback=None, residuals=None, orthog="mgs", restrt=None,
          device=None, program=None, **kwargs):
    """GMRES; ``orthog`` is 'mgs', 'cgs2' or 'householder'."""
    if orthog == "householder":
        return gmres_householder(A, b, x0=x0, tol=tol, restart=restart,
                                 maxiter=maxiter, M=M, callback=callback,
                                 residuals=residuals, restrt=restrt,
                                 device=device, program=program)
    if orthog not in ("mgs", "cgs2"):
        raise ValueError(f"unknown orthog {orthog!r}")
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, False, orthog, device, program)


def fgmres(A, b, x0=None, tol=1e-5, restart=None, maxiter=None, M=None,
           callback=None, residuals=None, restrt=None, device=None,
           program=None):
    """Flexible GMRES: right-preconditioned, M may change between steps."""
    restart = restrt if restrt is not None else restart
    return _gmres_driver(A, b, x0, tol, restart, maxiter, M, callback,
                         residuals, True, "cgs2", device, program)
