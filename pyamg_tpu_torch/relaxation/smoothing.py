"""Smoother setup and application (counterpart of
``pyamg_tpu/relaxation/smoothing.py``).

A smoother is a triple ``(kind, sopts, params)``: ``kind`` and the static
options ``sopts`` (Python scalars: they choose the code path and the loop
bounds) and ``params``, the arrays and scalars that
``MultilevelSolver.to_device`` moves to the card.  ``setup_<name>`` builds
it from a level's host operator; ``apply_smoother`` runs it.  A
``(kind, sopts)`` pair is not a user's spec: Chebyshev is stored as the
polynomial it computed, Jacobi's damping as omega / rho.  So
``change_smoothers`` keeps each level's specs (``Level.smoother_specs``)
for ``MultilevelSolver.change_solve_matrix`` to rebuild from.

On a block (BELL) operator the Gauss-Seidel and block names set up the
block smoothers: the pseudo-inverted diagonal blocks and, for
Gauss-Seidel, a first-fit coloring of the block graph.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL, from_scipy
from pyamg_tpu_torch.relaxation import relaxation as rx


def rho_D_inv_A(A, seed=0):
    """Spectral radius of D^-1 A (host ELL, or BELL with D its scalar
    diagonal)."""
    from pyamg_tpu_torch.util.linalg import approximate_spectral_radius
    from pyamg_tpu_torch.ops.spmv import matvec
    Dinv = rx.dinv_vec(A)

    class _Op:
        shape = A.shape
        dtype = A.dtype

        @staticmethod
        def matvec(v):
            return Dinv * matvec(A, v)

    return approximate_spectral_radius(_Op, seed=seed)


def _spectral_radius(A):
    from pyamg_tpu_torch.util.linalg import approximate_spectral_radius
    return approximate_spectral_radius(A)


def _scalar(A, what):
    """Raise for a block operator where the reference has no block form."""
    if not isinstance(A, ELL):
        raise NotImplementedError(
            f"{what} takes a scalar host ELL operator; the reference has no "
            f"block (BELL) form of it")


# -- setup_*: (level, A, opts) -> (kind, sopts, params) ----------------------

def setup_none(level, A, opts):
    return ("none", {}, {})


def setup_jacobi(level, A, opts):
    """omega / rho(D^-1 A) with ``withrho`` (the default), else omega."""
    omega = float(opts.get("omega", 1.0))
    if bool(opts.get("withrho", True)):
        omega = omega / rho_D_inv_A(A)
    return ("jacobi", {"iterations": int(opts.get("iterations", 1))},
            {"omega": omega, "Dinv": rx.dinv_vec(A)})


def setup_richardson(level, A, opts):
    return ("richardson", {"iterations": int(opts.get("iterations", 1))},
            {"omega": float(opts.get("omega", 1.0)) / _spectral_radius(A)})


def setup_gauss_seidel(level, A, opts):
    """Multicolor Gauss-Seidel; on a BELL, block Gauss-Seidel over a
    coloring of its block graph."""
    if isinstance(A, BELL):
        colors, nc = rx.make_coloring(rx.block_pattern(A))
        return ("block_gauss_seidel",
                {"iterations": int(opts.get("iterations", 1)),
                 "sweep": opts.get("sweep", "forward"), "ncolors": nc},
                {"colors": colors, "Dinv": rx.block_dinv(A), "omega": 1.0})
    _scalar(A, "Gauss-Seidel setup")
    colors, nc = rx.make_coloring(A)
    # omega is static (an option, not a param) so that the sweep can drop
    # repeated colors when omega == 1
    return ("gauss_seidel",
            {"iterations": int(opts.get("iterations", 1)),
             "sweep": opts.get("sweep", "forward"), "ncolors": nc,
             "omega": 1.0},
            {"colors": colors, "Dinv": rx.dinv_vec(A)})


def setup_sor(level, A, opts):
    kind, sopts, params = setup_gauss_seidel(level, A, opts)
    omega = float(opts.get("omega", 1.0))
    if kind == "block_gauss_seidel":
        return (kind, sopts, {**params, "omega": omega})
    return (kind, {**sopts, "omega": omega}, params)


def setup_chebyshev(level, A, opts):
    """The Chebyshev polynomial over [rho * lower_bound, rho *
    upper_bound] (defaults 1/30 and 1.1), stored as ``polynomial``."""
    from pyamg_tpu_torch.relaxation.chebyshev import (
        chebyshev_polynomial_coefficients)
    rho = _spectral_radius(A)
    coef = -chebyshev_polynomial_coefficients(
        rho * float(opts.get("lower_bound", 1.0 / 30.0)),
        rho * float(opts.get("upper_bound", 1.1)),
        int(opts.get("degree", 3)))[:-1]
    return ("polynomial",
            {"iterations": int(opts.get("iterations", 1)),
             "coefficients": tuple(coef.tolist())}, {})


def setup_polynomial(level, A, opts):
    coef = np.asarray(opts["coefficients"], dtype=float)
    return ("polynomial",
            {"iterations": int(opts.get("iterations", 1)),
             "coefficients": tuple(coef.tolist())}, {})


def setup_jacobi_ne(level, A, opts):
    """omega / rho(D^-1 A) with ``withrho`` (the default), as the
    reference approximates rho(D_ne^-1 A A^H)."""
    omega = float(opts.get("omega", 1.0))
    if bool(opts.get("withrho", True)):
        omega = omega / rho_D_inv_A(A)
    p = rx.ne_params(A)
    return ("jacobi_ne", {"iterations": int(opts.get("iterations", 1))},
            {"omega": omega, "AH": p["AH"], "Dinv": p["Dinv_rows"]})


def _setup_gs_normal(kind, dinv_key):
    def setup(level, A, opts):
        _scalar(A, f"{kind} setup")
        colors, nc = rx.make_coloring(A)
        p = rx.ne_params(A)
        return (kind,
                {"iterations": int(opts.get("iterations", 1)),
                 "sweep": opts.get("sweep", "forward"), "ncolors": nc},
                {"colors": colors, "omega": float(opts.get("omega", 1.0)),
                 "AH": p["AH"], "Dinv": p[dinv_key]})
    return setup


setup_gauss_seidel_ne = _setup_gs_normal("gauss_seidel_ne", "Dinv_rows")
setup_gauss_seidel_nr = _setup_gs_normal("gauss_seidel_nr", "Dinv_cols")


def setup_block_jacobi(level, A, opts):
    """Block Jacobi, damped by omega / rho(D^-1 A) with ``withrho`` (the
    default); on a scalar operator, Jacobi (as the reference)."""
    if not isinstance(A, BELL):
        return setup_jacobi(level, A, opts)
    omega = float(opts.get("omega", 1.0))
    if bool(opts.get("withrho", True)):
        omega = omega / rho_D_inv_A(A)
    return ("block_jacobi", {"iterations": int(opts.get("iterations", 1))},
            {"omega": omega, "Dinv": rx.block_dinv(A)})


def setup_block_gauss_seidel(level, A, opts):
    return setup_gauss_seidel(level, A, opts)


def setup_cf_jacobi(level, A, opts):
    """Needs the level's C/F ``splitting`` (1 = C point).  On a BELL level
    whose splitting is by block row (block AIR), each block row's split
    holds for its unknowns."""
    split = np.asarray(level.splitting)
    if isinstance(A, BELL) and split.shape[0] == A.n_block_rows:
        split = np.repeat(split, A.blocksize[0])
    return ("cf_jacobi",
            {"iterations": int(opts.get("iterations", 1)),
             "f_iterations": int(opts.get("f_iterations", 1)),
             "c_iterations": int(opts.get("c_iterations", 1))},
            {"Cmask": split == 1, "Fmask": split == 0,
             "omega": float(opts.get("omega", 1.0)), "Dinv": rx.dinv_vec(A)})


def setup_fc_jacobi(level, A, opts):
    _, sopts, params = setup_cf_jacobi(level, A, opts)
    return ("fc_jacobi", sopts, params)


def setup_cf_block_jacobi(level, A, opts):
    """CF block Jacobi on the level's splitting (per block row, or per
    unknown, of which each block row's first counts); on a scalar
    operator, CF-Jacobi (as the reference)."""
    if not isinstance(A, BELL):
        return setup_cf_jacobi(level, A, opts)
    split = np.asarray(level.splitting)
    nb = A.n_block_rows
    if split.shape[0] != nb:
        split = split.reshape(nb, -1)[:, 0]
    return ("cf_block_jacobi",
            {"iterations": int(opts.get("iterations", 1)),
             "f_iterations": int(opts.get("f_iterations", 1)),
             "c_iterations": int(opts.get("c_iterations", 1))},
            {"Cmask": split == 1, "Fmask": split == 0,
             "omega": float(opts.get("omega", 1.0)),
             "Dinv": rx.block_dinv(A)})


def setup_fc_block_jacobi(level, A, opts):
    kind, sopts, params = setup_cf_block_jacobi(level, A, opts)
    return ("fc_block_jacobi" if kind == "cf_block_jacobi" else "fc_jacobi",
            sopts, params)


def _subdomains(C: ELL):
    """One subdomain per row of C: the row's stored columns, -1 padded."""
    sub = np.asarray(C.cols).astype(np.int32)
    sub[~C.valid_mask()] = -1
    return sub


def setup_schwarz(level, A, opts):
    """Additive Schwarz over ``subdomain`` (``opts``; by default one
    subdomain per row of A, its stored columns), its dense blocks gathered
    and LU-factored here (``rx.schwarz_params``).  A block operator raises ``TypeError``:
    the JAX package sets Schwarz up on the block graph of a BELL and then
    fails in the sweep."""
    subdomain = opts.get("subdomain")
    if subdomain is None:
        rx._schwarz_operator(A)
        subdomain = _subdomains(A)
    return ("schwarz", {"iterations": int(opts.get("iterations", 1))},
            rx.schwarz_params(A, subdomain))


def setup_strength_based_schwarz(level, A, opts):
    """Schwarz with one subdomain per row of the level's kept strength of
    connection ``C`` (``keep=True``), or of A where no C was kept, as in
    the JAX package (reference ``smoothing.py:531``)."""
    C = getattr(level, "C", None)
    if C is None:
        return setup_schwarz(level, A, opts)
    return ("schwarz", {"iterations": int(opts.get("iterations", 1))},
            rx.schwarz_params(A, _subdomains(C)))


def setup_gmres(level, A, opts):
    return ("krylov_gmres", {"maxiter": int(opts.get("maxiter", 5))}, {})


def setup_cg(level, A, opts):
    return ("krylov_cg", {"maxiter": int(opts.get("maxiter", 5))}, {})


def _adjoint(A):
    """A^H of a host operator as a host ELL."""
    from pyamg_tpu_torch.ops.transpose import transpose
    if isinstance(A, ELL):
        return transpose(A, conjugate=True)
    return from_scipy(rx._host_scipy(A).conj().T.tocsr())


def setup_cgne(level, A, opts):
    """A fixed number of CGNE steps; A^H is built here, on the host."""
    return ("krylov_cgne", {"maxiter": int(opts.get("maxiter", 5))},
            {"AH": _adjoint(A)})


def setup_cgnr(level, A, opts):
    """A fixed number of CGNR steps; A^H is built here, on the host."""
    return ("krylov_cgnr", {"maxiter": int(opts.get("maxiter", 5))},
            {"AH": _adjoint(A)})


_SETUPS = {
    None: setup_none, "none": setup_none,
    "jacobi": setup_jacobi,
    "richardson": setup_richardson,
    "gauss_seidel": setup_gauss_seidel,
    "sor": setup_sor,
    "chebyshev": setup_chebyshev,
    "polynomial": setup_polynomial,
    "jacobi_ne": setup_jacobi_ne,
    "gauss_seidel_ne": setup_gauss_seidel_ne,
    "gauss_seidel_nr": setup_gauss_seidel_nr,
    "block_jacobi": setup_block_jacobi,
    "block_gauss_seidel": setup_block_gauss_seidel,
    "cf_jacobi": setup_cf_jacobi,
    "fc_jacobi": setup_fc_jacobi,
    "cf_block_jacobi": setup_cf_block_jacobi,
    "fc_block_jacobi": setup_fc_block_jacobi,
    "schwarz": setup_schwarz,
    "strength_based_schwarz": setup_strength_based_schwarz,
    "gmres": setup_gmres,
    "cg": setup_cg,
    "cgne": setup_cgne,
    "cgnr": setup_cgnr,
}

# smoother kinds whose error propagator is symmetric: the reference's
# bookkeeping for the CG warning of ``MultilevelSolver.solve``
SYMMETRIC_SMOOTHERS = {"jacobi", "richardson", "polynomial", "chebyshev",
                       "block_jacobi", "none", None}


def unpack_arg(v):
    """PyAMG's ``(name, {opts})`` convention."""
    if isinstance(v, tuple):
        return v[0], dict(v[1])
    return v, {}


def make_smoother(level, A, spec):
    """The descriptor of ``spec`` (a name, ``(name, {opts})`` or a callable
    ``fn(A, x, b) -> x``) set up on the host operator A."""
    name, opts = unpack_arg(spec)
    if callable(name):
        return ("custom", {}, {"fn": name})
    if name not in _SETUPS:
        raise ValueError(f"unknown smoother {name!r}")
    return _SETUPS[name](level, A, opts)


def _is_symmetric_pair(pre, post):
    """Whether a (pre, post) pair makes a symmetric cycle: two equal
    symmetric smoothers, or Gauss-Seidel forward/backward or symmetric on
    both sides (the reference's rule)."""
    pk, ps, _ = pre
    qk, qs, _ = post
    if pk in SYMMETRIC_SMOOTHERS and qk in SYMMETRIC_SMOOTHERS:
        return pk == qk and ps == qs
    gs = ("gauss_seidel", "block_gauss_seidel", "sor")
    if pk in gs and qk in gs:
        return (ps.get("sweep"), qs.get("sweep")) in (
            ("forward", "backward"), ("symmetric", "symmetric"))
    return False


def smoothing_is_symmetric(levels):
    """Whether every level but the coarsest has a symmetric (pre, post)
    pair: the value of ``MultilevelSolver.symmetric_smoothing``."""
    return all(_is_symmetric_pair(l.pre, l.post) for l in levels[:-1])


def change_smoothers(ml, presmoother, postsmoother):
    """Attach smoother descriptors to every level but the coarsest, keep
    each level's specs in ``smoother_specs``, and set
    ``ml.symmetric_smoothing``; the hierarchy's captured solves, which read
    the old smoothers, are dropped."""
    if hasattr(ml, "_drop_graphs"):
        ml._drop_graphs()
    npre = len(ml.levels) - 1
    if npre == 0:
        ml.symmetric_smoothing = True
        return
    pres = presmoother if isinstance(presmoother, list) else \
        [presmoother] * npre
    posts = postsmoother if isinstance(postsmoother, list) else \
        [postsmoother] * npre
    pres = (pres + [pres[-1]] * npre)[:npre]
    posts = (posts + [posts[-1]] * npre)[:npre]
    for lvl, pre, post in zip(ml.levels[:-1], pres, posts):
        lvl.pre = make_smoother(lvl, lvl.A, pre)
        lvl.post = make_smoother(lvl, lvl.A, post)
        lvl.smoother_specs = (pre, post)
    ml.symmetric_smoothing = smoothing_is_symmetric(ml.levels)


def apply_smoother(kind, sopts, params, A, x, b):
    """One application of the smoother ``(kind, sopts, params)`` to
    A x = b from x."""
    if kind == "none":
        return x
    if kind == "custom":
        return params["fn"](A, x, b)
    if kind == "jacobi":
        return rx.jacobi(A, x, b, iterations=sopts["iterations"],
                         omega=params["omega"], Dinv=params["Dinv"])
    if kind == "richardson":
        from pyamg_tpu_torch.ops.spmv import matvec
        for _ in range(sopts["iterations"]):
            x = x + params["omega"] * (b - matvec(A, x))
        return x
    if kind == "gauss_seidel":
        return rx.gauss_seidel(A, x, b, iterations=sopts["iterations"],
                               sweep=sopts["sweep"], colors=params["colors"],
                               ncolors=sopts["ncolors"], Dinv=params["Dinv"],
                               omega=sopts.get("omega", 1.0))
    if kind == "polynomial":
        return rx.polynomial(A, x, b, coefficients=sopts["coefficients"],
                             iterations=sopts["iterations"])
    if kind == "jacobi_ne":
        return rx.jacobi_ne(A, x, b, iterations=sopts["iterations"],
                            omega=params["omega"], AH=params["AH"],
                            Dinv=params["Dinv"])
    if kind in ("gauss_seidel_ne", "gauss_seidel_nr"):
        fn = rx.gauss_seidel_ne if kind == "gauss_seidel_ne" else \
            rx.gauss_seidel_nr
        return fn(A, x, b, iterations=sopts["iterations"],
                  sweep=sopts["sweep"], omega=params["omega"],
                  colors=params["colors"], ncolors=sopts["ncolors"],
                  AH=params["AH"], Dinv=params["Dinv"])
    if kind == "block_gauss_seidel":
        return rx.block_gauss_seidel(A, x, b, iterations=sopts["iterations"],
                                     sweep=sopts["sweep"], Dinv=params["Dinv"],
                                     colors=params["colors"],
                                     ncolors=sopts["ncolors"],
                                     omega=params["omega"])
    if kind == "block_jacobi":
        return rx.block_jacobi(A, x, b, Dinv=params["Dinv"],
                               iterations=sopts["iterations"],
                               omega=params["omega"])
    if kind in ("cf_block_jacobi", "fc_block_jacobi"):
        fn = rx.cf_block_jacobi if kind == "cf_block_jacobi" else \
            rx.fc_block_jacobi
        return fn(A, x, b, params["Cmask"], params["Fmask"],
                  Dinv=params["Dinv"], iterations=sopts["iterations"],
                  f_iterations=sopts["f_iterations"],
                  c_iterations=sopts["c_iterations"], omega=params["omega"])
    if kind in ("cf_jacobi", "fc_jacobi"):
        fn = rx.cf_jacobi if kind == "cf_jacobi" else rx.fc_jacobi
        return fn(A, x, b, params["Cmask"], params["Fmask"],
                  iterations=sopts["iterations"],
                  f_iterations=sopts["f_iterations"],
                  c_iterations=sopts["c_iterations"], omega=params["omega"],
                  Dinv=params["Dinv"])
    if kind == "schwarz":
        return rx.schwarz(A, x, b, params["subdomain"],
                          iterations=sopts["iterations"], params=params)
    if kind.startswith("krylov_"):
        from pyamg_tpu_torch.krylov import inner
        if kind == "krylov_cg":
            return inner.inner_cg(A, x, b, sopts["maxiter"])
        if kind == "krylov_gmres":
            return inner.inner_gmres(A, x, b, sopts["maxiter"])
        if kind == "krylov_cgne":
            return inner.inner_cgne(A, params["AH"], x, b, sopts["maxiter"])
        if kind == "krylov_cgnr":
            return inner.inner_cgnr(A, params["AH"], x, b, sopts["maxiter"])
    raise ValueError(f"unknown smoother kind {kind!r}")
