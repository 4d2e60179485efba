"""Relaxation sweeps (counterpart of ``pyamg_tpu/relaxation/relaxation.py``).

* Jacobi family: ``jacobi``, ``jacobi_indexed``, ``cf_jacobi``,
  ``fc_jacobi``; each iteration is one product ``A x`` (K1 on a DIA, K3
  on a SELL) and vector updates.
* Multicolor Gauss-Seidel / SOR: nodes are grouped into independent sets
  by a graph coloring at setup, and each color is updated at once: exact
  Gauss-Seidel with respect to the colored ordering.  On a DIA operator
  a sweep is kernel K2 (``ops/dia_kernels.dia_gs_sweep``) with its
  ``omega``; a SELL operator takes the hybrid sweep K5
  (``ops/sell_kernels.sell_gs_sweep``) instead: 1024-row tiles in order,
  Gauss-Seidel across tiles and Jacobi within one; it ignores the colors.
* ``polynomial`` and ``chebyshev``: Horner steps over products.
* Normal-equation smoothers ``jacobi_ne``, ``gauss_seidel_ne``,
  ``gauss_seidel_nr``: products with A and with A^H (an ELL built at
  setup, ``ne_params``).
* Block smoothers on a BELL, with the pseudo-inverted diagonal blocks
  ``Dinv`` (nb, br, br): ``block_jacobi``, ``block_jacobi_indexed``,
  ``cf_block_jacobi``, ``fc_block_jacobi`` and the multicolor
  ``block_gauss_seidel`` over a coloring of the block graph.  On a vector
  tensor a sweep is K7 (``ops/bell_kernels.py``): a Jacobi sweep one
  launch (on every block row, or on an index set's rows, the others
  copied), and on a placed hierarchy, whose operators' K7 layouts are
  grouped by their smoothers' colorings, a color pass one launch that
  computes the product, ``Dinv``'s product and the update on that
  color's rows alone and writes them into a copy of x in place (exact,
  the coloring being proper on the block graph, which the layout build
  checks); on CPU tensors K7's plain version, the reference's formula on
  those rows.  Otherwise (host arrays, several vectors, a coloring the
  layout does not follow) a color pass is one full product ``A x``
  (``bspmv``), one batched product with ``Dinv`` and a masked update, as
  in the reference.
  Each pass is counted in the store (``bell.gs_passes``), on every replay
  of a captured graph.
* ``schwarz``: additive overlapping Schwarz on an ELL operator, the JAX
  package's method (not PyAMG's multiplicative one): every subdomain's
  dense block ``A[S, S]`` solves its part of the residual at once, and
  each node takes the mean of the corrections of the subdomains holding
  it.  The blocks and the overlap map depend only on A, so the blocks
  are gathered and LU-factored (partial pivoting) once at setup
  (``schwarz_params``); a sweep is torch gathers, two batched triangular
  solves and a gather-sum.  ``torch.linalg.solve_ex`` would factor again
  on every sweep, and its ``lu_solve`` reads the pivots on the host.

Host (numpy) operands are the setup phase (candidate improvement);
tensor operands are the solve phase.  No function here reads a tensor
on the host: loop bounds are Python integers and every scalar stays on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import BELL, DIA, ELL, from_scipy, to_scipy
from pyamg_tpu_torch.sparse.sell import SELL, sell_to_scipy
from pyamg_tpu_torch.ops.spmv import (extract_diagonal, matvec,
                                      on_bell_kernel)
from pyamg_tpu_torch.ops import (bell_kernels, dia_kernels, launch,
                                 sell_kernels)


def _bcast(v, x):
    """A per-node vector broadcast over the columns of a 2-D x."""
    return v[:, None] if x.ndim == 2 else v


def _host(*vs):
    """Whether every operand is a host (numpy) array."""
    return not any(isinstance(v, torch.Tensor) for v in vs)


def _where(host):
    return np.where if host else torch.where


def dinv_vec(A):
    """1 / diag(A), with 0 where the diagonal is 0."""
    d = extract_diagonal(A)
    if isinstance(d, torch.Tensor):
        return torch.where(d != 0, 1.0 / torch.where(d == 0, 1, d), 0.0)
    return np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)


# -- Jacobi family -------------------------------------------------------------

def jacobi(A, x, b, iterations=1, omega=1.0, Dinv=None):
    """Damped Jacobi: x <- x + omega * D^-1 (b - A x), ``iterations``
    times."""
    Dinv = dinv_vec(A) if Dinv is None else Dinv
    if _host(x, b, Dinv):
        x, b, Dinv = np.asarray(x), np.asarray(b), np.asarray(Dinv)
    Dinv = _bcast(Dinv, x)
    for _ in range(iterations):
        x = x + omega * Dinv * (b - matvec(A, x))
    return x


def _index_mask(indices, n, like):
    """A bool (n,) mask of ``indices`` (a bool mask or an index array),
    as a numpy array or on ``like``'s device."""
    if isinstance(like, torch.Tensor):
        idx = torch.as_tensor(indices, device=like.device)
        if idx.dtype == torch.bool:
            return idx
        return torch.zeros(n, dtype=torch.bool, device=like.device) \
            .index_fill_(0, idx.long(), True)
    idx = np.asarray(indices)
    if idx.dtype == bool:
        return idx
    mask = np.zeros(n, bool)
    mask[idx] = True
    return mask


def jacobi_indexed(A, x, b, indices, iterations=1, omega=1.0, Dinv=None):
    """Jacobi on the rows of ``indices`` (an index array or a bool mask of
    length n); the other rows keep their values."""
    host = _host(x, b)
    Dinv = dinv_vec(A) if Dinv is None else Dinv
    if host:
        x, b, Dinv = np.asarray(x), np.asarray(b), np.asarray(Dinv)
    mask = _bcast(_index_mask(indices, A.shape[0], x), x)
    Dinv = _bcast(Dinv, x)
    where = _where(host)
    for _ in range(iterations):
        x = where(mask, x + omega * Dinv * (b - matvec(A, x)), x)
    return x


def cf_jacobi(A, x, b, Cpts, Fpts, iterations=1, f_iterations=1,
              c_iterations=1, omega=1.0, Dinv=None):
    """CF-Jacobi: relax the C points, then the F points."""
    for _ in range(iterations):
        x = jacobi_indexed(A, x, b, Cpts, c_iterations, omega, Dinv)
        x = jacobi_indexed(A, x, b, Fpts, f_iterations, omega, Dinv)
    return x


def fc_jacobi(A, x, b, Cpts, Fpts, iterations=1, f_iterations=1,
              c_iterations=1, omega=1.0, Dinv=None):
    """FC-Jacobi: relax the F points, then the C points."""
    for _ in range(iterations):
        x = jacobi_indexed(A, x, b, Fpts, f_iterations, omega, Dinv)
        x = jacobi_indexed(A, x, b, Cpts, c_iterations, omega, Dinv)
    return x


# -- multicolor Gauss-Seidel / SOR ---------------------------------------------

def _host_graph(A):
    """A host ELL of the operator A's graph (an ELL, DIA or SELL, its
    arrays on the host or placed)."""
    from pyamg_tpu_torch.parallel.partition import host_ell
    if isinstance(A, ELL):
        return host_ell(A)
    if isinstance(A, DIA):
        data = A.data.cpu().numpy() if isinstance(A.data, torch.Tensor) \
            else A.data
        return from_scipy(to_scipy(DIA(data, A.offsets, A.shape)))
    if isinstance(A, SELL):
        if isinstance(A.vals, torch.Tensor):
            raise TypeError("a placed SELL keeps no host plan to color")
        return from_scipy(sell_to_scipy(A))
    raise TypeError(f"no graph to color in {type(A).__name__}")


def make_coloring(A, method="JP", seed=0):
    """(colors int32 (n,), ncolors) of the graph of A, as the JAX package
    colors it: an ELL (host or placed: the reference's arrays are
    concrete either way) by the port's native sequential first-fit,
    ignoring ``method``; any other operator (DIA, host SELL) by
    ``graph.vertex_coloring(method, seed)``.  The colors lie where A's
    arrays do (numpy, or a tensor on A's device)."""
    from pyamg_tpu_torch import _native
    from pyamg_tpu_torch.graph import vertex_coloring
    G = _host_graph(A)
    if isinstance(A, ELL):
        n = A.shape[0]
        row_nnz = np.asarray(G.row_nnz)
        indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int32)
        indices = np.asarray(G.cols)[G.valid_mask()].astype(np.int32)
        colors, nc = _native.first_fit_coloring(n, indptr, indices)
    else:
        colors = vertex_coloring(G, method=method, seed=seed)
        nc = int(colors.max()) + 1 if colors.shape[0] else 0
    arr = getattr(A, "data" if isinstance(A, DIA) else "vals")
    if isinstance(arr, torch.Tensor):
        colors = torch.as_tensor(colors, device=arr.device)
    return colors, nc


def gs_order(ncolors, sweep="forward", iterations=1, omega=1.0):
    """The color-pass sequence of a multicolor GS call.  With omega = 1 a
    pass leaves its rows' residuals at (roundoff) zero, so an immediately
    repeated color is a no-op and is dropped: symmetric (0,1)+(1,0)
    becomes (0,1,0)."""
    fwd = list(range(int(ncolors)))
    if sweep == "forward":
        seq = fwd
    elif sweep == "backward":
        seq = fwd[::-1]
    elif sweep == "symmetric":
        seq = fwd + fwd[::-1]
    else:
        raise ValueError(f"unknown sweep {sweep!r}")
    order = seq * int(iterations)
    if float(omega) == 1.0 and len(order) > 1:
        order = [order[0]] + [c for i, c in enumerate(order[1:])
                              if c != order[i]]
    return order


def gauss_seidel(A, x, b, iterations=1, sweep="forward", colors=None,
                 ncolors=None, Dinv=None, omega=1.0):
    """Multicolor Gauss-Seidel/SOR: per color c of the pass order, every
    row i of color c gets x_i += omega * (b_i - (A x)_i) / a_ii.
    ``sweep``: 'forward', 'backward' (reverse color order) or
    'symmetric'.  On a SELL operator: ``iterations`` hybrid sweeps."""
    if isinstance(A, SELL):
        Dinv = dinv_vec(A) if Dinv is None else Dinv
        for _ in range(iterations):
            x = sell_kernels.sell_gs_sweep(A, x, b, Dinv, omega, sweep)
        return x
    if colors is None:
        colors, ncolors = make_coloring(A)
    order = gs_order(ncolors, sweep, iterations, omega)
    Dinv = dinv_vec(A) if Dinv is None else Dinv
    return _color_passes(A, x, b, Dinv, colors, order, omega)


def _color_passes(A, x, b, Dinv, colors, order, omega):
    """The color passes ``order``: K2 on a real DIA tensor, else (a
    complex band too, as in the reference, ``pallas_kernels.py:220``) a
    loop of products and masked updates."""
    if isinstance(A, DIA) and isinstance(x, torch.Tensor) and \
            not A.data.is_complex():
        return dia_kernels.dia_gs_sweep(A.data, A.offsets, A.shape[0], x, b,
                                        Dinv, colors, order, omega)
    host = _host(x)
    if host:
        x, b = np.asarray(x), np.asarray(b)
        Dinv, colors = np.asarray(Dinv), np.asarray(colors)
    where = _where(host)
    Dinvb = _bcast(Dinv, x)
    for c in order:
        upd = x + omega * Dinvb * (b - matvec(A, x))
        x = where(_bcast(colors == c, x), upd, x)
    return x


def sor(A, x, b, omega, iterations=1, sweep="forward", colors=None,
        ncolors=None, Dinv=None):
    """SOR: multicolor Gauss-Seidel weighted by ``omega``."""
    return gauss_seidel(A, x, b, iterations=iterations, sweep=sweep,
                        colors=colors, ncolors=ncolors, Dinv=Dinv,
                        omega=omega)


def gauss_seidel_indexed(A, x, b, indices, iterations=1, sweep="forward",
                         colors=None, ncolors=None, Dinv=None):
    """Multicolor Gauss-Seidel on the rows of ``indices`` (an index array
    or a bool mask): the colors in order (reversed for 'backward'; any
    other sweep runs forward, as the reference does), ``iterations``
    times, no pass dropped.  On a DIA tensor the rows outside
    ``indices`` get color -1, which no pass updates, and the sweep is
    K2."""
    if colors is None:
        colors, ncolors = make_coloring(A)
    order = list(range(int(ncolors)))
    if sweep == "backward":
        order = order[::-1]
    Dinv = dinv_vec(A) if Dinv is None else Dinv
    if isinstance(x, torch.Tensor):
        colors = torch.as_tensor(colors, device=x.device)
    mask = _index_mask(indices, A.shape[0], colors)
    colors = _where(_host(colors))(mask, colors, -1)
    return _color_passes(A, x, b, Dinv, colors, order * int(iterations), 1.0)


# -- polynomial smoothers ------------------------------------------------------

def polynomial(A, x, b, coefficients, iterations=1):
    """x <- x + p(A) (b - A x), p's ``coefficients`` highest degree first,
    by Horner's rule."""
    coefficients = [float(c) for c in np.asarray(coefficients)]
    for _ in range(iterations):
        residual = b - matvec(A, x)
        h = coefficients[0] * residual
        for c in coefficients[1:]:
            h = c * residual + matvec(A, h)
        x = x + h
    return x


def chebyshev(A, x, b, rho=None, lower_fraction=1.0 / 30.0, degree=3,
              iterations=1, coefficients=None):
    """Chebyshev smoothing over [rho * lower_fraction, 1.1 rho]; ``rho``
    (host operators only) defaults to an estimate of the spectral radius
    of A."""
    if coefficients is None:
        from pyamg_tpu_torch.util.linalg import approximate_spectral_radius
        from pyamg_tpu_torch.relaxation.chebyshev import (
            chebyshev_polynomial_coefficients)
        if rho is None:
            rho = approximate_spectral_radius(A)
        coefficients = -chebyshev_polynomial_coefficients(
            rho * lower_fraction, 1.1 * rho, degree)[:-1]
    return polynomial(A, x, b, coefficients, iterations)


# -- normal-equation smoothers -------------------------------------------------

def _host_scipy(A):
    """A host operator (ELL, DIA or SELL) as scipy CSR."""
    return sell_to_scipy(A) if isinstance(A, SELL) else to_scipy(A)


def _inv_or_zero(v):
    return np.where(v != 0, 1.0 / np.where(v == 0, 1, v), 0.0).astype(v.dtype)


def ne_params(A):
    """What the normal-equation smoothers need of a host operator A:
    ``AH``, the host ELL of A^H, and the inverse squared norms of A's
    rows (``Dinv_rows``, of A A^H's diagonal) and columns (``Dinv_cols``,
    of A^H A's), 0 where a norm is 0."""
    S = _host_scipy(A).tocsr()
    sq = np.abs(S.data) ** 2
    rows = np.bincount(np.repeat(np.arange(S.shape[0]), np.diff(S.indptr)),
                       weights=sq, minlength=S.shape[0])
    cols = np.bincount(S.indices, weights=sq, minlength=S.shape[1])
    dt = np.abs(S.data[:0]).dtype
    return {"AH": from_scipy(S.conj().T.tocsr()),
            "Dinv_rows": _inv_or_zero(rows.astype(dt)),
            "Dinv_cols": _inv_or_zero(cols.astype(dt))}


def _ne(A, AH, Dinv, key):
    if AH is None or Dinv is None:
        p = ne_params(A)
        AH = p["AH"] if AH is None else AH
        Dinv = p[key] if Dinv is None else Dinv
    return AH, Dinv


def jacobi_ne(A, x, b, iterations=1, omega=1.0, AH=None, Dinv=None):
    """Jacobi on the normal equations A A^H y = b, x = A^H y:
    x <- x + omega * A^H D^-1 (b - A x), D = diag(A A^H) (the squared row
    norms).  ``AH`` and ``Dinv`` default to ``ne_params(A)``'s."""
    AH, Dinv = _ne(A, AH, Dinv, "Dinv_rows")
    for _ in range(iterations):
        x = x + omega * matvec(AH, Dinv * (b - matvec(A, x)))
    return x


def gauss_seidel_ne(A, x, b, iterations=1, sweep="forward", omega=1.0,
                    colors=None, ncolors=None, AH=None, Dinv=None):
    """Multicolor Kaczmarz (Gauss-Seidel on A A^H y = b): per color c of
    A's rows, x += A^H (omega D^-1 (b - A x) on the rows of c)."""
    if colors is None:
        colors, ncolors = make_coloring(A)
    AH, Dinv = _ne(A, AH, Dinv, "Dinv_rows")
    order = list(range(int(ncolors)))
    if sweep == "backward":
        order = order[::-1]
    where = _where(_host(x))
    for _ in range(iterations):
        for c in order:
            r = b - matvec(A, x)
            x = x + matvec(AH, where(colors == c, omega * Dinv * r, 0.0))
    return x


def gauss_seidel_nr(A, x, b, iterations=1, sweep="forward", omega=1.0,
                    colors=None, ncolors=None, AH=None, Dinv=None):
    """Multicolor Gauss-Seidel on A^H A x = A^H b: per color c,
    x += omega D^-1 A^H (b - A x) on the unknowns of c, D = diag(A^H A)
    (the squared column norms).  With fewer colors than unknowns (a
    rectangular A) every unknown is updated, as in the reference."""
    if colors is None:
        colors, ncolors = make_coloring(A)
    AH, Dinv = _ne(A, AH, Dinv, "Dinv_cols")
    m = A.shape[1]
    order = list(range(int(ncolors)))
    if sweep == "backward":
        order = order[::-1]
    where = _where(_host(x))
    for _ in range(iterations):
        for c in order:
            g = matvec(AH, b - matvec(A, x))
            on = colors[:m] == c if colors.shape[0] >= m else True
            x = x + where(on, omega * Dinv * g, 0.0)
    return x


# -- block smoothers (BELL) ----------------------------------------------------

def block_pattern(A: BELL) -> ELL:
    """The block graph of a host BELL as a host ELL of ones (what the
    block smoothers color)."""
    return ELL(A.cols, np.ones(A.cols.shape, np.float32), A.row_nnz,
               (A.n_block_rows, A.n_block_cols))


def block_dinv(A: BELL):
    """The pseudo-inverses of A's diagonal blocks, (nb, br, br): computed
    on the host (numpy's SVD), and placed where A's blocks are."""
    from pyamg_tpu_torch.ops.spmv import extract_block_diagonal
    from pyamg_tpu_torch.util.linalg import pinv_array
    D = extract_block_diagonal(A)
    if isinstance(D, torch.Tensor):
        return torch.as_tensor(pinv_array(D.cpu().numpy()), device=D.device)
    return pinv_array(D)


def _block_update(A: BELL, x, b, Dinv, mask):
    """blockdiag(Dinv) (b - A x) on the block rows of ``mask`` (all for
    None), 0 elsewhere, shaped as x."""
    nb, br = A.n_block_rows, A.blocksize[0]
    r = b - matvec(A, x)
    einsum = torch.einsum if isinstance(r, torch.Tensor) else np.einsum
    if x.ndim == 2:
        dx = einsum("nij,njk->nik", Dinv, r.reshape(nb, br, -1))
        m = None if mask is None else mask[:, None, None]
    else:
        dx = einsum("nij,nj->ni", Dinv, r.reshape(nb, br))
        m = None if mask is None else mask[:, None]
    if m is not None:
        dx = _where(_host(dx))(m, dx, 0)
    return dx.reshape(x.shape)


def _block_operands(A, x, b, Dinv):
    if not isinstance(A, BELL):
        raise TypeError(f"block smoothers take a BELL, not "
                        f"{type(A).__name__}")
    Dinv = block_dinv(A) if Dinv is None else Dinv
    if _host(x, b, Dinv):
        return np.asarray(x), np.asarray(b), np.asarray(Dinv)
    return x, b, Dinv


def block_jacobi(A, x, b, Dinv=None, iterations=1, omega=1.0):
    """Block Jacobi: x <- x + omega blockdiag(Dinv) (b - A x)."""
    x, b, Dinv = _block_operands(A, x, b, Dinv)
    if on_bell_kernel(A, x):
        L = bell_kernels.layout_of(A)
        for _ in range(iterations):
            x = bell_kernels.bell_apply(L, x.contiguous(), "jacobi",
                                        b=b.contiguous(), dinv=Dinv,
                                        omega=omega)
        return x
    for _ in range(iterations):
        x = x + omega * _block_update(A, x, b, Dinv, None)
    return x


def block_gauss_seidel(A, x, b, iterations=1, sweep="forward", Dinv=None,
                       colors=None, ncolors=None, omega=1.0):
    """Multicolor block Gauss-Seidel: per color c of the block graph's
    coloring (forward, backward or forward then backward for
    'symmetric', ``iterations`` times, no pass dropped), the block rows of
    c get omega blockdiag(Dinv) (b - A x).  On a vector tensor, where A's
    K7 layout is grouped by this ``colors`` tensor (a placed hierarchy's
    smoothers: ``smoothing.place_block_layouts``), a pass is one K7 launch
    on its color's rows; else a full product and a masked update."""
    x, b, Dinv = _block_operands(A, x, b, Dinv)
    if colors is None:
        colors, ncolors = make_coloring(block_pattern(A))
    L = bell_kernels.layout_of(A) if on_bell_kernel(A, x) else None
    if L is not None and (L.colors is not colors or
                          len(L.groups) != int(ncolors)):
        L = None
    if isinstance(x, torch.Tensor):
        colors = torch.as_tensor(colors, device=x.device)
    else:
        colors = np.asarray(colors)
    order = list(range(int(ncolors)))
    passes = {"forward": order, "backward": order[::-1],
              "symmetric": order + order[::-1]}
    if sweep not in passes:
        raise ValueError(f"unknown sweep {sweep!r}")
    if L is not None:
        # every pass in place on one copy of x (K7, one launch a pass)
        x, b = x.clone(memory_format=torch.contiguous_format), \
            b.contiguous()
        for _ in range(iterations):
            for c in passes[sweep]:
                bell_kernels.bell_apply(L, x, "gs_color", b=b, dinv=Dinv,
                                        omega=omega, group=c)
        return x
    for _ in range(iterations):
        for c in passes[sweep]:
            x = x + omega * _block_update(A, x, b, Dinv, colors == c)
            if isinstance(x, torch.Tensor):
                launch.tally(bell_kernels.count_gs_passes, None)
    return x


def block_jacobi_indexed(A, x, b, indices, Dinv=None, iterations=1,
                         omega=1.0):
    """Block Jacobi on the block rows of ``indices`` (block-row indices or
    a bool mask over block rows); the others keep their values."""
    x, b, Dinv = _block_operands(A, x, b, Dinv)
    mask = _index_mask(indices, A.n_block_rows, x)
    if on_bell_kernel(A, x):
        L = bell_kernels.layout_of(A)
        for _ in range(iterations):
            x = bell_kernels.bell_apply(L, x.contiguous(), "jacobi",
                                        b=b.contiguous(), dinv=Dinv,
                                        omega=omega, mask=mask)
        return x
    for _ in range(iterations):
        x = x + omega * _block_update(A, x, b, Dinv, mask)
    return x


def cf_block_jacobi(A, x, b, Cpts, Fpts, Dinv=None, iterations=1,
                    f_iterations=1, c_iterations=1, omega=1.0):
    """CF block Jacobi: relax the C blocks, then the F blocks."""
    Dinv = block_dinv(A) if Dinv is None else Dinv
    for _ in range(iterations):
        x = block_jacobi_indexed(A, x, b, Cpts, Dinv, c_iterations, omega)
        x = block_jacobi_indexed(A, x, b, Fpts, Dinv, f_iterations, omega)
    return x


def fc_block_jacobi(A, x, b, Cpts, Fpts, Dinv=None, iterations=1,
                    f_iterations=1, c_iterations=1, omega=1.0):
    """FC block Jacobi: relax the F blocks, then the C blocks."""
    Dinv = block_dinv(A) if Dinv is None else Dinv
    for _ in range(iterations):
        x = block_jacobi_indexed(A, x, b, Fpts, Dinv, f_iterations, omega)
        x = block_jacobi_indexed(A, x, b, Cpts, Dinv, c_iterations, omega)
    return x


# -- overlapping Schwarz -------------------------------------------------------

def _schwarz_operator(A):
    if not isinstance(A, ELL):
        raise TypeError(
            f"the Schwarz smoothers take an uncompressed (ELL) hierarchy, "
            f"not a {type(A).__name__} level: set them up and solve before "
            f"compress_stencils, or leave the hierarchy uncompressed")


def schwarz_params(A: ELL, subdomain):
    """The arrays of an additive Schwarz sweep on the host ELL A, from the
    subdomains' padded member lists ``subdomain`` (ns, ms), -1 padded
    (setup phase): ``subdomain`` as given and ``pad``; ``lu``, the LU
    factors with partial pivoting of each subdomain's dense ``A[S, S]``
    (the identity on its pads), in A's dtype, and ``index``/``pad_rows``,
    the members (pads at node 0) and pads in the factors' row order;
    ``owners``, for each node the flat slots ``s * ms + m`` of the
    subdomains holding it in slot order, padded with the slot ``ns * ms``
    that holds 0; and ``count``, the number of subdomains holding each
    node, at least 1, in A's dtype.  A twin in another dtype
    (``MultilevelSolver.as_dtype``) casts the factors; it does not factor
    again."""
    from pyamg_tpu_torch.ops.rowops import ell_dedup, row_lookup
    _schwarz_operator(A)
    sub = np.asarray(subdomain)
    ns, ms = sub.shape
    pad = sub < 0
    idx = np.where(pad, 0, sub).astype(np.int64)
    # column-sorted rows without duplicates, as row_lookup reads them
    A = ell_dedup(A.cols, A.vals, A.valid_mask(), A.shape)
    flat = idx.reshape(-1)
    rows = ELL(np.asarray(A.cols)[flat], np.asarray(A.vals)[flat],
               np.asarray(A.row_nnz)[flat], (ns * ms, A.shape[1]))
    blocks = row_lookup(rows, np.repeat(idx, ms, axis=0)).reshape(ns, ms, ms)
    eye = np.eye(ms, dtype=bool)[None]
    blocks = np.where(pad[:, :, None] | pad[:, None, :], eye, blocks).astype(
        A.vals.dtype)
    lu, piv, _ = torch.linalg.lu_factor_ex(torch.from_numpy(blocks))
    # LAPACK's row interchanges (1-based, row i swapped with row piv[i]
    # in order) as a row order: A[S, S][perm] = L U
    piv = piv.numpy().astype(np.int64) - 1
    perm = np.broadcast_to(np.arange(ms), (ns, ms)).copy()
    r = np.arange(ns)
    for i in range(ms):
        a, b = perm[r, i].copy(), perm[r, piv[:, i]].copy()
        perm[r, i], perm[r, piv[:, i]] = b, a
    slot = np.flatnonzero(~pad.reshape(-1))
    node = sub.reshape(-1)[slot]
    order = np.argsort(node, kind="stable")
    node, slot = node[order], slot[order]
    counts = np.bincount(node, minlength=A.shape[0])
    owners = np.full((A.shape[0], max(int(counts.max(initial=0)), 1)),
                     ns * ms, np.int64)
    owners[node, np.arange(len(node)) - np.searchsorted(node, node)] = slot
    return {"subdomain": sub, "pad": pad, "lu": lu.numpy(),
            "index": np.take_along_axis(idx, perm, axis=1),
            "pad_rows": np.take_along_axis(pad, perm, axis=1),
            "owners": owners,
            "count": np.maximum(counts, 1).astype(A.vals.dtype)}


def schwarz(A, x, b, subdomain, subdomain_ptr=None, iterations=1,
            max_size=None, params=None):
    """Additive overlapping Schwarz on the ELL A, ``iterations`` times:
    ``x += mean over the subdomains S holding a node of A[S, S]^-1 r[S]``
    with ``r = b - A x`` (the JAX package's ``schwarz``; reference
    ``relaxation.py:157``), each block solved by its LU factors.
    ``subdomain`` (ns, ms) lists each subdomain's nodes, -1 padded;
    ``params`` (``schwarz_params``, as the smoother keeps them) saves
    gathering and factoring the blocks again.  A DIA, SELL or
    PhaseStencil operator raises ``TypeError``."""
    _schwarz_operator(A)
    host = _host(x, b)
    if params is None:
        A_host = A if not isinstance(A.cols, torch.Tensor) else ELL(
            A.cols.cpu().numpy(), A.vals.cpu().numpy(),
            A.row_nnz.cpu().numpy(), A.shape)
        params = schwarz_params(A_host, subdomain)
    if host:
        A = A.to("cpu")
        x, b = torch.from_numpy(np.asarray(x)), torch.from_numpy(
            np.asarray(b))
    p = {k: torch.as_tensor(v, device=x.device) for k, v in params.items()
         if k != "subdomain"}
    zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        r = b - matvec(A, x)
        rs = torch.where(p["pad_rows"], 0, r[p["index"]])[..., None]
        y = torch.linalg.solve_triangular(p["lu"], rs, upper=False,
                                          unitriangular=True)
        dx = torch.linalg.solve_triangular(p["lu"], y, upper=True)[..., 0]
        dx = torch.where(p["pad"], 0, dx)
        upd = torch.cat([dx.reshape(-1), zero])[p["owners"]].sum(dim=1)
        x = x + upd / p["count"]
    return x.numpy() if host else x
