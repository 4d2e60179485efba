"""Plain reference of 2-D linear elasticity solved by smoothed aggregation
(``elasticity2d_sa``): the operator and its rigid-body modes assembled
from the Q1 element stiffness, the hierarchy built by PyAMG's rules in
NumPy and SciPy, and the solve (CG preconditioned by a V(1,1) cycle of
multicolor block Gauss-Seidel, outer residual corrections) in plain
PyTorch, in one dtype throughout.  The float64 reference is what the
program is held to; the same code in float32 is the control (no
double-single outer residual).  Imports nothing of the program.

The operator is PyAMG's ``gallery.linear_elasticity((n, n))``: Q1
elements of side 1 on the (n+1) x (n+1) cells around n x n interior
nodes, plane strain with E = 1e5 and nu = 0.3 (2 x 2 Gauss points), the
boundary nodes removed (Dirichlet), unknowns (u_x, u_y) of interior node
(i, j) at rows 2 (i n + j) and 2 (i n + j) + 1, 2 x 2 blocks; B holds the
two translations and the rotation (-y, x) about the grid's centre.

The hierarchy follows ``smoothed_aggregation_solver(A, B=B,
max_coarse=50)`` with PyAMG's defaults: symmetric strength with theta 0
(every stored block a strong connection, the node graph); standard
aggregation's three passes in node order; 4 symmetric block Gauss-Seidel
sweeps on A x = 0 to improve the candidates; the tentative prolongator
by a Gram-Schmidt QR of each aggregate's rows of B; P = (I - omega D^-1
A) T with omega = (4/3) / rho(D^-1 A); R = P^T; Ac = R A P; coarsening
while a level has more than ``max_coarse`` block rows.  The cycle is cut
at the first level of at most ``collapse_n`` rows and solved there by
its dense inverse.

Departures from PyAMG, each as the configuration's program runs it:

- The block Gauss-Seidel of the smoother and of the candidates is
  multicolor over a greedy first-fit coloring of the node graph (in node
  order), each color pass x_c += D_c^-1 (b - A x)_c with the pseudo-
  inverted diagonal blocks, a symmetric sweep every color forward then
  backward; PyAMG's is sequential, block row by block row.
- Jacobi smoothing of P scales A's block rows by the pseudo-inverted
  diagonal blocks (PyAMG's ``weighting='block'``), with omega divided by
  rho of the scalar-diagonal D^-1 A (PyAMG's default ``'diagonal'``
  scales by the scalar diagonal).
- rho(D^-1 A) is computed by Lanczos to a relative 1e-3 (PyAMG's
  estimate stops at 1e-2).
- Standard aggregation's third pass puts each leftover node's free
  neighbours in the aggregate it seeds and leaves them there."""

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from amg_bench.reference.ell import Ell

E, NU = 1e5, 0.3


def element_stiffness(E=E, nu=NU):
    """The 8 x 8 plane-strain stiffness of the unit square's bilinear
    element by 2 x 2 Gauss quadrature; corners (0, 0), (1, 0), (1, 1),
    (0, 1), unknowns (u_x, u_y) of each corner in turn."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 + 2 * nu)
    C = np.array([[lam + 2 * mu, lam, 0.0],
                  [lam, lam + 2 * mu, 0.0],
                  [0.0, 0.0, mu]])
    K = np.zeros((8, 8))
    for gx in (-1 / math.sqrt(3), 1 / math.sqrt(3)):
        for gy in (-1 / math.sqrt(3), 1 / math.sqrt(3)):
            # the point (s, t) of the unit square and the bilinear basis
            s, t = (gx + 1) / 2, (gy + 1) / 2
            dNds = np.array([-(1 - t), 1 - t, t, -t])
            dNdt = np.array([-(1 - s), -s, s, 1 - s])
            strain = np.zeros((3, 8))
            strain[0, 0::2] = dNds
            strain[1, 1::2] = dNdt
            strain[2, 0::2] = dNdt
            strain[2, 1::2] = dNds
            K += strain.T @ C @ strain * 0.25    # weight 1 over [-1, 1]^2
    return K


def assemble(n, corners):
    """The elasticity operator of n x n interior nodes (CSR, float64) and
    its rigid-body modes, with ``corners``: the node offsets (in the
    (n+2) x (n+2) node grid, row-major) of ``element_stiffness``'s four
    corners from an element's lower-left node."""
    N = n + 2                                   # nodes a side, boundary in
    K = element_stiffness()
    ll = (np.arange(N - 1)[:, None] * N + np.arange(N - 1)).ravel()
    nodes = ll[:, None] + np.asarray(corners)[None, :]       # (cells, 4)
    dofs = np.stack([2 * nodes, 2 * nodes + 1], axis=2).reshape(-1, 8)
    rows = np.repeat(dofs, 8, axis=1).ravel()
    cols = np.tile(dofs, (1, 8)).ravel()
    vals = np.tile(K.ravel(), len(ll))
    A = sp.coo_matrix((vals, (rows, cols)), shape=(2 * N * N,) * 2).tocsr()
    y, x = np.divmod(np.arange(N * N), N)
    x, y = x - (N - 1) / 2, y - (N - 1) / 2
    B = np.zeros((2 * N * N, 3))
    B[0::2, 0] = 1
    B[1::2, 1] = 1
    B[0::2, 2] = -y
    B[1::2, 2] = x
    inner = ((y > -(N - 1) / 2) & (y < (N - 1) / 2) &
             (x > -(N - 1) / 2) & (x < (N - 1) / 2))
    keep = np.stack([2 * np.flatnonzero(inner),
                     2 * np.flatnonzero(inner) + 1], axis=1).ravel()
    return A[keep][:, keep], B[keep]


def operator(n, dtype=np.float64):
    """(A, B): the n x n elasticity operator as SciPy BSR with 2 x 2
    blocks and its rigid-body modes (2 n^2, 3)."""
    A, B = assemble(n, (0, 1, n + 3, n + 2))
    A = A.tobsr(blocksize=(2, 2))
    A.sort_indices()
    return A.astype(dtype), B.astype(dtype)


def true_relres(A, b, x):
    """||b - A x|| / ||b|| in float64."""
    x = np.asarray(x, np.float64).reshape(-1)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


# -- the hierarchy -------------------------------------------------------------

def standard_aggregation(indptr, indices):
    """PyAMG's three-pass standard aggregation in node order: labels (an
    aggregate a node, -1 for a node with no neighbour) and the count."""
    n = len(indptr) - 1
    Ap, Aj = indptr.tolist(), indices.tolist()
    label = [-2] * n                    # -2 free, -1 isolated
    nagg = 0
    for i in range(n):                  # pass 1: seeds with free neighbours
        if label[i] != -2:
            continue
        nbrs = [j for j in Aj[Ap[i]:Ap[i + 1]] if j != i]
        if not nbrs:
            label[i] = -1
        elif all(label[j] == -2 for j in nbrs):
            label[i] = nagg
            for j in nbrs:
                label[j] = nagg
            nagg += 1
    first = [lab for lab in label]      # pass 2 sees pass 1's aggregates
    for i in range(n):
        if label[i] != -2:
            continue
        for j in Aj[Ap[i]:Ap[i + 1]]:
            if first[j] >= 0:
                label[i] = first[j]
                break
    for i in range(n):                  # pass 3: leftovers seed new ones
        if label[i] != -2:
            continue
        label[i] = nagg
        for j in Aj[Ap[i]:Ap[i + 1]]:
            if label[j] == -2:
                label[j] = nagg
        nagg += 1
    return np.array(label, np.int64), nagg


def first_fit_colors(indptr, indices):
    """A greedy coloring of the node graph in node order: each node the
    smallest color none of its neighbours colored before it holds."""
    n = len(indptr) - 1
    Ap, Aj = indptr.tolist(), indices.tolist()
    color = [-1] * n
    for i in range(n):
        seen = {color[j] for j in Aj[Ap[i]:Ap[i + 1]] if j != i}
        c = 0
        while c in seen:
            c += 1
        color[i] = c
    colors = np.array(color, np.int64)
    return colors, int(colors.max()) + 1


def diagonal_blocks(A):
    """(nb, bs, bs) diagonal blocks of a BSR matrix."""
    nb, bs = A.shape[0] // A.blocksize[0], A.blocksize[0]
    D = np.zeros((nb, bs, bs), A.dtype)
    rows = np.repeat(np.arange(nb), np.diff(A.indptr))
    on = A.indices == rows
    D[rows[on]] = A.data[on]
    return D


def block_gs(A, x, b, dinv, colors, ncolors, sweeps):
    """Symmetric multicolor block Gauss-Seidel in SciPy (the candidates'
    sweeps of the set-up): x (n, k) updated a color pass at a time."""
    bs = A.blocksize[0]
    nb = A.shape[0] // bs
    order = list(range(ncolors)) + list(range(ncolors))[::-1]
    for _ in range(sweeps):
        for c in order:
            r = (b - A @ x).reshape(nb, bs, -1)
            on = colors == c
            x.reshape(nb, bs, -1)[on] += np.einsum("nij,njk->nik", dinv[on],
                                                   r[on])
    return x


def fit_candidates(labels, nagg, B, bs, tol=1e-10):
    """(T as BSR (n bs, nagg k) with (bs, k) blocks, Bc (nagg k, k)): each
    aggregate's rows of B orthonormalised column by column (modified
    Gram-Schmidt, a column dropped below ``tol`` of its norm), R its
    coarse candidates."""
    nb, k = len(labels), B.shape[1]
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=nagg)
    m = int(counts.max())
    slot = np.arange(nb) - np.repeat(np.cumsum(counts) - counts, counts)
    W = np.zeros((nagg, m, bs, k), B.dtype)
    W[labels[order], slot] = B.reshape(nb, bs, k)[order]
    W = W.reshape(nagg, m * bs, k)
    Q = np.zeros_like(W)
    R = np.zeros((nagg, k, k), B.dtype)
    for j in range(k):
        col = W[:, :, j].copy()
        pre = np.sqrt(np.sum(col * col, axis=1))
        for i in range(j):
            rij = np.sum(Q[:, :, i] * col, axis=1)
            col -= rij[:, None] * Q[:, :, i]
            R[:, i, j] = rij
        nrm = np.sqrt(np.sum(col * col, axis=1))
        keep = nrm > tol * pre
        Q[:, :, j] = np.where(keep[:, None],
                              col / np.where(nrm == 0, 1, nrm)[:, None], 0)
        R[:, j, j] = np.where(keep, nrm, 0)
    blocks = np.zeros((nb, bs, k), B.dtype)
    blocks[order] = Q.reshape(nagg, m, bs, k)[labels[order], slot]
    T = sp.bsr_matrix((blocks, labels, np.arange(nb + 1)),
                      shape=(nb * bs, nagg * k))
    return T, R.reshape(nagg * k, k)


def rho_dinv_a(A):
    """The largest eigenvalue of D^-1 A (D the scalar diagonal), from
    D^-1/2 A D^-1/2, to a relative 1e-3 (Lanczos from a seeded start)."""
    d = 1.0 / np.sqrt(A.diagonal().astype(np.float64))
    S = (sp.diags(d) @ A.astype(np.float64).tocsr() @ sp.diags(d)).tocsr()
    if S.shape[0] <= 64:
        return float(np.linalg.eigvalsh(S.toarray()).max())
    v0 = np.random.default_rng(0).random(S.shape[0]) - 0.5
    return float(spla.eigsh(S, k=1, which="LA", tol=1e-3, v0=v0,
                            return_eigenvectors=False)[0])


def hierarchy(n, dtype=np.float64, max_coarse=50, max_levels=10,
              omega=4.0 / 3.0, improve_sweeps=4):
    """The levels of elasticity n^2: a list of dicts with ``A`` (BSR) and,
    for all but the last, ``P`` (BSR), ``colors`` and ``ncolors`` of the
    node graph."""
    A, B = operator(n, dtype)
    levels = [{"A": A}]
    while len(levels) < max_levels and \
            A.shape[0] // A.blocksize[0] > max_coarse:
        bs = A.blocksize[0]
        # the node graph, every stored block a strong connection (the
        # symmetric strength with theta 0)
        indptr, indices = A.indptr, A.indices
        labels, nagg = standard_aggregation(indptr, indices)
        if nagg == 0 or nagg >= len(labels):
            break
        colors, nc = first_fit_colors(indptr, indices)
        dinv = np.linalg.pinv(diagonal_blocks(A)).astype(dtype)
        B = block_gs(A, B.copy(), np.zeros_like(B), dinv, colors, nc,
                     improve_sweeps)
        T, Bc = fit_candidates(labels, nagg, B, bs)
        w = omega / rho_dinv_a(A)
        AT = (A @ T).tobsr(blocksize=(bs, T.blocksize[1]))
        AT.sort_indices()
        rows = np.repeat(np.arange(A.shape[0] // bs), np.diff(AT.indptr))
        AT.data[:] = np.einsum("nij,njk->nik", dinv[rows] * dtype(w),
                               AT.data)
        P = (T - AT).tobsr(blocksize=T.blocksize)
        P.sort_indices()
        R = P.T.tobsr(blocksize=(P.blocksize[1], P.blocksize[0]))
        Ac = (R @ A @ P).tobsr(blocksize=(P.blocksize[1],) * 2)
        Ac.sort_indices()
        levels[-1].update(P=P, colors=colors, ncolors=nc)
        levels.append({"A": Ac})
        A, B = Ac, Bc
    return levels


def describe(levels):
    """Levels, rows, block sizes and stored entries (every entry of every
    stored block) of each level, as the comparison takes them."""
    return {"levels": len(levels),
            "rows": [int(l["A"].shape[0]) for l in levels],
            "blocksize": [int(l["A"].blocksize[0]) for l in levels],
            "nnz": [int(l["A"].nnz) for l in levels]}


class Solver:
    """The solve of the configuration on ``levels``, in ``dtype`` on
    ``device`` (float64: the reference; float32: the control)."""

    def __init__(self, levels, device, dtype, collapse_n=4096):
        k = next((i for i, l in enumerate(levels)
                  if l["A"].shape[0] <= collapse_n), len(levels) - 1)
        if k == 0:
            k = len(levels) - 1
        self.dtype, self.device = dtype, device
        self.A0 = Ell(levels[0]["A"].tocsr(), device, dtype)
        self.levels = []
        for lvl in levels[:k]:
            A, P = lvl["A"], lvl["P"]
            bs = A.blocksize[0]
            colors = torch.as_tensor(lvl["colors"], device=device)
            dinv = np.linalg.pinv(diagonal_blocks(A).astype(np.float64))
            self.levels.append({
                "A": Ell(A.tocsr(), device, dtype),
                "P": Ell(P.tocsr(), device, dtype),
                "R": Ell(P.T.tocsr(), device, dtype),
                "bs": bs,
                "dinv": torch.as_tensor(dinv, device=device).to(dtype),
                "masks": [(colors == c)[:, None]
                          for c in range(lvl["ncolors"])],
                "order": list(range(lvl["ncolors"])) +
                list(range(lvl["ncolors"]))[::-1]})
        dense = levels[k]["A"].toarray().astype(np.float64)
        self.coarse = torch.as_tensor(np.linalg.inv(dense),
                                      device=device).to(dtype)

    def _smooth(self, L, x, b):
        bs = L["bs"]
        for c in L["order"]:
            r = (b - L["A"].mv(x)).reshape(-1, bs)
            dx = torch.einsum("nij,nj->ni", L["dinv"], r)
            x = x + torch.where(L["masks"][c], dx, 0).reshape(-1)
        return x

    def cycle(self, b, level=0):
        """One V(1,1) cycle from zero on b."""
        if level == len(self.levels):
            return self.coarse @ b
        L = self.levels[level]
        x = self._smooth(L, torch.zeros_like(b), b)
        r = b - L["A"].mv(x)
        x = x + L["P"].mv(self.cycle(L["R"].mv(r), level + 1))
        return self._smooth(L, x, b)

    def cg(self, b, tol, maxiter):
        """Preconditioned CG from zero: (x, iterations), stopped once the
        recursive residual is below tol * ||b||."""
        x = torch.zeros_like(b)
        r = b.clone()
        z = self.cycle(r)
        p = z
        rz = torch.dot(r, z)
        limit = tol * float(torch.linalg.vector_norm(b))
        it = 0
        while it < maxiter and float(torch.linalg.vector_norm(r)) >= limit:
            Ap = self.A0.mv(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.cycle(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        return x, it

    def solve(self, b, tol, inner_tol, inner_maxiter, max_outer):
        """Outer residual corrections, each by CG on the scaled residual:
        (x as float64 numpy, outer corrections, inner CG iterations)."""
        b = torch.as_tensor(np.asarray(b, np.float64),
                            device=self.device).to(self.dtype)
        x = torch.zeros_like(b)
        normb = float(torch.linalg.vector_norm(b)) or 1.0
        r, outer, inner = b, 0, 0
        nr = float(torch.linalg.vector_norm(r))
        while outer < max_outer and not nr <= tol * normb:
            e, it = self.cg(r / nr, inner_tol, inner_maxiter)
            x = x + nr * e
            r = b - self.A0.mv(x)
            nr = float(torch.linalg.vector_norm(r))
            outer += 1
            inner += it
            if not math.isfinite(nr):
                break
        return x.double().cpu().numpy(), outer, inner
