"""Minimal P1/P2 finite-element toolkit (counterpart of
``pyamg_tpu/gallery/fem.py``; reference ``pyamg/gallery/fem.py``):
triangle meshes, diffusion forms, boundary conditions, L2 norms, uniform
refinement, and a Stokes assembly.

Assembly is vectorized numpy over elements on the host; operators come
back as scipy CSR (``sparse.matrix.from_scipy`` makes a host ELL of one).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def check_mesh(V, E):
    """Validate (V, E) arrays (reference ``fem.py:6``)."""
    V = np.asarray(V)
    E = np.asarray(E)
    if V.ndim != 2 or V.shape[1] != 2:
        raise ValueError("V should be (#points, 2)")
    if E.ndim != 2 or E.shape[1] != 3:
        raise ValueError("E should be (#elements, 3)")
    if E.min() < 0 or E.max() >= V.shape[0]:
        raise ValueError("element indices out of range")
    return True


def diameter(V, E):
    """Max element edge length (reference ``fem.py:109``)."""
    V, E = np.asarray(V), np.asarray(E)
    d = 0.0
    for a, b in [(0, 1), (1, 2), (0, 2)]:
        d = max(d, np.max(np.linalg.norm(V[E[:, a]] - V[E[:, b]], axis=1)))
    return d


def _edges_of(E):
    """Unique undirected edges + per-element edge ids."""
    e = np.vstack([E[:, [0, 1]], E[:, [1, 2]], E[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, inv = np.unique(e, axis=0, return_inverse=True)
    return uniq, inv.reshape(3, -1).T      # (nedge, 2), (nelem, 3)


def generate_quadratic(V, E, return_edges=False):
    """Add edge-midpoint nodes for P2 elements (reference ``fem.py:19``).
    Returns (V2, E2) with E2 of shape (nelem, 6)."""
    V, E = np.asarray(V, float), np.asarray(E)
    check_mesh(V, E)
    edges, elem_edges = _edges_of(E)
    mids = 0.5 * (V[edges[:, 0]] + V[edges[:, 1]])
    V2 = np.vstack([V, mids])
    E2 = np.hstack([E, V.shape[0] + elem_edges])
    if return_edges:
        return V2, E2, edges
    return V2, E2


def refine2dtri(V, E, marked_elements=None):
    """Uniform (red) refinement of marked triangles (reference
    ``fem.py:152``); ``None`` refines everything."""
    V, E = np.asarray(V, float), np.asarray(E)
    if marked_elements is None:
        marked = np.arange(E.shape[0])
    else:
        marked = np.asarray(marked_elements)
    # uniform refinement of the whole mesh keeps conformity trivially;
    # for marked subsets fall back to refining all (red-green closure is
    # out of scope, matching the common usage mesh.refine(levels))
    edges, elem_edges = _edges_of(E)
    mids = 0.5 * (V[edges[:, 0]] + V[edges[:, 1]])
    nV = V.shape[0]
    V2 = np.vstack([V, mids])
    m01 = nV + elem_edges[:, 0]
    m12 = nV + elem_edges[:, 1]
    m20 = nV + elem_edges[:, 2]
    E2 = np.vstack([
        np.stack([E[:, 0], m01, m20], axis=1),
        np.stack([m01, E[:, 1], m12], axis=1),
        np.stack([m20, m12, E[:, 2]], axis=1),
        np.stack([m01, m12, m20], axis=1)])
    return V2, E2


class Mesh:
    """Triangle mesh with optional P2 nodes (reference ``fem.py:398``)."""

    def __init__(self, V, E, degree=1):
        V = np.asarray(V, float)
        E = np.asarray(E)
        check_mesh(V, E)
        self.V = V
        self.E = E
        self.degree = degree
        self.V2 = None
        self.E2 = None
        if degree == 2:
            self.generate_quadratic()

    @property
    def nv(self):
        return self.V.shape[0]

    @property
    def ne(self):
        return self.E.shape[0]

    def generate_quadratic(self):
        if self.V2 is None:
            self.V2, self.E2 = generate_quadratic(self.V, self.E)
        return self.V2, self.E2

    def refine(self, levels):
        for _ in range(levels):
            self.V, self.E = refine2dtri(self.V, self.E)
        self.V2 = None
        self.E2 = None
        if self.degree == 2:
            self.generate_quadratic()
        return self

    def smooth(self, maxit=10, tol=0.01):
        """Laplacian smoothing of interior vertices (reference
        ``fem.py:484``)."""
        V, E = self.V, self.E
        edges, _ = _edges_of(E)
        bedges = _boundary_edges(E)
        bnodes = np.unique(bedges)
        n = V.shape[0]
        W = sp.coo_matrix(
            (np.ones(2 * len(edges)),
             (np.concatenate([edges[:, 0], edges[:, 1]]),
              np.concatenate([edges[:, 1], edges[:, 0]]))),
            shape=(n, n)).tocsr()
        deg = np.asarray(W.sum(axis=1)).ravel()
        for _ in range(maxit):
            Vn = W @ V / deg[:, None]
            Vn[bnodes] = V[bnodes]
            if np.abs(Vn - V).max() < tol * diameter(V, E):
                V = Vn
                break
            V = Vn
        self.V = V
        self.V2 = None
        if self.degree == 2:
            self.generate_quadratic()
        return self


def _boundary_edges(E):
    e = np.vstack([E[:, [0, 1]], E[:, [1, 2]], E[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, counts = np.unique(e, axis=0, return_counts=True)
    return uniq[counts == 1]


# P2 reference-element quadrature (order-2 exact: 3 midpoints)
_QPTS = np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]])
_QWTS = np.array([1.0, 1.0, 1.0]) / 3.0


def _p1_basis(l1, l2):
    """P1 shape values/gradients at barycentric (l1, l2)."""
    lam = np.array([1 - l1 - l2, l1, l2])
    grad = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    return lam, grad


def _p2_basis(l1, l2):
    l0 = 1 - l1 - l2
    lam = np.array([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1),
                    l2 * (2 * l2 - 1), 4 * l0 * l1, 4 * l1 * l2,
                    4 * l2 * l0])
    dl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    g0, g1, g2 = dl
    grad = np.array([
        (4 * l0 - 1) * g0, (4 * l1 - 1) * g1, (4 * l2 - 1) * g2,
        4 * (l0 * g1 + l1 * g0), 4 * (l1 * g2 + l2 * g1),
        4 * (l2 * g0 + l0 * g2)])
    return lam, grad


def gradgradform(mesh, kappa=None, f=None, degree=None):
    """Assemble the diffusion bilinear form (stiffness A and load b):
    ``a(u,v) = \\int kappa grad u . grad v``, ``(f, v)``
    (reference ``fem.py:555``)."""
    degree = degree or mesh.degree
    if kappa is None:
        def kappa(_x, _y):
            return 1.0
    if f is None:
        def f(_x, _y):
            return 1.0

    if degree == 1:
        V, E = mesh.V, mesh.E
        basis = _p1_basis
        ndofs = 3
    else:
        V2, E2 = mesh.generate_quadratic()
        V, E = V2, E2
        basis = _p2_basis
        ndofs = 6

    X = mesh.V[mesh.E]                              # (ne, 3, 2) vertices
    J = np.stack([X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]], axis=2)
    detJ = (J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0])
    area = np.abs(detJ) / 2.0
    Jinv = np.empty_like(J)
    Jinv[:, 0, 0] = J[:, 1, 1]
    Jinv[:, 0, 1] = -J[:, 0, 1]
    Jinv[:, 1, 0] = -J[:, 1, 0]
    Jinv[:, 1, 1] = J[:, 0, 0]
    Jinv = Jinv / detJ[:, None, None]

    ne = mesh.ne
    Ke = np.zeros((ne, ndofs, ndofs))
    be = np.zeros((ne, ndofs))
    for (l1, l2), w in zip(_QPTS, _QWTS):
        lam, gref = basis(l1, l2)
        # physical gradients: gphys = gref @ Jinv
        g = np.einsum("ak,nkj->naj", gref, Jinv)     # (ne, ndofs, 2)
        xq = (X[:, 0] * (1 - l1 - l2) + X[:, 1] * l1 + X[:, 2] * l2)
        kq = np.array([kappa(x, y) for x, y in xq])
        fq = np.array([f(x, y) for x, y in xq])
        Ke += w * kq[:, None, None] * np.einsum("naj,nbj->nab", g, g) * \
            area[:, None, None]
        be += w * fq[:, None] * lam[None, :] * area[:, None]

    rows = np.repeat(E, ndofs, axis=1).ravel()
    cols = np.tile(E, (1, ndofs)).ravel()
    A = sp.coo_matrix((Ke.ravel(), (rows, cols)),
                      shape=(V.shape[0], V.shape[0])).tocsr()
    b = np.zeros(V.shape[0])
    np.add.at(b, E.ravel(), be.ravel())
    return A, b


def l2norm(u, mesh):
    """Elementwise-quadrature L2 norm of a FE function (reference
    ``fem.py:282``)."""
    degree = mesh.degree
    if degree == 1:
        E = mesh.E
        basis = _p1_basis
    else:
        _, E = mesh.generate_quadratic()
        basis = _p2_basis
    X = mesh.V[mesh.E]
    J = np.stack([X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]], axis=2)
    area = np.abs(J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]) / 2
    u = np.asarray(u)
    total = 0.0
    for (l1, l2), w in zip(_QPTS, _QWTS):
        lam, _ = basis(l1, l2)
        uq = u[E] @ lam
        total += w * np.sum(uq ** 2 * area)
    return float(np.sqrt(total))


def applybc(A, b, mesh, bc, remove_dirichlet=False):
    """Apply Dirichlet conditions (reference ``fem.py:872``).

    ``bc``: list of dicts with 'id' (node array) and 'g' (callable or
    values)."""
    A = A.tolil() if not sp.issparse(A) else A.tocsr().copy()
    b = np.asarray(b, float).copy()
    if mesh.degree == 2:
        V, _ = mesh.generate_quadratic()
    else:
        V = mesh.V
    all_ids = []
    for cond in bc:
        ids = np.asarray(cond["id"])
        g = cond.get("g", 0.0)
        vals = np.array([g(x, y) for x, y in V[ids]]) if callable(g) \
            else np.full(len(ids), g, float)
        # move known values to the rhs, zero rows/cols, unit diagonal
        b -= np.asarray(A[:, ids] @ vals).ravel()
        b[ids] = vals
        all_ids.append(ids)
    ids = np.unique(np.concatenate(all_ids)) if all_ids else \
        np.zeros(0, int)
    mask = np.zeros(A.shape[0], bool)
    mask[ids] = True
    D = sp.diags_array((~mask).astype(float))
    A = D @ A @ D + sp.diags_array(mask.astype(float))
    A = A.tocsr()
    A.eliminate_zeros()
    if remove_dirichlet:
        keep = np.where(~mask)[0]
        A = A[keep][:, keep]
        b = b[keep]
    return A, b


def find_boundary_nodes(mesh):
    """Node ids on the mesh boundary (P1 or P2 dofs)."""
    bedges = _boundary_edges(mesh.E)
    ids = np.unique(bedges)
    if mesh.degree == 2:
        V2, E2, edges = generate_quadratic(mesh.V, mesh.E,
                                           return_edges=True)
        bset = {tuple(e) for e in np.sort(bedges, axis=1)}
        mid_ids = [mesh.V.shape[0] + k for k, e in enumerate(edges)
                   if tuple(e) in bset]
        ids = np.concatenate([ids, np.asarray(mid_ids, int)])
    return ids


def divform(mesh):
    """Mixed P2-P1 divergence forms (BX, BY) with
    ``(div u, q)``-type coupling (reference ``fem.py:776``)."""
    V2, E2 = mesh.generate_quadratic()
    X = mesh.V[mesh.E]
    J = np.stack([X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]], axis=2)
    detJ = (J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0])
    area = np.abs(detJ) / 2.0
    Jinv = np.empty_like(J)
    Jinv[:, 0, 0] = J[:, 1, 1]
    Jinv[:, 0, 1] = -J[:, 0, 1]
    Jinv[:, 1, 0] = -J[:, 1, 0]
    Jinv[:, 1, 1] = J[:, 0, 0]
    Jinv = Jinv / detJ[:, None, None]

    ne = mesh.ne
    BXe = np.zeros((ne, 3, 6))
    BYe = np.zeros((ne, 3, 6))
    for (l1, l2), w in zip(_QPTS, _QWTS):
        lam1, _ = _p1_basis(l1, l2)
        _, gref2 = _p2_basis(l1, l2)
        g2 = np.einsum("ak,nkj->naj", gref2, Jinv)
        BXe += w * lam1[None, :, None] * g2[:, None, :, 0] * \
            area[:, None, None]
        BYe += w * lam1[None, :, None] * g2[:, None, :, 1] * \
            area[:, None, None]

    rows = np.repeat(mesh.E, 6, axis=1).ravel()
    cols = np.tile(E2, (1, 3)).reshape(ne, 3, 6).reshape(-1)
    BX = sp.coo_matrix((BXe.ravel(), (rows, cols)),
                       shape=(mesh.nv, V2.shape[0])).tocsr()
    BY = sp.coo_matrix((BYe.ravel(), (rows, cols)),
                       shape=(mesh.nv, V2.shape[0])).tocsr()
    return BX, BY


def stokes(mesh, fu, fv):
    """Assemble the Taylor-Hood (P2-P2-P1) Stokes system (reference
    ``fem.py:999``)."""
    mesh2 = Mesh(mesh.V, mesh.E, degree=2)
    A, bu = gradgradform(mesh2, f=fu, degree=2)
    _, bv = gradgradform(mesh2, f=fv, degree=2)
    BX, BY = divform(mesh)
    Z = sp.csr_matrix((mesh.nv, mesh.nv))
    M = sp.block_array([[A, None, BX.T],
                        [None, A, BY.T],
                        [BX, BY, Z]]).tocsr()
    b = np.concatenate([bu, bv, np.zeros(mesh.nv)])
    return M, b
