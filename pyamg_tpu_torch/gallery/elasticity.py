"""Linear elasticity model problems (counterpart of
``pyamg_tpu/gallery/elasticity.py``): Q1 elements on a regular grid and P1
elements on a triangle or tetrahedron mesh, plane strain, with their
rigid-body modes.  The element stiffness matrices come from Gauss
quadrature of the elasticity bilinear form.  Host numpy/scipy; the
operator is a host ``BELL`` (or the scipy matrix in ``format``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pyamg_tpu_torch.sparse.matrix import bell_from_scipy


def _q1_local_stiffness(dx, dy, lame, mu):
    """8x8 plane-strain Q1 stiffness on an axis-aligned rectangle via 2x2
    Gauss quadrature.  DOF order: (x0,y0, x1,y1, x2,y2, x3,y3) for vertices
    [0]=(0,0), [1]=(dx,0), [2]=(dx,dy), [3]=(0,dy) (counter-clockwise)."""
    D = np.array([[lame + 2 * mu, lame, 0],
                  [lame, lame + 2 * mu, 0],
                  [0, 0, mu]])
    g = 1.0 / np.sqrt(3.0)
    K = np.zeros((8, 8))
    # bilinear shape functions on [-1,1]^2, vertex order CCW
    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    for xi in (-g, g):
        for eta in (-g, g):
            dN = np.array([[0.25 * cx * (1 + cy * eta),
                            0.25 * cy * (1 + cx * xi)]
                           for (cx, cy) in corners])       # (4, 2) d/dxi
            J = np.diag([dx / 2.0, dy / 2.0])
            dNx = dN @ np.linalg.inv(J)                    # (4, 2) d/dx
            B = np.zeros((3, 8))
            B[0, 0::2] = dNx[:, 0]
            B[1, 1::2] = dNx[:, 1]
            B[2, 0::2] = dNx[:, 1]
            B[2, 1::2] = dNx[:, 0]
            K += B.T @ D @ B * np.linalg.det(J)
    return K


def linear_elasticity(grid, spacing=None, E=1e5, nu=0.3, format=None):
    """Q1 linear elasticity on a regular ``grid`` of interior nodes with a
    Dirichlet boundary.  Returns ``(A, B)``: the operator with 2 x 2 blocks
    (a host BELL, or scipy in ``format``) and its three rigid-body modes.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import linear_elasticity
    >>> A, B = linear_elasticity((4, 4))
    >>> A.shape, A.blocksize, B.shape
    ((32, 32), (2, 2), (32, 3))
    """
    if len(grid) != 2:
        raise NotImplementedError(f"No support for grid={grid}")
    X, Y = tuple(int(g) for g in grid)
    if X < 1 or Y < 1:
        raise ValueError("invalid grid shape")
    # interior grid is (X, Y); assemble on (X+1, Y+1) elements then
    # restrict to interior nodes (PyAMG's q12d with dirichlet_boundary=True)
    X += 1
    Y += 1

    pts = np.mgrid[0:X + 1, 0:Y + 1]
    pts = np.hstack((pts[0].T.reshape(-1, 1) - X / 2.0,
                     pts[1].T.reshape(-1, 1) - Y / 2.0))
    if spacing is None:
        DX, DY = 1.0, 1.0
    else:
        DX, DY = tuple(spacing)
        pts = pts * [DX, DY]

    lame = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 + 2 * nu)
    K = _q1_local_stiffness(DX, DY, lame, mu)

    # global assembly: elements are grid cells; node (i, j) -> i*(Y+1)+j
    nodes = np.arange((X + 1) * (Y + 1)).reshape(X + 1, Y + 1)
    ll = nodes[:-1, :-1].ravel()                       # lower-left per elem
    # vertex order CCW: ll, ll+ (Y+1) (x+1), x+1 y+1, y+1
    v0 = ll
    v1 = ll + (Y + 1)
    v2 = ll + (Y + 1) + 1
    v3 = ll + 1
    # as in PyAMG's q12d, rows of `nodes` advance x
    edofs = np.stack([2 * v0, 2 * v0 + 1, 2 * v1, 2 * v1 + 1,
                      2 * v2, 2 * v2 + 1, 2 * v3, 2 * v3 + 1], axis=1)
    ne = edofs.shape[0]
    # entry (a, b) of K goes to (edof[a], edof[b]); K.ravel() is b-fastest
    rows = np.repeat(edofs, 8, axis=1).ravel()
    cols = np.tile(edofs, (1, 8)).ravel()
    vals = np.tile(K.ravel(), ne)
    nd = 2 * (X + 1) * (Y + 1)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(nd, nd)).tocsr()

    # rigid body modes on all nodes
    B = np.zeros((nd, 3))
    B[0::2, 0] = 1
    B[1::2, 1] = 1
    B[0::2, 2] = -pts[:, 1]
    B[1::2, 2] = pts[:, 0]

    # restrict to interior nodes (Dirichlet boundary)
    mask = np.zeros((X + 1, Y + 1), dtype=bool)
    mask[1:-1, 1:-1] = True
    keep_nodes = np.where(mask.ravel())[0]
    keep = np.stack([2 * keep_nodes, 2 * keep_nodes + 1], axis=1).ravel()
    A = A[keep, :][:, keep].tobsr(blocksize=(2, 2))
    B = B[keep]

    if format is not None:
        return A.asformat(format), B
    return bell_from_scipy(A), B


def linear_elasticity_p1(vertices, elements, E=1e5, nu=0.3, format=None):
    """P1 linear elasticity on a triangle (2-D) or tetrahedron (3-D) mesh.
    Returns ``(A, B)``: the operator with dim x dim blocks and its rigid-body
    modes (3 in 2-D, 6 in 3-D)."""
    vertices = np.asarray(vertices, float)
    elements = np.asarray(elements, int)
    dim = vertices.shape[1]
    if dim not in (2, 3):
        raise ValueError("only 2d and 3d supported")
    if elements.shape[1] != dim + 1:
        raise ValueError("simplex elements required")

    lame = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 + 2 * nu)

    nv = vertices.shape[0]
    nd = dim * nv
    rows, cols, vals = [], [], []
    if dim == 2:
        Dmat = np.array([[lame + 2 * mu, lame, 0],
                         [lame, lame + 2 * mu, 0],
                         [0, 0, mu]])
        nstrain = 3
    else:
        Dmat = lame * np.ones((6, 6)) * 0
        Dmat[:3, :3] = lame
        Dmat[np.arange(3), np.arange(3)] += 2 * mu
        Dmat[3:, 3:] = mu * np.eye(3)
        nstrain = 6

    for el in elements:
        X = vertices[el]                               # (dim+1, dim)
        G = np.hstack([np.ones((dim + 1, 1)), X])      # affine map
        grads = np.linalg.inv(G)[1:, :]                # (dim, dim+1) dN/dx
        vol = abs(np.linalg.det(G)) / (2 if dim == 2 else 6)
        B = np.zeros((nstrain, dim * (dim + 1)))
        for a in range(dim + 1):
            gx = grads[:, a]
            if dim == 2:
                B[0, 2 * a] = gx[0]
                B[1, 2 * a + 1] = gx[1]
                B[2, 2 * a] = gx[1]
                B[2, 2 * a + 1] = gx[0]
            else:
                B[0, 3 * a] = gx[0]
                B[1, 3 * a + 1] = gx[1]
                B[2, 3 * a + 2] = gx[2]
                B[3, 3 * a] = gx[1]
                B[3, 3 * a + 1] = gx[0]
                B[4, 3 * a + 1] = gx[2]
                B[4, 3 * a + 2] = gx[1]
                B[5, 3 * a] = gx[2]
                B[5, 3 * a + 2] = gx[0]
        Ke = B.T @ Dmat @ B * vol
        edof = np.array([dim * v + k for v in el for k in range(dim)])
        rows.append(np.repeat(edof, len(edof)))
        cols.append(np.tile(edof, len(edof)))
        vals.append(Ke.ravel())

    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(nd, nd)).tocsr()
    A = A.tobsr(blocksize=(dim, dim))

    # rigid body modes: translations + rotations
    nrbm = 3 if dim == 2 else 6
    B = np.zeros((nd, nrbm))
    for k in range(dim):
        B[k::dim, k] = 1
    if dim == 2:
        B[0::2, 2] = -vertices[:, 1]
        B[1::2, 2] = vertices[:, 0]
    else:
        B[0::3, 3] = -vertices[:, 1]
        B[1::3, 3] = vertices[:, 0]
        B[1::3, 4] = -vertices[:, 2]
        B[2::3, 4] = vertices[:, 1]
        B[0::3, 5] = vertices[:, 2]
        B[2::3, 5] = -vertices[:, 0]

    if format is not None:
        return A.asformat(format), B
    return bell_from_scipy(A), B
