"""Simple meshes (counterpart of ``pyamg_tpu/gallery/mesh.py``)."""

from __future__ import annotations

import numpy as np


def regular_triangle_mesh(nx, ny):
    """Triangle mesh on a regular (nx, ny) grid of the unit square.

    Each grid cell is split along its anti-diagonal into two triangles,
    both wound counter-clockwise.  Returns ``(vertices (nx*ny, 2) float,
    elements (2*(nx-1)*(ny-1), 3) int)`` with vertices in row-major
    (x-fastest) order — the same mesh the reference produces
    (``mesh.py:7``), constructed here from a meshgrid of cell corners.
    """
    nx, ny = int(nx), int(ny)
    if nx < 2 or ny < 2:
        raise ValueError(f"minimum mesh dimension is 2: {(nx, ny)}")

    xs = np.linspace(0.0, 1.0, nx)
    ys = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(xs, ys)
    vertices = np.column_stack([X.ravel(), Y.ravel()]).astype(float)

    # vertex ids of each cell's corners, cells in row-major order
    ii, jj = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1),
                         indexing="ij")
    sw = (ii * nx + jj).ravel()          # south-west corner
    se = sw + 1
    nw = sw + nx
    ne = nw + 1
    upper = np.column_stack([sw, ne, nw])    # cell's upper-left triangle
    lower = np.column_stack([sw, se, ne])    # cell's lower-right triangle
    elements = np.concatenate([upper, lower]).astype(int)
    return vertices, elements
