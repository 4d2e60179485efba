"""Visualize aggregates and C/F splittings (counterpart of
``pyamg_tpu/vis/vis_coarse.py``; reference
``pyamg/vis/vis_coarse.py:17,142``)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.vis.vtk_writer import write_basic_mesh, write_vtu


def _aggop_labels(AggOp):
    """Aggregate label per node from an AggOp (ELL or scipy)."""
    from pyamg_tpu_torch.sparse.matrix import ELL, to_scipy
    if isinstance(AggOp, ELL):
        A = to_scipy(AggOp).tocsr()
    else:
        A = AggOp.tocsr()
    labels = np.full(A.shape[0], -1, np.int64)
    for i in range(A.shape[0]):
        if A.indptr[i + 1] > A.indptr[i]:
            labels[i] = A.indices[A.indptr[i]]
    return labels


def vis_aggregate_groups(V, E2V, AggOp, mesh_type, fname="output.vtu",
                         output="vtk"):
    """Color the mesh by aggregate membership (reference
    ``vis_coarse.py:17``): writes point data = aggregate id."""
    labels = _aggop_labels(AggOp)
    if output == "vtk":
        return write_basic_mesh(np.asarray(V), np.asarray(E2V),
                                mesh_type=mesh_type,
                                pdata=labels.astype(float), fname=fname)
    if output == "matplotlib":
        import matplotlib.pyplot as plt
        V = np.asarray(V)
        fig, ax = plt.subplots()
        sc = ax.scatter(V[:, 0], V[:, 1], c=labels, cmap="tab20", s=12)
        fig.colorbar(sc, ax=ax)
        return fig
    raise ValueError("output must be 'vtk' or 'matplotlib'")


def vis_splitting(V, splitting, output="vtk", fname="output.vtu"):
    """Visualize a C/F splitting (reference ``vis_coarse.py:142``):
    one file (or scatter color) per dof with C=1/F=0 point data."""
    V = np.asarray(V)
    splitting = np.asarray(splitting).ravel()
    n = V.shape[0]
    nfields = splitting.shape[0] // n
    if output == "vtk":
        names = []
        base = fname.replace(".vtu", "")
        for k in range(nfields):
            data = splitting[k * n:(k + 1) * n].astype(float)
            out = f"{base}.{k}.vtu" if nfields > 1 else fname
            write_basic_mesh(V, mesh_type="vertex", pdata=data, fname=out)
            names.append(out)
        return names
    if output == "matplotlib":
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        s0 = splitting[:n]
        ax.scatter(V[s0 == 0, 0], V[s0 == 0, 1], c="tab:blue", s=10,
                   label="F")
        ax.scatter(V[s0 == 1, 0], V[s0 == 1, 1], c="tab:red", s=18,
                   label="C")
        ax.legend()
        return fig
    raise ValueError("output must be 'vtk' or 'matplotlib'")
