"""XML VTK (.vtu) writers (counterpart of ``pyamg_tpu/vis/vtk_writer.py``;
reference ``pyamg/vis/vtk_writer.py:15,367``).

Emits VTK XML UnstructuredGrid files readable by ParaView.  Implemented
with ``xml.etree`` + ascii data sections.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

# number of points per VTK cell type (reference vtk_writer.py table)
VTK_CELL_NPOINTS = {1: 1, 3: 2, 5: 3, 8: 4, 9: 4, 10: 4, 11: 8, 12: 8,
                    13: 6, 14: 5}
MESH_TYPE_TO_VTK = {"vertex": 1, "line": 3, "tri": 5, "pixel": 8,
                    "quad": 9, "tet": 10, "voxel": 11, "hex": 12,
                    "wedge": 13}


def _a2s(a):
    return " ".join(str(x) for x in np.asarray(a).ravel())


def write_vtu(V, cells, pdata=None, pvdata=None, cdata=None, cvdata=None,
              fname="output.vtu"):
    """Write an unstructured-grid .vtu file (reference
    ``vtk_writer.py:15``).

    ``V``: (Ndof, 2 or 3) coordinates.  ``cells``: dict mapping VTK cell
    type -> (Ncell, npts) connectivity.  Optional point/cell (vector)
    data mirror the reference's signature.
    """
    V = np.asarray(V, dtype=float)
    if V.shape[1] == 2:
        V = np.hstack([V, np.zeros((V.shape[0], 1))])

    conn = []
    offsets = []
    types = []
    off = 0
    cell_order = []
    for key, E in cells.items():
        key = int(key)
        if key not in VTK_CELL_NPOINTS:
            raise NotImplementedError(f"cell type {key} not supported")
        E = np.asarray(E, dtype=np.int64).reshape(-1, VTK_CELL_NPOINTS[key])
        cell_order.append((key, E.shape[0]))
        for row in E:
            conn.extend(row.tolist())
            off += len(row)
            offsets.append(off)
            types.append(key)

    ncells = len(types)
    root = ET.Element("VTKFile", type="UnstructuredGrid", version="0.1",
                      byte_order="LittleEndian")
    grid = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(grid, "Piece", NumberOfPoints=str(V.shape[0]),
                          NumberOfCells=str(ncells))

    pts = ET.SubElement(piece, "Points")
    da = ET.SubElement(pts, "DataArray", type="Float64",
                       NumberOfComponents="3", format="ascii")
    da.text = _a2s(V)

    cel = ET.SubElement(piece, "Cells")
    for name, arr, ncomp in [("connectivity", conn, None),
                             ("offsets", offsets, None),
                             ("types", types, None)]:
        da = ET.SubElement(cel, "DataArray", type="Int32", Name=name,
                           format="ascii")
        da.text = _a2s(arr)

    pd = ET.SubElement(piece, "PointData")
    if pdata is not None:
        pdata = np.asarray(pdata)
        if pdata.ndim == 1:
            pdata = pdata[:, None]
        for k in range(pdata.shape[1]):
            da = ET.SubElement(pd, "DataArray", type="Float64",
                               Name=f"pdata{k}", format="ascii")
            da.text = _a2s(pdata[:, k])
    if pvdata is not None:
        pvdata = np.asarray(pvdata).reshape(V.shape[0], -1)
        nf = pvdata.shape[1] // 3
        for k in range(nf):
            da = ET.SubElement(pd, "DataArray", type="Float64",
                               Name=f"pvdata{k}", NumberOfComponents="3",
                               format="ascii")
            da.text = _a2s(pvdata[:, 3 * k:3 * k + 3])

    cd = ET.SubElement(piece, "CellData")
    if cdata is not None:
        if isinstance(cdata, dict):
            items = cdata.items()
        else:
            items = enumerate(np.atleast_2d(np.asarray(cdata)))
        for name, dat in items:
            da = ET.SubElement(cd, "DataArray", type="Float64",
                               Name=f"cdata{name}", format="ascii")
            da.text = _a2s(dat)

    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(fname, xml_declaration=True)
    return fname


def write_basic_mesh(V, E2V=None, mesh_type="tri", pdata=None, pvdata=None,
                     cdata=None, cvdata=None, fname="output.vtu"):
    """Write a mesh with a single cell type (reference
    ``vtk_writer.py:367``)."""
    V = np.asarray(V)
    if E2V is None:
        mesh_type = "vertex"
        E2V = np.arange(V.shape[0]).reshape(-1, 1)
    if mesh_type not in MESH_TYPE_TO_VTK:
        raise ValueError(f"unknown mesh_type {mesh_type!r}")
    key = MESH_TYPE_TO_VTK[mesh_type]
    return write_vtu(V, {key: np.asarray(E2V)}, pdata=pdata, pvdata=pvdata,
                     cdata=cdata, cvdata=cvdata, fname=fname)
