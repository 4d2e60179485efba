"""The port's visualization writers (``pyamg_tpu_torch/vis``) against the
JAX package's, on the CPU: each ``.vtu`` file the port writes equals the
JAX package's byte for byte on the same input; ``plotaggs`` draws one
patch or line per aggregate (matplotlib, imported inside the call).
"""


import numpy as np
import pytest
import torch

import pyamg_tpu.vis as ref
from pyamg_tpu.aggregation.aggregate import standard_aggregation as ref_agg
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.strength import symmetric_strength_of_connection as ref_soc

import pyamg_tpu_torch.vis as vis
from pyamg_tpu_torch.aggregation import standard_aggregation
from pyamg_tpu_torch.gallery import poisson, regular_triangle_mesh
from pyamg_tpu_torch.strength import symmetric_strength_of_connection

torch.set_num_threads(1)


def _same_file(tmp_path, write, write_ref, name="out.vtu"):
    a, b = tmp_path / ("port_" + name), tmp_path / ("ref_" + name)
    write(str(a))
    write_ref(str(b))
    assert a.read_bytes() == b.read_bytes()


def _mesh():
    V, E = regular_triangle_mesh(5, 5)
    return V, E


@pytest.mark.parametrize("case", ["plain", "point data", "vector data",
                                  "cell data", "3-D quads"])
def test_write_vtu_is_byte_identical(case, tmp_path):
    V, E = _mesh()
    rng = np.random.default_rng(0)
    kw, cells = {}, {5: E}
    if case == "point data":
        kw = {"pdata": rng.random((V.shape[0], 2))}
    elif case == "vector data":
        kw = {"pvdata": rng.random((V.shape[0], 6))}
    elif case == "cell data":
        kw = {"cdata": {"a": rng.random(E.shape[0])}}
    elif case == "3-D quads":
        V = np.hstack([V, rng.random((V.shape[0], 1))])
        cells = {9: np.array([[0, 1, 6, 5], [1, 2, 7, 6]]), 1: [[3], [4]]}
    _same_file(tmp_path,
               lambda f: vis.write_vtu(V, cells, fname=f, **kw),
               lambda f: ref.write_vtu(V, cells, fname=f, **kw))


@pytest.mark.parametrize("mesh_type", ["tri", "vertex"])
def test_write_basic_mesh_is_byte_identical(mesh_type, tmp_path):
    V, E = _mesh()
    E2V = E if mesh_type == "tri" else None
    pdata = np.arange(V.shape[0], dtype=float)
    _same_file(tmp_path,
               lambda f: vis.write_basic_mesh(V, E2V, mesh_type, pdata=pdata,
                                              fname=f),
               lambda f: ref.write_basic_mesh(V, E2V, mesh_type, pdata=pdata,
                                              fname=f))
    with pytest.raises(ValueError):
        vis.write_basic_mesh(V, E, "no such type")


def _aggregates():
    AggOp, _ = standard_aggregation(symmetric_strength_of_connection(
        poisson((5, 5))))
    RefAggOp, _ = ref_agg(ref_soc(ref_poisson((5, 5))))
    return AggOp, RefAggOp


def test_vis_aggregate_groups_is_byte_identical(tmp_path):
    V, E = _mesh()
    AggOp, RefAggOp = _aggregates()
    _same_file(tmp_path,
               lambda f: vis.vis_aggregate_groups(V, E, AggOp, "tri",
                                                  fname=f),
               lambda f: ref.vis_aggregate_groups(V, E, RefAggOp, "tri",
                                                  fname=f))


def test_vis_splitting_is_byte_identical(tmp_path):
    V, _ = _mesh()
    split = (np.arange(2 * V.shape[0]) % 3 == 0).astype(int)
    got = vis.vis_splitting(V, split, fname=str(tmp_path / "p.vtu"))
    want = ref.vis_splitting(V, split, fname=str(tmp_path / "r.vtu"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read()


def test_plotaggs_draws_every_aggregate():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pyamg_tpu_torch.vis.aggviz import plotaggs
    V, _ = _mesh()
    AggOp, _ = _aggregates()
    fig, ax = plt.subplots()
    plotaggs(AggOp, V, None, ax, aggvals=np.arange(AggOp.shape[1]))
    assert len(ax.patches) + len(ax.lines) == AggOp.shape[1]
    plt.close(fig)
