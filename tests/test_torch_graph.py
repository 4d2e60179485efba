"""The port's graph algorithms (``pyamg_tpu_torch/graph.py`` and
``graph_ref.py``) against the JAX package's, on the CPU.

Strength graphs of 1-D Poisson 30 and 2-D Poisson 16^2 with unit edge
weights and with the strength values as weights (absolute values are
taken inside), and a graph of two components (a 1-D chain beside a 2-D
grid).  Bellman-Ford, balanced Bellman-Ford, BFS, connected components,
Lloyd and balanced Lloyd clustering, k-means++ seeds, graph medians,
most interior nodes, pseudo-peripheral nodes and reverse Cuthill-McKee:
labels, centers and orders equal, distances equal (tolerance 0).  The
naive reference loops of ``graph_ref`` give the distances of
``bellman_ford``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.graph as ref
import pyamg_tpu.graph_ref as ref_gold
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy

import pyamg_tpu_torch.graph as graph
import pyamg_tpu_torch.graph_ref as gold
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
from pyamg_tpu_torch.strength import symmetric_strength_of_connection

torch.set_num_threads(1)

GRAPHS = ["1d unit", "1d values", "2d unit", "2d values", "two components"]


def _graph(name):
    """(scipy matrix of the graph, its node count)."""
    if name == "two components":
        S = sp.block_diag([to_scipy(symmetric_strength_of_connection(
            poisson((12,)))), to_scipy(symmetric_strength_of_connection(
                poisson((6, 6))))]).tocsr()
    else:
        grid = (30,) if name.startswith("1d") else (16, 16)
        S = to_scipy(symmetric_strength_of_connection(poisson(grid)))
        S = S.tocsr()
    S.sort_indices()
    if name.endswith("unit") or name == "two components":
        S.data = np.ones_like(S.data)
    return S


@pytest.fixture(scope="module", params=GRAPHS)
def graphs(request):
    S = _graph(request.param)
    return request.param, from_scipy(S), ref_from_scipy(S)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _centers(n):
    return [0, n // 3, n - 1]


CALLS = {
    "bellman_ford": lambda m, G: m.bellman_ford(G, _centers(G.shape[0])),
    "bellman_ford_balanced": lambda m, G: m.bellman_ford_balanced(
        G, _centers(G.shape[0])),
    "breadth_first_search": lambda m, G: m.breadth_first_search(G, 2),
    "connected_components": lambda m, G: m.connected_components(G),
    "lloyd_cluster": lambda m, G: m.lloyd_cluster(G, 6),
    "lloyd_cluster_centers": lambda m, G: m.lloyd_cluster(
        G, np.asarray(_centers(G.shape[0])), maxiter=3),
    "kmeanspp_seed": lambda m, G: m.kmeanspp_seed(G, 4, seed=3),
    "balanced_lloyd_cluster": lambda m, G: m.balanced_lloyd_cluster(
        G, 5, seed=1),
    "pseudo_peripheral_node": lambda m, G: m.pseudo_peripheral_node(G),
    "symmetric_rcm": lambda m, G: m.symmetric_rcm(G),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_matches_reference(graphs, call):
    _, G, Gr = graphs
    try:
        want = CALLS[call](ref, Gr)
    except ValueError as e:
        # a component without a seed: both packages refuse it
        with pytest.raises(ValueError, match=str(e)):
            CALLS[call](graph, G)
        return
    _same(CALLS[call](graph, G), want)


@pytest.mark.parametrize("fn", ["center_nodes", "most_interior_nodes"])
def test_recentring_matches_reference(graphs, fn):
    """Graph medians and most interior nodes of the JAX package's Lloyd
    clusters (an unreached node's -1 included)."""
    _, G, Gr = graphs
    clusters, _ = ref.lloyd_cluster(Gr, 6, maxiter=1)
    _same(getattr(graph, fn)(G, np.asarray(clusters), 6),
          getattr(ref, fn)(Gr, np.asarray(clusters), 6))


def test_distances_match_the_naive_loops(graphs):
    """``bellman_ford``'s and the balanced form's distances are the
    shortest ones of ``graph_ref``'s loops; ``graph_ref`` equals the JAX
    package's."""
    _, G, Gr = graphs
    centers = _centers(G.shape[0])
    d, m, p = gold.bellman_ford_reference(G, centers)
    _same((d, m, p), ref_gold.bellman_ford_reference(Gr, centers))
    _same(gold.bellman_ford_balanced_reference(G, centers),
          ref_gold.bellman_ford_balanced_reference(Gr, centers))
    np.testing.assert_array_equal(graph.bellman_ford(G, centers)[0], d)
    np.testing.assert_array_equal(
        graph.bellman_ford_balanced(G, centers)[0], d)


def test_distances_are_float64_with_inf_where_unreached():
    G = from_scipy(_graph("two components"))
    dist, nearest = graph.bellman_ford(G, [0])
    assert dist.dtype == np.float64
    assert np.isinf(dist[12:]).all() and (nearest[12:] == -1).all()
    assert np.isfinite(dist[:12]).all() and (nearest[:12] == 0).all()


def test_rebalancing_raises():
    """The JAX package ignores ``rebalance_iters``; the port refuses it."""
    G = from_scipy(_graph("1d unit"))
    with pytest.raises(NotImplementedError):
        graph.balanced_lloyd_cluster(G, 3, rebalance_iters=1)


def test_metis_without_pymetis_is_balanced_lloyd(monkeypatch):
    """Where ``pymetis`` cannot be imported, ``metis_partition`` is
    balanced Lloyd clustering from the same seed, in both packages."""
    import sys
    monkeypatch.setitem(sys.modules, "pymetis", None)
    S = _graph("1d unit")
    G, Gr = from_scipy(S), ref_from_scipy(S)
    got = graph.metis_partition(G, 4, seed=2)
    _same(got, graph.balanced_lloyd_cluster(G, 4, seed=2)[0])
    _same(got, ref.metis_partition(Gr, 4, seed=2))
