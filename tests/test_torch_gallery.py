"""The port's model problems (``gallery/mesh.py``, ``fem.py``,
``random_sparse.py``, ``laplacian.gauge_laplacian``, ``demo.py``,
``example.py``) against the JAX package's, on the CPU.

Meshes, P1 and P2 stiffness and load, boundary conditions, divergence
forms, the Stokes system, L2 norms, refinement and P2 nodes, random
sparse matrices and the gauge Laplacian from a seed: arrays equal
(tolerance 0; the assembly is the same numpy in both).  ``demo`` runs on
the CPU; ``load_example`` of an absent dataset raises.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.gallery as ref
import pyamg_tpu.gallery.fem as ref_fem
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy

import pyamg_tpu_torch.gallery as gallery
import pyamg_tpu_torch.gallery.fem as fem
from pyamg_tpu_torch.sparse.matrix import to_scipy

torch.set_num_threads(1)


def _equal(got, want):
    if sp.issparse(want):
        assert sp.issparse(got) and got.shape == want.shape
        g, w = got.tocsr(), want.tocsr()
        g.sort_indices()
        w.sort_indices()
        np.testing.assert_array_equal(g.indptr, w.indptr)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.data, w.data)
    elif isinstance(want, tuple):
        for a, b in zip(got, want):
            _equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 2), (4, 3), (6, 7)])
def test_regular_triangle_mesh(shape):
    _equal(gallery.regular_triangle_mesh(*shape),
           ref.regular_triangle_mesh(*shape))
    with pytest.raises(ValueError):
        gallery.regular_triangle_mesh(1, 4)


def _mesh(module, degree):
    V, E = module.regular_triangle_mesh(5, 4) if module is gallery else \
        ref.regular_triangle_mesh(5, 4)
    fem_ = fem if module is gallery else ref_fem
    return fem_.Mesh(V, E, degree=degree)


def kappa(x, y):
    return 1.0 + x * y


def load(x, y):
    return np.sin(x) + y


@pytest.mark.parametrize("degree", [1, 2])
def test_gradgradform_and_applybc(degree):
    m, mr = _mesh(gallery, degree), _mesh(ref, degree)
    A, b = fem.gradgradform(m, kappa=kappa, f=load)
    Ar, br = ref_fem.gradgradform(mr, kappa=kappa, f=load)
    _equal((A, b), (Ar, br))
    ids = fem.find_boundary_nodes(m)
    np.testing.assert_array_equal(ids, ref_fem.find_boundary_nodes(mr))
    for remove in (False, True):
        bc = [{"id": ids, "g": lambda x, y: x + 2 * y}]
        _equal(fem.applybc(A, b, m, bc, remove_dirichlet=remove),
               ref_fem.applybc(Ar, br, mr, bc, remove_dirichlet=remove))
    u = np.random.default_rng(degree).random(b.shape[0])
    assert fem.l2norm(u, m) == ref_fem.l2norm(u, mr)


def test_divform_and_stokes():
    m, mr = _mesh(gallery, 1), _mesh(ref, 1)
    _equal(fem.divform(m), ref_fem.divform(mr))
    _equal(fem.stokes(m, load, kappa), ref_fem.stokes(mr, load, kappa))


def test_refinement_quadratic_nodes_and_smoothing():
    V, E = gallery.regular_triangle_mesh(4, 4)
    _equal(fem.refine2dtri(V, E), ref_fem.refine2dtri(V, E))
    _equal(fem.generate_quadratic(V, E, return_edges=True),
           ref_fem.generate_quadratic(V, E, return_edges=True))
    assert fem.diameter(V, E) == ref_fem.diameter(V, E)
    m, mr = fem.Mesh(V, E).refine(2), ref_fem.Mesh(V, E).refine(2)
    _equal((m.V, m.E), (mr.V, mr.E))
    m.smooth(maxit=3)
    mr.smooth(maxit=3)
    _equal(m.V, mr.V)
    with pytest.raises(ValueError):
        fem.check_mesh(V, E + V.shape[0])


@pytest.mark.parametrize("seed", [0, 7])
def test_sprand(seed):
    got = gallery.sprand(30, 20, 0.1, seed=seed)
    want = ref.sprand(30, 20, 0.1, seed=seed)
    _equal(to_scipy(got), ref_to_scipy(want))
    _equal(gallery.sprand(30, 20, 0.1, format="csc", seed=seed),
           ref.sprand(30, 20, 0.1, format="csc", seed=seed))


@pytest.mark.parametrize("seed", [0, 5])
def test_gauge_laplacian(seed):
    got = gallery.gauge_laplacian(5, spacing=0.5, beta=0.2, seed=seed)
    want = ref.gauge_laplacian(5, spacing=0.5, beta=0.2, seed=seed)
    assert np.iscomplexobj(got.vals)
    _equal(to_scipy(got), ref_to_scipy(want))
    S = to_scipy(got)
    assert abs(S - S.conj().T).max() == 0


def test_demo_runs_on_the_cpu(capsys):
    x = gallery.demo(device="cpu")
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    out = capsys.readouterr().out
    assert "SA-CG" in out and "standalone" in out


def test_load_example_of_an_absent_dataset_raises():
    with pytest.raises(ValueError, match="no example matrix"):
        gallery.load_example("no_such_example")


def test_exports_match_the_reference():
    assert sorted(gallery.__all__) == sorted(ref.__all__)
