"""The port's smoothed-aggregation setup against the JAX package's.

Both build the grid-SA hierarchy of 2-D Poisson 96^2 in float32 (the main
path's configuration) from the same operator.  The level count, shapes,
sparsity patterns, DIA offsets and Gauss-Seidel colorings must be equal
exactly; A/P/R values to rtol 1e-6 (float32 setup arithmetic in numpy and
scipy on both sides); the operator complexity to 1e-12.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.relaxation.relaxation import make_coloring as ref_coloring

from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.relaxation.relaxation import make_coloring
from pyamg_tpu_torch.sparse.matrix import ELL

torch.set_num_threads(1)

N = 96


@pytest.fixture(scope="module")
def pair():
    ref = ref_sa(ref_poisson((N, N)).astype(jnp.float32),
                 aggregate=("grid", {}), max_coarse=10)
    port = smoothed_aggregation_solver(poisson((N, N)).astype(np.float32),
                                       aggregate=("grid", {}), max_coarse=10)
    return ref, port


def _same_ell(got, ref):
    assert isinstance(got, ELL) and got.shape == tuple(ref.shape)
    np.testing.assert_array_equal(got.row_nnz, np.asarray(ref.row_nnz))
    mask = got.valid_mask()
    np.testing.assert_array_equal(got.cols[mask], np.asarray(ref.cols)[mask])
    np.testing.assert_allclose(got.vals[mask], np.asarray(ref.vals)[mask],
                               rtol=1e-6, atol=0)
    assert got.vals.dtype == np.asarray(ref.vals).dtype


def test_gallery_matches_reference():
    got, ref = poisson((N, 7)), ref_poisson((N, 7))
    _same_ell(got, ref)
    assert got.grid == ref.grid


def test_levels_and_complexity(pair):
    ref, port = pair
    assert len(port.levels) == len(ref.levels) == 5
    assert [l.A.shape for l in port.levels] == \
        [tuple(l.A.shape) for l in ref.levels]
    assert abs(port.operator_complexity() -
               ref.operator_complexity()) < 1e-12


@pytest.mark.parametrize("attr", ["A", "P", "R"])
def test_operators_match_reference(pair, attr):
    ref, port = pair
    for lp, lr in zip(port.levels, ref.levels):
        if getattr(lr, attr, None) is None:
            continue
        _same_ell(getattr(lp, attr), getattr(lr, attr))
    assert port.levels[0].P.grid == (N, N)
    assert port.levels[0].P.col_grid == (32, 32)


def test_smoothers_and_colors_match_reference(pair):
    ref, port = pair
    for lp, lr in zip(port.levels[:-1], ref.levels[:-1]):
        for (pk, ps, pp), (rk, rs, rp) in ((lp.pre, lr.pre),
                                           (lp.post, lr.post)):
            assert (pk, ps) == (rk, rs)
            np.testing.assert_array_equal(pp["colors"],
                                          np.asarray(rp["colors"]))
            np.testing.assert_allclose(pp["Dinv"], np.asarray(rp["Dinv"]),
                                       rtol=1e-6)
        colors, nc = make_coloring(lp.A)
        rcolors, rnc = ref_coloring(lr.A)
        assert nc == rnc
        np.testing.assert_array_equal(colors, np.asarray(rcolors))


def test_compressed_layouts_match_reference(pair):
    ref, port = pair
    ref.compress_stencils()
    port.compress_stencils()
    for lp, lr in zip(port.levels, ref.levels):
        assert type(lp.A).__name__ == type(lr.A).__name__ == "DIA"
        assert lp.A.offsets == lr.A.offsets
        np.testing.assert_allclose(lp.A.data, np.asarray(lr.A.data),
                                   rtol=1e-6, atol=0)
        for attr in ("P", "R"):
            if getattr(lr, attr, None) is None:
                continue
            gp, gr = getattr(lp, attr), getattr(lr, attr)
            assert type(gp).__name__ == type(gr).__name__
            if type(gr).__name__ == "PhaseStencil":
                assert gp.offsets == gr.offsets and gp.trans == gr.trans
                for a, b in zip(gp.arrays, gr.arrays):
                    np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                               atol=0)


def test_native_build_is_keyed_by_source_and_command(tmp_path, monkeypatch):
    """A library is rebuilt when its source or its compiler command
    changes, and reused while both stay the same."""
    import shutil
    from pyamg_tpu_torch._native import build
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is required to build the port's coloring")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    src = tmp_path / "one.c"
    src.write_text("int one(void) { return 1; }\n")
    cmd = [gxx, "-shared", "-fPIC"]
    first = build.shared_library(str(src), [*cmd, "-O1"], "one")
    again = build.shared_library(str(src), [*cmd, "-O1"], "one")
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    flags = build.shared_library(str(src), [*cmd, "-O2"], "one")
    src.write_text("int one(void) { return 2 - 1; }\n")
    edited = build.shared_library(str(src), [*cmd, "-O1"], "one")
    paths = {first["path"], flags["path"], edited["path"]}
    assert len(paths) == 3 and all(map(os.path.exists, paths))
