"""pyamg_tpu_torch stands alone: no JAX, no module of the JAX package, and
the card as every entry point's default device."""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyamg_tpu_torch
from pyamg_tpu_torch import _device, blackbox, convert, multilevel
from pyamg_tpu_torch.gallery import demo as gallery_demo
from pyamg_tpu_torch.ops import dense, ds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pyamg_tpu_torch")


def _forbidden(name):
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "pyamg_tpu" or name.startswith("pyamg_tpu."))


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the probes run on the card beside chip_smoke.py
    probes = os.path.join(ROOT, "probes")
    for f in os.listdir(probes):
        if f.endswith(".py"):
            yield os.path.join(probes, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_no_jax_and_no_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, Block())
import pyamg_tpu_torch
for m in pkgutil.walk_packages(pyamg_tpu_torch.__path__, "pyamg_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyamg_tpu"))
print("loaded", len([m for m in sys.modules if m.startswith("pyamg_tpu_torch")]))
assert not bad, bad
"""


NEW_MODULES = ["aggregation.adaptive", "aggregation.energy",
               "aggregation.pairwise", "aggregation.rootnode", "blackbox",
               "graph", "graph_ref", "io", "util.params", "util.utils",
               "util.linalg", "gallery.fem", "gallery.mesh",
               "gallery.random_sparse", "gallery.demo", "gallery.example",
               "vis.vtk_writer", "vis.vis_coarse", "vis.aggviz",
               "parallel.partition", "parallel.halo", "_tools._tester"]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_walk_covers_the_family_modules(name):
    """The blocked import below walks the family modules, the blackbox,
    the graph, checkpoint, utility, gallery, vis, parallel and tester
    modules with the rest, and their sources are read above."""
    walked = {m.name for m in pkgutil.walk_packages(
        pyamg_tpu_torch.__path__, "pyamg_tpu_torch.")}
    assert f"pyamg_tpu_torch.{name}" in walked
    assert os.path.join(PKG, *name.split(".")) + ".py" in set(_sources())


def test_package_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= len(list(pkgutil.walk_packages(pyamg_tpu_torch.__path__)))


@pytest.mark.parametrize("fn", [
    _device.resolve, dense.to_dense, dense.inv_device_checked,
    ds.ds_operator, convert.hierarchy_from_arrays,
    multilevel.MultilevelSolver.collapse_coarse,
    multilevel.MultilevelSolver.enable_ds_refinement,
    multilevel.MultilevelSolver.to_device, blackbox.solve, gallery_demo,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


SOLVES = ["solve_refined_device", "solve_refined", "solve"]


@pytest.mark.parametrize("method", SOLVES)
def test_unplaced_solves_go_to_the_card(method, monkeypatch):
    """A solve entry point called on a hierarchy not yet placed places it
    with ``to_device``'s default, the card."""
    from pyamg_tpu_torch.gallery import poisson
    A = poisson((6, 6, 6))
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(A.astype(np.float32),
                                                     max_coarse=10)
    placed = []
    sig = inspect.signature(multilevel.MultilevelSolver.to_device)

    def to_device(self, *args, **kwargs):
        placed.append(sig.bind(self, *args, **kwargs))
        raise RuntimeError("stop after placement")

    monkeypatch.setattr(multilevel.MultilevelSolver, "to_device", to_device)
    with pytest.raises(RuntimeError, match="stop after placement"):
        getattr(ml.compress_stencils(), method)(np.ones(A.shape[0]))
    bound = placed[0]
    bound.apply_defaults()
    assert bound.arguments["device"] == "cuda"


@pytest.mark.parametrize("method", SOLVES)
def test_no_silent_cpu_fallback(method):
    """Without a card, the default device raises instead of running on
    the CPU; an unplaced hierarchy does not solve on the CPU by itself,
    through any solve entry point."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        _device.resolve()
    from pyamg_tpu_torch.gallery import poisson
    A = poisson((12, 12))
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A.astype(np.float32), aggregate=("grid", {}), max_coarse=10)
    with pytest.raises(RuntimeError):
        getattr(ml.compress_stencils(), method)(np.ones(A.shape[0]))


def test_sell_kernels_raise_on_the_card_without_nvcc(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no toolkit the
    build raises, and nothing falls back to the plain version."""
    from pyamg_tpu_torch._native import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.cuda_library("kernels.cu", "kernels")
