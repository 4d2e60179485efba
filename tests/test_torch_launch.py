"""The launch-and-count layer of the hand kernels
(``pyamg_tpu_torch/ops/launch.py``) on the CPU.

* The four wrappers (K1/K2, K3/K5, K6, K7) check their vectors alike: a
  non-tensor or a wrong dtype is a TypeError, a wrong shape, device or a
  strided vector a ValueError.
* A nonzero CUDA code raises with the kernel's name; a library is built
  once and its entry points typed from the table.
* Each wrapper's counters keep the names, keys and values the benchmark
  and ``chip_smoke.py`` read (``dia_spmv.by_op`` and ``dia_gs_sweep.by_op``
  by (rows, diagonals), K2's color passes beside them, the store counters
  ``dist_kernels.launches`` and ``bell_kernels.launches``,
  ``host_transfers``), and a captured loop run on the device (stand-in)
  or step by step counts what the op-by-op loop counts; one
  ``dia_kernels.reset_launch_counts()`` zeroes them all.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu_torch import _graph, _trace
from pyamg_tpu_torch.ops import bell_kernels as bk
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.ops import dist_kernels as tk
from pyamg_tpu_torch.ops import launch
from pyamg_tpu_torch.ops import sell_kernels as sk
from pyamg_tpu_torch.sparse.matrix import bell_from_scipy, from_scipy
from pyamg_tpu_torch.sparse.sell import sell_from_ell

from torch_stand_in import _stand_in_program

torch.set_num_threads(1)


# -- operand checks -------------------------------------------------------------

# the identity of 10 rows in each wrapper's layout

def _dia(x):
    data = torch.zeros((3, 16), dtype=torch.float32)
    data[1] = 1
    return dk.dia_spmv(data, (-1, 0, 1), 10, x)


def _sell(x):
    A = from_scipy(sp.eye(10, format="csr", dtype=np.float32))
    return sk.sell_spmv(sell_from_ell(A).to("cpu"), x)


def _bell(x):
    A = bell_from_scipy(sp.bsr_matrix(np.eye(10, dtype=np.float32),
                                      blocksize=(2, 2))).to("cpu")
    return bk.bell_apply(bk.layout_of(A), x)


def _dist(x):
    idx = torch.arange(10)[:, None]
    L = tk.slice_layouts([(idx, torch.ones((10, 1)), idx >= 0, 10)],
                         torch.Tensor.tolist)[0]
    return tk.dist_slice_apply(L, x)


WRAPPERS = {"dia": _dia, "sell": _sell, "bell": _bell, "dist": _dist}
FAULTS = {"not a tensor": ([0.0] * 10, TypeError),
          "dtype": (torch.zeros(10, dtype=torch.float64), TypeError),
          "shape": (torch.zeros(11), ValueError),
          "device": (torch.zeros(10, device="meta"), ValueError),
          "strided": (torch.zeros(20)[::2], ValueError)}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_the_wrappers_check_a_vector_alike(wrapper, fault):
    x, error = FAULTS[fault]
    with pytest.raises(error):
        WRAPPERS[wrapper](x)
    y = WRAPPERS[wrapper](torch.ones(10))      # the plain version
    assert y.shape == (10,) and torch.equal(y, torch.ones(10))


def test_a_nonzero_code_raises_with_the_kernel_name():
    launch.check_rc(0, "k")
    with pytest.raises(RuntimeError, match="dia_spmv: CUDA error 700"):
        launch.check_rc(700, "dia_spmv")


def test_a_library_is_built_once_and_typed_from_its_table(monkeypatch):
    built = []

    def build(name):
        built.append(name)
        return {"path": None, "seconds": 0.0, "log": ""}   # this process

    monkeypatch.setattr(launch, "build", build)
    monkeypatch.setattr(launch, "_LIBRARIES", {})
    table = {"abs": [ctypes.c_int]}
    lib = launch.library("libc", table)
    assert launch.library("libc", table) is lib and built == ["libc"]
    assert lib.abs.restype is ctypes.c_int and lib.abs(-3) == 3
    assert launch.source("dia_kernels").endswith("csrc/dia_kernels.cu")


# -- counting ---------------------------------------------------------------------

KEYS = {"dia_spmv": (dk.dia_spmv, (250000, 5)),
        "dia_gs_sweep": (dk.dia_gs_sweep, ((250000, 5), 3)),
        "sell_spmv": (sk.sell_spmv, ("tall", 2, 9, 4, (512, 128))),
        "sell_gs_sweep": (sk.sell_gs_sweep, ("square", 1, 9, 4, (512, 512))),
        "dist_slice_apply": (tk.dist_slice_apply, (4096, 130, "jacobi")),
        "bell_apply": (bk.bell_apply, ("gs_color", 100, 100, 25, 2, 2, 9,
                                       4))}


def _counted(kernel):
    c = _trace.snapshot()["counters"]
    return (kernel.launches, dict(kernel.by_op),
            dict(getattr(kernel, "passes", {})),
            c.get(kernel.store, 0) if kernel.store else None,
            c.get("host_transfers", 0))


@pytest.mark.parametrize("form", ["device", "per step"])
@pytest.mark.parametrize("name", KEYS)
def test_a_captured_loop_counts_what_the_eager_loop_counts(name, form):
    """A loop of 5 trips whose step launches ``kernel`` twice under its
    key: op by op, then captured (run twice, the first records), the same
    counters by the same keys, the benchmark's names."""
    kernel, key = KEYS[name]
    zero_i = torch.zeros((), dtype=torch.int32)

    def tree(prog):
        def start(s):
            return {"x": s["x0"] * 1, "it": zero_i.clone(),
                    "stop": zero_i < 0}

        def step(s):
            launch.launched(kernel, key)
            launch.launched(kernel, key)
            it = s["it"] + 1
            return {"x": s["x"] + 1, "it": it, "stop": it >= 5}

        return [_graph.Step(prog, "start", start),
                _graph.While(prog, [_graph.Step(prog, "step", step)], 9)]

    def run(prog, ctx=contextlib.nullcontext):
        prog.put("x0", torch.zeros(3))
        with ctx():
            assert prog.loop("t", tree(prog), ("it",)) == [5]
        _trace.reset()
        dk.reset_launch_counts()
        with ctx():
            assert prog.loop("t", tree(prog), ("it",)) == [5]
        return _counted(kernel)

    want = run(_graph.Program())
    launches, by_op, passes, store, reads = want
    op = key[0] if name == "dia_gs_sweep" else key
    assert launches == 10 and by_op == {op: 10} and reads == 1
    if name in ("dia_spmv", "dia_gs_sweep"):
        assert isinstance(op, tuple) and len(op) == 2     # (rows, diagonals)
    assert passes == ({op: 30} if name == "dia_gs_sweep" else {})
    assert store == {"dist_slice_apply": 10, "bell_apply": 10}.get(name)
    assert kernel.store == {"dist_slice_apply": "dist_kernels.launches",
                            "bell_apply": "bell_kernels.launches"}.get(name)
    ctx = _graph.per_step if form == "per step" else contextlib.nullcontext
    assert run(_stand_in_program(), ctx) == want


def test_one_reset_zeroes_every_wrapper():
    for kernel, key in KEYS.values():
        launch.launched(kernel, key)
    assert all(k.launches for k in launch.KERNELS)
    dk.reset_launch_counts()
    for k in launch.KERNELS:
        assert k.launches == 0 and not k.by_op
    assert not dk.dia_gs_sweep.passes
    assert {k.__name__ for k in launch.KERNELS} == set(KEYS)
