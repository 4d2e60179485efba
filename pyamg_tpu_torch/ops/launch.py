"""How the hand kernels K1-K7 are built, launched and counted: the one
layer between the kernel wrappers (``ops/{dia,sell,bell,dist}_kernels.py``)
and their CUDA sources (``csrc/*.cu``); ``_graph`` builds and binds its
conditional nodes (``csrc/graph_cond.cu``) through it too.

A source ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` at
first use (``_native/build.py``) and called through a plain C ABI with
ctypes: ``library(name, entry_points)`` builds it and types the entry
points from a table of argtypes (every entry point returns an int, a CUDA
error code).  A wrapper checks its operands (``check_vector``), launches
on the current stream (``stream``) and raises on a nonzero code
(``check_rc``).

Counting.  A wrapper made ``countable`` has ``launches`` (all its
launches) and ``by_op`` (a Counter by the key each launch is counted
under), and may add to a store counter (``store``) that the benchmark
reads.  ``launched(kernel, key)`` counts one launch through
``_graph.tally``: now, or, while a graph records, once for every run of
the graph (a device loop adds its counts times the trips it made).
``count`` is the one kind every wrapper's launches are tallied by, and
``reset_launch_counts`` zeroes every wrapper's counters.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import torch

from .. import _graph, _trace
from .._native.build import cuda_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

# the H100 SXM (data sheet): SMs, and the dynamic shared memory one block
# may use (kMaxSmem); a launch passes the card's own SM count
SM_COUNT = 132
MAX_SMEM = 232_448

_LIBRARIES = {}
KERNELS = []                # every countable wrapper, as it was imported


def source(name) -> str:
    """The path of ``csrc/<name>.cu``."""
    return os.path.join(CSRC, f"{name}.cu")


def build(name) -> dict:
    """Compile ``csrc/<name>.cu`` (unless this source was built with these
    flags already) and return ``{"path", "seconds", "log"}``; ``log``
    holds the compiler's register/spill report when a build ran."""
    return cuda_library(source(name), name)


def bind(path, entry_points):
    """The shared library at ``path``, its entry points ``{name:
    argtypes}`` typed for ctypes, each returning an int."""
    lib = ctypes.CDLL(path)
    for fn, args in entry_points.items():
        f = getattr(lib, fn)
        f.restype, f.argtypes = ctypes.c_int, args
    return lib


def library(name, entry_points):
    """``csrc/<name>.cu`` built and bound (``bind``) at first use."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = _LIBRARIES[name] = bind(build(name)["path"], entry_points)
    return lib


@functools.cache
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device):
    """The current stream of ``device``, as a kernel launch takes it."""
    return torch.cuda.current_stream(device).cuda_stream


def suffix(dtype) -> str:
    """The suffix of an entry point for float32 or float64 values."""
    return "f32" if dtype == torch.float32 else "f64"


def ptr(t):
    """A tensor's address for a launch, None for None."""
    return None if t is None else t.data_ptr()


def check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def check_vector(name, v, shape, dtype, device):
    """A kernel operand ``name``: a contiguous tensor of ``shape``,
    ``dtype`` and ``device``, else TypeError (type, dtype) or ValueError."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                         f"{tuple(shape)}")
    if v.dtype != dtype:
        raise TypeError(f"{name} has dtype {v.dtype}, expected {dtype}")
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- counting -----------------------------------------------------------------

def countable(kernel, store=None, passes=False):
    """Give the wrapper ``kernel`` its counters and return it: ``launches``,
    ``by_op``, ``store`` (the store counter its launches also add to, or
    None) and, with ``passes``, ``passes``: a Counter of the color passes
    by the same keys (K2: a launch is counted under (its key, the passes
    it ran)).  ``kernel.count`` is its kind for ``_graph.tally``."""
    kernel.launches = 0
    kernel.by_op = collections.Counter()
    kernel.store = store
    if passes:
        kernel.passes = collections.Counter()
    kernel.count = functools.partial(count, kernel)
    KERNELS.append(kernel)
    return kernel


def count(kernel, counts):
    """Add ``{key: launches}`` to ``kernel``'s counters and its store
    counter (a kernel with ``passes``: each key is (its key, the passes a
    launch ran))."""
    n = 0
    passes = getattr(kernel, "passes", None)
    for key, k in counts.items():
        if passes is not None:
            key, p = key
            passes[key] += p * k
        kernel.by_op[key] += k
        n += k
    kernel.launches += n
    if kernel.store is not None:
        _trace.count(kernel.store, n)


def launched(kernel, key):
    """Count one launch of ``kernel`` under ``key`` (``_graph.tally``)."""
    _graph.tally(kernel.count, key)


def tally(kind, key):
    """Count block work (a block product, a color pass) under ``key``
    through ``kind({key: 1})``, as ``launched`` counts a launch: K7 and
    the torch block paths count theirs so."""
    _graph.tally(kind, key)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        k.by_op.clear()
        if hasattr(k, "passes"):
            k.passes.clear()
