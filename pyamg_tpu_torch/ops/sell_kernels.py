"""CUDA kernels K3/K4 (SELL SpMV) and K5 (hybrid Gauss-Seidel sweep on a
square SELL), their plain PyTorch versions, and their launch counters.

Counterpart of ``pyamg_tpu/ops/sell_kernels.py``.

``sell_spmv`` replaces both TPU SpMV kernels, ``_spmv_call`` (K3, x
resident in VMEM) and ``_spmv_tiled_call`` (K4, x streamed in row tiles
past the 6 MB VMEM budget): on the H100 one kernel reads x from device
memory at any size.  ``sell_gs_sweep`` replaces ``_gs_call``: 1024-row
tiles in order (reversed for ``backward``, forward then backward for
``symmetric``), Gauss-Seidel across tiles and Jacobi within one.  Both
are bound by bytes; ``csrc/sell_kernels.cu`` says how they are built.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use
(``_native/build.py``) and called through a plain C ABI with ctypes.  A
wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version.  ``sell_spmv.launches`` counts one per
product, ``sell_gs_sweep.launches`` one per directional sweep.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._native.build import cuda_library
from ..sparse.sell import LANE, SELL

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "sell_kernels.cu")
GS_TILE = 8 * LANE          # rows per Gauss-Seidel tile (kGsTile)
_SWEEPS = {"forward": (0,), "backward": (1,), "symmetric": (0, 1)}


def build() -> dict:
    """Compile ``csrc/sell_kernels.cu`` (unless this source was built with
    these flags already) and return ``{"path", "seconds", "log"}``."""
    return cuda_library(SOURCE, "sell_kernels")


@functools.cache
def _lib():
    lib = ctypes.CDLL(build()["path"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pyamg_sell_spmv_f32.restype = i32
    lib.pyamg_sell_spmv_f32.argtypes = [vp, vp, vp, i32, i64, i32, i32, i32,
                                        i32, vp, vp, vp]
    lib.pyamg_sell_gs_sweep_f32.restype = i32
    lib.pyamg_sell_gs_sweep_f32.argtypes = [vp, vp, vp, i32, i64, i32, vp, vp,
                                            ctypes.c_float, i32, vp, vp]
    return lib


def _check_vector(name, v, n, device):
    if not isinstance(v, torch.Tensor) or v.shape != (n,):
        raise ValueError(f"{name} must be a tensor of shape ({n},)")
    if v.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {v.dtype}; SELL is float32 only")
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(A, x):
    """Validate the operands of both kernels (on every device, so the CPU
    tests reach the same checks)."""
    if not isinstance(A, SELL) or A.bases_t is None:
        raise TypeError("the SELL kernels take a SELL placed with .to()")
    if A.vals.dtype != torch.float32 or A.delta.dtype != torch.int32:
        raise TypeError("a SELL plan is float32 values and int32 deltas")
    if A.vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.vals.device}")
    _check_vector("x", x, A.shape[1], A.vals.device)


def _launch_check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _gather(A, x, lo=0, hi=None):
    """(values, x at the column of every slot) of rows [lo, hi): two
    (T, hi - lo) tensors; a column outside [0, m) reads 0."""
    T, Sy, _ = A.vals.shape
    hi = A.shape[0] if hi is None else hi
    dev = A.vals.device
    sigma = torch.arange(lo, hi, device=dev) // LANE
    anchor = sigma // A.t if A.kind == "tall" else sigma * A.t
    bases = A.bases_t.long()
    delta = A.delta.reshape(T, Sy * LANE)[:, lo:hi]
    cols = LANE * (anchor[None, :] + bases[:, None]) + delta
    m = A.shape[1]
    ok = (cols >= 0) & (cols < m)
    xg = torch.where(ok, x[cols.clamp(0, m - 1)], 0.0)
    return A.vals.reshape(T, Sy * LANE)[:, lo:hi], xg


# ---------------------------------------------------------------------------
# K3/K4: SELL SpMV
# ---------------------------------------------------------------------------

def sell_spmv_plain(A, x):
    """Plain version of K3/K4: gather every slot's x, then sum the passes'
    products in pass order."""
    vals, xg = _gather(A, x)
    y = vals[0] * xg[0]
    for p in range(1, vals.shape[0]):
        y = y + vals[p] * xg[p]
    return y


def sell_spmv(A, x):
    """y = A @ x for a SELL operator placed on x's device (K3/K4 on CUDA
    tensors, the plain version on CPU tensors)."""
    _check_plan(A, x)
    if x.device.type == "cpu":
        return sell_spmv_plain(A, x)
    n, m = A.shape
    T, Sy, _ = A.vals.shape
    y = torch.empty((n,), dtype=torch.float32, device=x.device)
    rc = _lib().pyamg_sell_spmv_f32(
        A.vals.data_ptr(), A.delta.data_ptr(), A.bases_t.data_ptr(), T,
        Sy * LANE, n, m, A.t, int(A.kind == "fat"), x.data_ptr(),
        y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "sell_spmv")
    sell_spmv.launches += 1
    return y


sell_spmv.launches = 0


# ---------------------------------------------------------------------------
# K5: hybrid Gauss-Seidel sweep
# ---------------------------------------------------------------------------

def sell_gs_sweep_plain(A, x, b, Dinv, omega=1.0, sweep="forward"):
    """Plain version of K5: the tiles in sweep order, each updated from
    the x at tile entry, the residual taken pass by pass."""
    n = A.shape[0]
    ntiles = -(-n // GS_TILE)
    x = x.clone()
    for reverse in _SWEEPS[sweep]:
        for k in range(ntiles):
            tile = ntiles - 1 - k if reverse else k
            lo, hi = tile * GS_TILE, min((tile + 1) * GS_TILE, n)
            vals, xg = _gather(A, x, lo, hi)
            r = b[lo:hi]
            for p in range(vals.shape[0]):
                r = r - vals[p] * xg[p]
            x[lo:hi] = x[lo:hi] + omega * Dinv[lo:hi] * r
    return x


def sell_gs_sweep(A, x, b, Dinv, omega=1.0, sweep="forward"):
    """One ``sweep`` ('forward', 'backward' or 'symmetric') of hybrid
    Gauss-Seidel on a square SELL placed on x's device; returns the new x
    (K5 on CUDA tensors, the plain version on CPU tensors)."""
    if not A.square:
        raise ValueError("Gauss-Seidel needs a square SELL")
    if sweep not in _SWEEPS:
        raise ValueError(f"unknown sweep {sweep!r}")
    _check_plan(A, x)
    _check_vector("b", b, A.shape[0], x.device)
    _check_vector("Dinv", Dinv, A.shape[0], x.device)
    if x.device.type == "cpu":
        return sell_gs_sweep_plain(A, x, b, Dinv, omega, sweep)
    T, Sy, _ = A.vals.shape
    out = x.clone()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for reverse in _SWEEPS[sweep]:
        rc = _lib().pyamg_sell_gs_sweep_f32(
            A.vals.data_ptr(), A.delta.data_ptr(), A.bases_t.data_ptr(), T,
            Sy * LANE, A.shape[0], b.data_ptr(), Dinv.data_ptr(),
            float(omega), reverse, out.data_ptr(), stream)
        _launch_check(rc, "sell_gs_sweep")
        sell_gs_sweep.launches += 1       # one kernel per direction
    return out


sell_gs_sweep.launches = 0

KERNELS = (sell_spmv, sell_gs_sweep)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
