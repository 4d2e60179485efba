"""CUDA kernels K1 (banded SpMV) and K2 (multicolor GS sweep) for DIA
operators, their plain PyTorch versions, and their launch counters.

Counterpart of ``pyamg_tpu/ops/pallas_kernels.py``.

K1 ``dia_spmv`` replaces the TPU kernel ``_dia_call`` (behind
``dia_spmv_pallas``).  It is bound by bytes on the H100: it reads
``ndiag*n`` matrix values plus x and writes y, ~2 flops per value.  The
simple design is one thread per row with coalesced ``data[d, i]`` reads;
neighbouring rows share x reads through L1/L2.

K2 ``dia_gs_sweep`` replaces ``_dia_gs_call``, which ran every color pass
of a sweep in one TPU grid with x resident in VMEM.  Here each pass is
one launch, updating x in place (the source note in
``csrc/dia_kernels.cu`` says why that is safe).  Each pass reads
``ndiag*n`` values plus b, Dinv, colors and x and writes x, so a sweep of
p passes moves about p times the bytes of one K1 call.

The kernels live in ``csrc/dia_kernels.cu``, built with ``nvcc`` for
``sm_90a`` at first use (``_native/build.py``) and called through a plain
C ABI with ctypes.  A wrapper given CUDA tensors launches its kernel or
raises; given CPU tensors it runs the plain version.  Each wrapper's
``launches`` attribute counts the kernels it launched: one per K1 call,
one per color pass of a K2 call.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._native.build import cuda_library

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "dia_kernels.cu")
MAX_DIAGS = 64             # kMaxDiags in the CUDA source

_FLOATS = (torch.float32, torch.float64)


def build() -> dict:
    """Compile ``csrc/dia_kernels.cu`` (unless this source was built with
    these flags already) and return ``{"path", "seconds", "log"}``;
    ``log`` holds the compiler's register/spill report when a build ran."""
    return cuda_library(SOURCE, "dia_kernels")


@functools.cache
def _lib():
    lib = ctypes.CDLL(build()["path"])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        spmv = getattr(lib, f"pyamg_dia_spmv_{suffix}")
        spmv.restype = i32
        spmv.argtypes = [vp, i32, i64, ip, i32, vp, vp, vp]
        gs = getattr(lib, f"pyamg_dia_gs_sweep_{suffix}")
        gs.restype = i32
        gs.argtypes = [vp, i32, i64, ip, i32, vp, vp, vp, ip, i32, real,
                       vp, vp, vp]
    return lib


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def _int_array(values):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _check_vector(name, v, n, dtype, device):
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if v.shape != (n,):
        raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                         f"({n},)")
    if v.dtype != dtype:
        raise TypeError(f"{name} has dtype {v.dtype}, expected {dtype}")
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(data, offsets, n, x):
    """Validate the DIA operands of both kernels (on every device, so the
    CPU tests reach the same checks)."""
    if not isinstance(data, torch.Tensor) or not isinstance(x, torch.Tensor):
        raise TypeError("DIA kernels take torch tensors")
    if data.dtype not in _FLOATS:
        raise TypeError(f"DIA kernels take float32/float64, got {data.dtype}")
    if data.ndim != 2 or data.shape[0] != len(offsets) or \
            data.shape[1] < n:
        raise ValueError(f"data shape {tuple(data.shape)} does not hold "
                         f"{len(offsets)} diagonals of {n} rows")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"{len(offsets)} diagonals; the kernels take 1 to "
                         f"{MAX_DIAGS}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    _check_vector("x", x, n, data.dtype, data.device)
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


# ---------------------------------------------------------------------------
# K1: banded SpMV
# ---------------------------------------------------------------------------

def dia_spmv_plain(data, offsets, n, x):
    """Plain version of K1: a sum of shifted elementwise products."""
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = torch.nn.functional.pad(x, (lo, hi))
    acc = None
    for d, off in enumerate(offsets):
        term = data[d, :n] * xp[lo + off:lo + off + n]
        acc = term if acc is None else acc + term
    return acc


def dia_spmv(data, offsets, n, x):
    """y = A @ x for the DIA operator ``(data, offsets)`` of logical size
    ``n`` (K1 on CUDA tensors, the plain version on CPU tensors)."""
    _check_band(data, offsets, n, x)
    if data.device.type == "cpu":
        return dia_spmv_plain(data, offsets, n, x)
    y = torch.empty_like(x)
    fn = getattr(_lib(), f"pyamg_dia_spmv_{_suffix(data.dtype)}")
    rc = fn(data.data_ptr(), len(offsets), data.shape[1],
            _int_array(offsets), n, x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    _check(rc, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


# ---------------------------------------------------------------------------
# K2: multicolor Gauss-Seidel sweep
# ---------------------------------------------------------------------------

def dia_gs_sweep_plain(data, offsets, n, x, b, Dinv, colors, order, omega):
    """Plain version of K2: the color-pass loop of
    ``relaxation.gauss_seidel`` on a DIA operator."""
    for c in order:
        r = b - dia_spmv_plain(data, offsets, n, x)
        upd = x + omega * Dinv * r
        x = torch.where(colors == c, upd, x)
    return x


def dia_gs_sweep(data, offsets, n, x, b, Dinv, colors, order, omega=1.0):
    """Run the color passes ``order`` of multicolor GS on the DIA operator
    ``(data, offsets)``: for each pass, rows with ``colors == order[p]``
    get ``x += omega * Dinv * (b - A x)`` from the current x.  Returns the
    new x (K2 on CUDA tensors, the plain version on CPU tensors)."""
    _check_band(data, offsets, n, x)
    _check_vector("b", b, n, data.dtype, data.device)
    _check_vector("Dinv", Dinv, n, data.dtype, data.device)
    _check_vector("colors", colors, n, torch.int32, data.device)
    if data.device.type == "cpu":
        return dia_gs_sweep_plain(data, offsets, n, x, b, Dinv, colors,
                                  order, omega)
    out = torch.empty_like(x)
    if len(order) == 0:
        out.copy_(x)
        return out
    fn = getattr(_lib(), f"pyamg_dia_gs_sweep_{_suffix(data.dtype)}")
    rc = fn(data.data_ptr(), len(offsets), data.shape[1],
            _int_array(offsets), n, b.data_ptr(), Dinv.data_ptr(),
            colors.data_ptr(), _int_array(order), len(order), float(omega),
            x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    _check(rc, "dia_gs_sweep")
    dia_gs_sweep.launches += len(order)       # one kernel per color pass
    return out


dia_gs_sweep.launches = 0

KERNELS = (dia_spmv, dia_gs_sweep)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
