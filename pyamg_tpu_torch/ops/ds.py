"""Double-single (two-float) arithmetic (counterpart of ``pyamg_tpu/ops/ds.py``).

A value is the unevaluated sum ``hi + lo`` of two float32 numbers, which
carries ~2^-48 relative accuracy through the error-free transforms below
(Knuth's two-sum, Dekker's split and two-product).  The refined solve
computes its outer residual ``b - A x`` this way, keeping the heavy inner
work in float32, as the reference does.

The transforms are exact only if ``a*b + c`` is never contracted into one
fused multiply-add.  Each line here is a separate eager torch op (a
separate kernel on CUDA), so nothing contracts them: do not wrap these
functions in ``torch.compile`` or fold them into a CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyamg_tpu_torch._device import as_tensor, resolve

_SPLIT = 4097.0     # 2^12 + 1 (f32 has 24 mantissa bits; 24 - 24//2 = 12)


def two_sum(a, b):
    """Exact sum: a + b = s + e with s = fl(a+b) (no ordering needed)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Exact sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi, lo having <= 12 mantissa bits."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact product: a * b = p + e with p = fl(a*b) (FMA-free)."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def ds_add(xhi, xlo, yhi, ylo):
    """(x) + (y) in double-single, normalized."""
    s, e = two_sum(xhi, yhi)
    e = e + (xlo + ylo)
    return quick_two_sum(s, e)


def ds_add_f32(xhi, xlo, y):
    """(x) + y for plain-f32 y."""
    s, e = two_sum(xhi, y)
    e = e + xlo
    return quick_two_sum(s, e)


def ds_neg(xhi, xlo):
    return -xhi, -xlo


def ds_mul_f32(xhi, xlo, c):
    """(x) * c for plain-f32 c."""
    p, e = two_prod(xhi, c)
    e = e + xlo * c
    return quick_two_sum(p, e)


def ds_from_f64(x64):
    """Host: split a f64 array into a (hi, lo) float32 pair."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def ds_to_f64(hi, lo):
    """Host: recombine a (hi, lo) pair (arrays or tensors; a pair of
    tensors comes over in one read) to f64 numpy."""
    if isinstance(hi, torch.Tensor) and isinstance(lo, torch.Tensor):
        hi, lo = torch.stack([hi, lo]).cpu().numpy()
    return np.asarray(hi).astype(np.float64) + \
        np.asarray(lo).astype(np.float64)


def ds_dot_f32(ahi, alo, bhi, blo):
    """Approximate DS dot product (~eps32 relative): enough for norms."""
    return torch.sum(ahi * bhi + (ahi * blo + alo * bhi))


def ds_matvec_dia(data_hi, data_lo, offsets, n, xhi, xlo):
    """Banded (DIA) matvec in double-single: y = A @ x.  Each entry adds
    an exact two_prod of the dominant term plus the first-order cross
    terms, accumulated with DS two_sum."""
    lo_off = max(0, -min(offsets))
    hi_off = max(0, max(offsets))
    xhip = F.pad(xhi, (lo_off, hi_off))
    xlop = F.pad(xlo, (lo_off, hi_off))
    yhi = torch.zeros((n,), dtype=torch.float32, device=xhi.device)
    ylo = torch.zeros_like(yhi)
    for d, off in enumerate(offsets):
        xs_hi = xhip[lo_off + off:lo_off + off + n]
        xs_lo = xlop[lo_off + off:lo_off + off + n]
        a_hi = data_hi[d, :n]
        a_lo = data_lo[d, :n]
        p, e = two_prod(a_hi, xs_hi)
        e = e + (a_hi * xs_lo + a_lo * xs_hi)
        thi, tlo = quick_two_sum(p, e)
        yhi, ylo = ds_add(yhi, ylo, thi, tlo)
    return yhi, ylo


def ds_matvec_ell(cols, vals_hi, vals_lo, xhi, xlo):
    """ELL matvec in double-single (gather form); padding slots are zero
    in both value arrays."""
    xg_hi = xhi[cols]
    xg_lo = xlo[cols]
    yhi = torch.zeros((cols.shape[0],), dtype=torch.float32,
                      device=xhi.device)
    ylo = torch.zeros_like(yhi)
    for k in range(cols.shape[1]):
        p, e = two_prod(vals_hi[:, k], xg_hi[:, k])
        e = e + (vals_hi[:, k] * xg_lo[:, k] + vals_lo[:, k] * xg_hi[:, k])
        thi, tlo = quick_two_sum(p, e)
        yhi, ylo = ds_add(yhi, ylo, thi, tlo)
    return yhi, ylo


def ds_residual(A_ds, xhi, xlo, bhi, blo):
    """r = b - A x in double-single; ``A_ds`` comes from ``ds_operator``."""
    kind = A_ds["kind"]
    if kind == "dia":
        yhi, ylo = ds_matvec_dia(A_ds["data_hi"], A_ds["data_lo"],
                                 A_ds["offsets"], A_ds["n"], xhi, xlo)
    elif kind == "ell":
        yhi, ylo = ds_matvec_ell(A_ds["cols"], A_ds["vals_hi"],
                                 A_ds["vals_lo"], xhi, xlo)
    else:
        raise ValueError(kind)
    return ds_add(bhi, blo, -yhi, -ylo)


def ds_operator(A64, kind=None, device="cuda"):
    """The DS form of a f64 fine operator (host DIA, ELL or BELL), with
    its float32 pairs on ``device``.  Prefers the DIA form when an ELL is
    banded, unless ``kind='ell'``.  A BELL takes the ELL form of its
    scalar rows, every entry of its stored blocks: one outer residual a
    few V-cycles is no place for a block product of its own."""
    from pyamg_tpu_torch.sparse.matrix import (BELL, DIA, ELL, dia_from_ell,
                                               from_scipy, to_scipy)
    device = resolve(device)
    if isinstance(A64, BELL):
        A64, kind = from_scipy(to_scipy(A64).tocsr()), "ell"
    if isinstance(A64, ELL) and kind != "ell":
        D = dia_from_ell(A64)
        if D is not None:
            A64 = D
    if isinstance(A64, DIA):
        hi, lo = ds_from_f64(np.asarray(A64.data, np.float64))
        return {"kind": "dia", "data_hi": as_tensor(hi, device),
                "data_lo": as_tensor(lo, device),
                "offsets": tuple(int(o) for o in A64.offsets),
                "n": A64.shape[0]}
    if isinstance(A64, ELL):
        hi, lo = ds_from_f64(np.asarray(A64.vals, np.float64))
        return {"kind": "ell", "cols": as_tensor(A64.cols, device,
                                                  torch.long),
                "vals_hi": as_tensor(hi, device),
                "vals_lo": as_tensor(lo, device)}
    raise TypeError(f"unsupported operator type {type(A64).__name__}")
