#!/usr/bin/env python3
"""Time the two gather forms of the device SpGEMM's candidate expansion
(``pyamg_tpu_torch/ops/spgemm.py``) on one CUDA card.

    python3 probes/spgemm_forms.py [--reps 50]

- ``2-D``: the port's ``_expand``, one 2-D gather ``B.cols[A.cols]``
  reshaped to ``(n, WA * WB)``;
- ``per slot``: the JAX package's form (``pyamg_tpu/ops/spgemm.py:40-61``),
  WA one-dimensional row gathers, one for each of A's slots,
  concatenated; it exists there for XLA's sake.

Both give the same candidates in the same order (checked here: equal
bit for bit, block values within 1e-6 of the largest, since an einsum
may round otherwise in another batching).  On float32 operands as
``chip_smoke.py``'s ``spgemm:`` phase builds them (500^2 grid-SA A0 @
P0, 64^3 SA A0 @ P0 and R0 @ (A0 @ P0); elasticity 100^2 A0 @ P0 in
BELL, block products by einsum), each form is timed alone and followed
by ``rowops.dedup_rows``: the median of ``reps`` warm calls, each between
two CUDA events, in the order per slot, 2-D, 2-D, per slot, so that the
spread between two timings of one form shows beside the difference
between the forms.
"""

import argparse
import importlib
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_slot(A, B, block=False):
    """The JAX package's candidate expansion: one row gather for each of
    A's WA slots, concatenated slot-major."""
    import torch
    a_ok = torch.arange(A.width, device=A.cols.device) < A.row_nnz[:, None]
    kB = torch.arange(B.width, device=A.cols.device)[None, :]
    cols, vals, ok = [], [], []
    for j in range(A.width):
        idx = A.cols[:, j]
        cols.append(B.cols[idx])
        if block:
            vals.append(torch.einsum("nij,nwjk->nwik", A.vals[:, j],
                                     B.vals[idx]))
        else:
            vals.append(A.vals[:, j:j + 1] * B.vals[idx])
        ok.append(a_ok[:, j:j + 1] & (kB < B.row_nnz[idx][:, None]))
    return torch.cat(cols, 1), torch.cat(vals, 1), torch.cat(ok, 1)


def two_d(sg, A, B, block=False):
    """The port's expansion (``_expand``; for blocks its BELL form)."""
    import torch
    if not block:
        return sg._expand(A, B)
    nb = A.n_block_rows
    cols, ok, bv = sg._gather_rows(A, B)
    vals = torch.einsum("nwij,nwvjk->nwvik", A.vals, bv)
    return (cols.reshape(nb, -1), vals.reshape((nb, -1) + vals.shape[-2:]),
            ok.reshape(nb, -1))


def median_ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    return statistics.median(ms)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    sg = importlib.import_module("pyamg_tpu_torch.ops.spgemm")
    from pyamg_tpu_torch.ops.rowops import dedup_rows
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    products, _ = cs.spgemm_products()
    last = None
    for tag, (A, B) in products.items():
        Ad = A.to(dev)
        Bd = last if B is None else B.to(dev)
        block = A.blocksize != (1, 1)
        prod = sg.spgemm_bell if block else sg.spgemm
        n_cols = Bd.shape[1] // Bd.blocksize[1]
        forms = {"per slot": lambda: per_slot(Ad, Bd, block),
                 "2-D": lambda: two_d(sg, Ad, Bd, block)}
        (c1, v1, ok1), (c2, v2, ok2) = forms["per slot"](), forms["2-D"]()
        # a block product's einsum may round otherwise in another batching
        scale = float(v1.abs().max())
        diff = float((v1 - v2).abs().max())
        same = torch.equal(c1, c2) and torch.equal(ok1, ok2) and (
            diff == 0 or (block and diff <= 1e-6 * scale))
        cs.check(same, f"{tag}: the two forms give other candidates "
                       f"(values differ by {diff:.3e} of {scale:.3e})")
        times = {k: [] for k in forms}
        for name in ("per slot", "2-D", "2-D", "per slot"):
            expand = forms[name]
            times[name].append((
                median_ms(expand, args.reps),
                median_ms(lambda: dedup_rows(*expand(), n_cols), args.reps)))
        n = Ad.cols.shape[0]
        print(f"spgemm_forms: {tag}: n {n}, WA {Ad.width}, WB {Bd.width}, "
              f"candidates equal {same} (values differ by {diff:.3e} of "
              f"{scale:.3e}); median ms of {args.reps} (expand "
              f"alone, expand + dedup_rows), two runs each: "
              + "; ".join(f"{k} {[(round(a, 4), round(b, 4)) for a, b in v]}"
                          for k, v in times.items()), flush=True)
        last = prod(Ad, Bd)


if __name__ == "__main__":
    main()
