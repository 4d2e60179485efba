#!/usr/bin/env python3
"""Time K2 (``dia_gs_sweep``) in each of its launch shapes on one CUDA card.

    python3 probes/k2_regimes.py [--parent DIR]

On the DIA operators of both main paths (2-D Poisson 500^2 levels 0 and 1,
3-D Poisson 64^3 A0) and on 2-D Poisson 2048^2 (float32, a symmetric
sweep at omega 1) it runs K2 in these shapes:

- ``staged``: the staged one-launch kernel wherever a block's rows fit
  in shared memory (one block an SM), from the build of
  ``csrc/dia_kernels.cu``, whose 5-diagonal operators get a kernel of
  their own width; ``staged generic``: the same launch in a build with
  ``-DPYAMG_DIA_GS_GENERIC`` (the kernel for any number of diagonals);
  both timed twice, in the order A B B A, so that the spread between two
  timings of one launch shows beside the difference between them;
  ``staged, 2 an SM``: two blocks of 512 threads an SM;
- ``device, b an SM``: one launch that reads the band each pass, b blocks
  of 1024 / b threads an SM, b = 1, 2, 4;
- ``pass``: the device kernel launched once a pass, 256 threads a block.

Each K2 shape is held to its plain version to 0, then timed with
torch.profiler: the median (and range) of 50 calls each made after a
256 MB read that flushes L2, and the mean of 50 calls with L2 warm.  Then
each path's warm solve is profiled with every DIA level in one shape at
a time (as ``gs_geometry`` picks, staged wherever it fits, one launch a
pass, and the device regime at b blocks an SM), and K2's device time and
launches are read from the trace; the first is timed again last.  With
``--parent DIR`` (a checkout of the commit before the one-launch K2,
whose K2 is one launch a color pass) the same operators and solves are
timed with that tree's K2 in a subprocess.
"""

import argparse
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the parent's K2 at the same operators and solves, run from its checkout
PARENT = r'''
import statistics, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.relaxation.relaxation import gs_order
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse.matrix import to_scipy
dev = torch.device("cuda")
rng = np.random.default_rng(2022)
_, ml2, _ = cs.build_hierarchy(500, 4096, dev)
ml2.to_device(dev)
_, ml3 = cs.build_sa3d(64)
ml3.to_device(dev)
flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
skip = cs.flush_ops(flush)
for name, lvl in (("500^2 level 0", ml2.levels[0]),
                  ("500^2 level 1", ml2.levels[1]),
                  ("64^3 A0", ml3.levels[0])):
    _, so, params = lvl.pre
    D, n = lvl.A, lvl.A.shape[0]
    col = torch.as_tensor(params["colors"], device=dev)
    Di = torch.as_tensor(params["Dinv"], device=dev)
    x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
    b = torch.as_tensor(rng.standard_normal(n), device=dev).float()
    order = gs_order(so["ncolors"], "symmetric", 1, 1.0)
    call = lambda: dk.dia_gs_sweep(D.data, D.offsets, n, x, b, Di, col,
                                   order, 1.0)
    want = dk.dia_gs_sweep_plain(D.data, D.offsets, n, x, b, Di, col, order,
                                 1.0)
    err = float((call() - want).abs().max())
    cold = cs.flushed_ms(call, flush, skip)
    print(f"k2: {name} parent (one launch a pass): "
          f"{statistics.median(cold) * 1e3:.2f} us flushed (median; "
          f"{min(cold) * 1e3:.2f}-{max(cold) * 1e3:.2f}), "
          f"{cs.device_ms(call) * 1e3:.2f} us L2-warm, max_abs_err={err:.3e}",
          flush=True)
b2 = np.random.default_rng(2022).standard_normal(ml2.levels[0].A.shape[0])
b3 = np.random.default_rng(0).standard_normal(ml3.levels[0].A.shape[0])
S3 = to_scipy(poisson((64, 64, 64)))
for tag, solve in (("500^2", lambda: ml2.solve_refined_device(b2)),
                   ("64^3", lambda: ml3.solve_refined(b3, A_fine=S3,
                                                      tol=1e-10, accel="cg"))):
    solve()
    wall, busy, events, _ = cs.profiled(solve)
    k2 = [t - s for nm, s, t in events if "dia_gs" in nm]
    copies = [t - s for nm, s, t in events if "Memcpy DtoD" in nm]
    print(f"k2: {tag} solve, parent: K2 {sum(k2):.1f} us device in {len(k2)} "
          f"launches (device-to-device copies {sum(copies):.1f} us in "
          f"{len(copies)}); busy {busy / 1e3:.3f} ms, wall {wall / 1e3:.3f} ms",
          flush=True)
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of the parent commit")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    from pyamg_tpu_torch._native.build import NVCC_FLAGS, shared_library
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops.launch import bind, library, source
    from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gs_order,
                                                       make_coloring)
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, to_scipy

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nvcc = "/usr/local/cuda/bin/nvcc"
    generic = shared_library(source("dia_kernels"),
                             [nvcc, *NVCC_FLAGS, "-DPYAMG_DIA_GS_GENERIC"],
                             "dia_kernels_variant")["path"]
    libs = {"staged": library("dia_kernels", dk.ENTRY_POINTS),
            "staged generic": bind(generic, dk.ENTRY_POINTS)}
    rng = np.random.default_rng(2022)

    _, ml2, _ = cs.build_hierarchy(500, 4096, dev)
    ml2.to_device(dev)
    _, ml3 = cs.build_sa3d(64)
    ml3.to_device(dev)
    P2048 = poisson((2048, 2048)).astype(np.float32)
    colors_b, nc_b = make_coloring(P2048)

    def level(lvl):
        _, so, params = lvl.pre
        return lvl.A, params["colors"], so["ncolors"], params["Dinv"]

    ops = {"500^2 level 0": level(ml2.levels[0]),
           "500^2 level 1": level(ml2.levels[1]),
           "64^3 A0": level(ml3.levels[0]),
           "2048^2": (dia_from_ell(P2048), colors_b, nc_b, dinv_vec(P2048))}

    def device_shape(n, nd, halo, per_sm):
        return dk._gs_shape(n, per_sm * sms, nd, halo, 4, False,
                            dk.MAX_THREADS // per_sm)

    def staged_shape(n, nd, halo, item=4, sms=sms):
        """The staged launch wherever a block's rows fit."""
        g = dk._gs_shape(n, min(sms, -(-n // dk.GS_MIN_ROWS)), nd, halo,
                         item, True)
        return g if g.smem <= dk.MAX_SMEM else None

    def pass_shape(n, nd, halo, item=4, sms=sms):
        return dk._gs_shape(n, -(-n // 256), nd, halo, item, False, 256)

    launch = dk._gs_launch

    def per_pass(g, data, offsets, n, x, b, Dinv, colors, order, omega,
                 lib=None):
        """One launch a pass: a device-regime launch of one pass waits for
        no block."""
        for c in order:
            x = launch(pass_shape(n, len(offsets), g.halo), data, offsets, n,
                       x, b, Dinv, colors, [c], omega, lib)
        return x

    def shapes(n, nd, halo):
        st = staged_shape(n, nd, halo)
        out = []
        if st is not None:
            out += [("staged", st), ("staged generic", st),
                    ("staged generic", st), ("staged", st),
                    ("staged, 2 an SM", dk._gs_shape(n, 2 * sms, nd, halo, 4,
                                                     True, 512))]
        out += [(f"device, {b} an SM", device_shape(n, nd, halo, b))
                for b in (1, 2, 4)]
        return out + [("pass", pass_shape(n, nd, halo))]

    flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
    skip = cs.flush_ops(flush)
    ok = True
    for name, (D, colors, nc, Dinv) in ops.items():
        n, nd = D.shape[0], len(D.offsets)
        halo = max(abs(o) for o in D.offsets)
        data = torch.as_tensor(D.data, device=dev).float()
        colors = torch.as_tensor(colors, device=dev)
        Dinv = torch.as_tensor(Dinv, device=dev).float()
        x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        b = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        order = gs_order(nc, "symmetric", 1, 1.0)
        want = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Dinv, colors,
                                     order, 1.0)
        for label, g in shapes(n, nd, halo):
            lib = libs.get(label)

            def call(g=g, lib=lib, run=per_pass if label == "pass" else
                     launch):
                return run(g, data, D.offsets, n, x, b, Dinv, colors, order,
                           1.0, lib)

            try:
                err = float((call() - want).abs().max())
            except RuntimeError as e:       # a shape the card cannot hold
                print(f"k2: {name} {label} {g}: {e}", flush=True)
                continue
            ok &= err == 0
            cold = cs.flushed_ms(call, flush, skip)
            print(f"k2: {name} {label} {g}: "
                  f"{statistics.median(cold) * 1e3:.2f} us flushed (median; "
                  f"{min(cold) * 1e3:.2f}-{max(cold) * 1e3:.2f}), "
                  f"{cs.device_ms(call) * 1e3:.2f} us L2-warm, "
                  f"max_abs_err={err:.3e}", flush=True)

    # each path's warm solve, every DIA level in one shape at a time
    b2 = np.random.default_rng(2022).standard_normal(ml2.levels[0].A.shape[0])
    b3 = np.random.default_rng(0).standard_normal(ml3.levels[0].A.shape[0])
    S3 = to_scipy(poisson((64, 64, 64)))
    solves = {"500^2": lambda: ml2.solve_refined_device(b2),
              "64^3": lambda: ml3.solve_refined(b3, A_fine=S3, tol=1e-10,
                                                accel="cg")}
    chosen = dk.gs_geometry
    routes = [("gs_geometry", chosen, launch),
              ("staged where it fits", lambda n, nd, halo, item, sms:
               staged_shape(n, nd, halo, item, sms) or chosen(
                   n, nd, halo, item, sms), launch),
              ("pass", chosen, per_pass)]
    routes += [(f"device, {b} an SM",
                lambda n, nd, halo, item, sms, b=b: device_shape(n, nd, halo,
                                                                 b), launch)
               for b in (1, 2, 4)]
    for label, geometry, run in routes + routes[:1]:
        dk.gs_geometry, dk._gs_launch = geometry, run
        for tag, solve in solves.items():
            solve()
            dk.reset_launch_counts()
            wall, busy, events, _ = cs.profiled(solve)
            k2 = [t - s for nm, s, t in events if "dia_gs" in nm]
            print(f"k2: {tag} solve, {label}: K2 {sum(k2):.1f} us device in "
                  f"{len(k2)} launches, {sum(dk.dia_gs_sweep.passes.values())}"
                  f" passes in {dk.dia_gs_sweep.launches} sweeps; busy "
                  f"{busy / 1e3:.3f} ms, wall {wall / 1e3:.3f} ms; sweeps by "
                  f"operator {dict(dk.dia_gs_sweep.by_op)}", flush=True)
    dk.gs_geometry, dk._gs_launch = chosen, launch
    cs.check(ok, "a K2 launch disagreed with its plain version")

    if args.parent:
        rc = subprocess.run([sys.executable, "-c", PARENT],
                            cwd=args.parent).returncode
        cs.check(rc == 0, f"the parent's timings failed ({rc})")
    print("k2: ok")


if __name__ == "__main__":
    main()
