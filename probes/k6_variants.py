#!/usr/bin/env python3
"""Time K6 (``dist_slice_apply``) in its build variants on one CUDA card.

    python3 probes/k6_variants.py [--n 1414] [--rounds 3] [--solves 30]

Builds ``csrc/dist_kernels.cu`` as it is (``base``: groups of 4 slots)
and with ``-DPYAMG_DIST_GROUP=2`` and ``=8`` (the slots a thread loads before it
adds; 16 measured slower than 8, and 8 than 4).  Each variant then runs in a process of its own, the variants in
turn for ``--rounds`` rounds (reversed every other round): 2-D Poisson
n^2, float32, on a one-rank NCCL group (the ``distsa_1414sq.rhs``
configuration), every product of the V-cycle held to the plain version
bit for bit, then the median wall of ``--solves`` device-stopped
``solve_cg`` calls on one b (two warm solves first), the device's busy
time of that solve in the per-step form (profiler, median of 3) and the
device time of a few products (profiler, mean of 50 calls, L2 warm).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"base": [],
            "group2": ["-DPYAMG_DIST_GROUP=2"],
            "group8": ["-DPYAMG_DIST_GROUP=8"]}
TIMED = ("level 0 A jacobi", "level 0 A jacobi0", "level 0 P correct",
         "level 0 R apply", "level 1 A jacobi", "level 1 R apply",
         "level 2 R apply", "level 3 R apply", "level 4 A jacobi")


def one(path, n, solves):
    """One variant, the library at ``path``, in this process: a JSON line
    {"solve_ms", "busy_ms", "iterations", "relres", "device_us":
    {product: us}}."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from pyamg_tpu_torch.ops import dist_kernels as tk
    from pyamg_tpu_torch.ops import launch
    from pyamg_tpu_torch.parallel import (dist_stencil_grid,
                                          distributed_sa_setup,
                                          make_row_mesh)
    launch._LIBRARIES["dist_kernels"] = launch.bind(path, tk.ENTRY_POINTS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_row_mesh(1, device=dev)
        st = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)
        cols, vals, ok, n_loc = dist_stencil_grid(st, (n, n), mesh,
                                                  dtype=torch.float32)
        hier = distributed_sa_setup(cols, vals, ok, n_loc, mesh,
                                    coarsen_until=4096)
        del cols, vals, ok
        b = np.random.default_rng(0).standard_normal(hier.levels[0].n)
        b[n * n:] = 0.0
        for _ in range(2):
            x, relres, it = hier.solve_cg(b, tol=1e-8, maxiter=40)
        torch.cuda.synchronize()
        walls = []
        for _ in range(solves):
            t0 = time.perf_counter()
            hier.solve_cg(b, tol=1e-8, maxiter=40)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # the device's busy time of one solve, in the per-step form whose
        # kernels the profiler sees (median of 3)
        busy = statistics.median(cs.profiled(cs.per_step(
            lambda: hier.solve_cg(b, tol=1e-8, maxiter=40)))[1]
            for _ in range(3))
        gen = torch.Generator(device=dev).manual_seed(3)
        device_us = {}
        for lvl, name, L, _, needs in cs.k6_products(hier):
            mode = name.split()[1] if name != "R apply" else "apply"
            src = None if mode == "jacobi0" else torch.randn(
                L.src_len, generator=gen, device=dev)
            vecs = {k: torch.randn(L.rows, generator=gen, device=dev)
                    for k in needs}
            got = tk.dist_slice_apply(L, src, mode, **vecs)
            want = tk.dist_slice_apply_plain(L, src, mode, **vecs)
            tag = f"level {lvl} {name}"
            cs.check(torch.equal(got, want),
                     f"k6: {tag} differs from the plain version")
            if tag in TIMED:
                device_us[tag] = cs.device_ms(
                    lambda: tk.dist_slice_apply(L, src, mode, **vecs)) * 1e3
        print(json.dumps({"solve_ms": statistics.median(walls) * 1e3,
                          "busy_ms": busy / 1e3, "iterations": int(it),
                          "relres": float(relres),
                          "device_us": device_us}))
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1414)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--solves", type=int, default=30)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.one:
        one(args.one, args.n, args.solves)
        return
    from pyamg_tpu_torch._native.build import NVCC_FLAGS, shared_library
    from pyamg_tpu_torch.ops import launch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    nvcc = "/usr/local/cuda/bin/nvcc"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {k: pool.submit(shared_library,
                                  launch.source("dist_kernels"),
                                  [nvcc, *NVCC_FLAGS, *flags],
                                  "dist_kernels_" + k)
                   for k, flags in VARIANTS.items()}
        paths = {k: f.result()["path"] for k, f in futures.items()}
    print(f"k6: {len(paths)} builds in {time.perf_counter() - t0:.1f} s")
    got = {k: [] for k in paths}
    for r in range(args.rounds):
        order = list(paths) if r % 2 == 0 else list(paths)[::-1]
        for name in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 paths[name], "--n", str(args.n), "--solves",
                 str(args.solves)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"k6 {name}: failed\n{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            got[name].append(res)
            print(f"k6: round {r} {name}: solve median "
                  f"{res['solve_ms']:.3f} ms, busy {res['busy_ms']:.3f} ms "
                  f"({res['iterations']} iterations, relres "
                  f"{res['relres']:.3e})", flush=True)
    for name, runs in got.items():
        parts = ", ".join(
            f"{t} {statistics.median(r['device_us'][t] for r in runs):.2f}"
            for t in TIMED)
        print(f"k6: {name}: solve medians "
              f"{[round(r['solve_ms'], 3) for r in runs]} ms, busy "
              f"{[round(r['busy_ms'], 3) for r in runs]} ms; device us, L2 "
              f"warm (median over rounds): {parts}")


if __name__ == "__main__":
    main()
