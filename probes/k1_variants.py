#!/usr/bin/env python3
"""Time K1 (``dia_spmv``) against the parent commit's kernel and in its
variants on one CUDA card.

    python3 probes/k1_variants.py [--parent FILE]

On the DIA operators of both main paths (2-D Poisson 500^2 levels 0 and
1, 3-D Poisson 64^3 A0) and on 2-D Poisson 2048^2, float32, it times:

- ``new``: the build of ``csrc/dia_kernels.cu``, in the launch shape
  ``spmv_geometry`` gives; with ``--parent FILE`` (the parent commit's
  ``csrc/dia_kernels.cu``: one thread a row, offsets from device memory
  staged through shared memory) also ``parent``, in the order parent,
  new, new, parent, so that the spread between two timings of one kernel
  shows beside the difference between them;
- ``generic``: a build with ``-DPYAMG_DIA_SPMV_GENERIC`` (every width in
  groups of 8 diagonals; no kernel of the operator's own width), in the
  order generic, new, new, generic, and in the solves;
- ``offsets N``: builds with ``-DPYAMG_DIA_SPMV_OFFSETS=N`` (N offsets at
  most by value in the kernel parameter; N = 1 sends every band through
  device memory): the device time, and the host's time a launch over
  2000 launches of the C entry point in a row (ctypes, then one
  synchronise), which is where a larger parameter would cost;
- ``threads T``: the new kernel in blocks of T threads.

Each variant is held to the plain version to 0, then timed as
``chip_smoke.py`` times a kernel: the median (and range) of 50 calls each
made after a 256 MB read that flushes L2, and the mean of 50 calls with
L2 warm.  Last, each path's warm solve is profiled with the new K1 and
(with ``--parent``) with the parent's, in the order new, parent, parent,
new, then with the build for any width (generic, new, new, generic), and
K1's device time and launches are read from the trace.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFSETS = (1, 64, 1024, 8000)
THREADS = (32, 64, 128, 256)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the parent commit's dia_kernels.cu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    from pyamg_tpu_torch._native.build import NVCC_FLAGS, shared_library
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, to_scipy

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nvcc = "/usr/local/cuda/bin/nvcc"
    builds = {"generic": (dk.SOURCE, ["-DPYAMG_DIA_SPMV_GENERIC"])}
    builds.update({f"offsets {c}": (dk.SOURCE,
                                    [f"-DPYAMG_DIA_SPMV_OFFSETS={c}"])
                   for c in OFFSETS})
    if args.parent:
        builds["parent"] = (os.path.abspath(args.parent), [])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        new = pool.submit(dk.build)
        futures = {k: pool.submit(shared_library, src, [nvcc, *NVCC_FLAGS,
                                                        *flags],
                                  "dia_kernels_" + k.replace(" ", "_"))
                   for k, (src, flags) in builds.items()}
        paths = {k: f.result()["path"] for k, f in futures.items()}
        new.result()
    print(f"k1: {len(builds) + 1} builds in {time.perf_counter() - t0:.1f} s")
    libs = {k: ctypes.CDLL(p) if k == "parent" else dk.bind(p)
            for k, p in paths.items()}
    libs["new"] = dk._lib()
    if "parent" in libs:       # the parent's C entry point
        libs["parent"].pyamg_dia_spmv_f32.restype = ctypes.c_int
        libs["parent"].pyamg_dia_spmv_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]

    def caller(label, data, offsets, n, x, threads=None):
        """A function that runs K1 of build ``label`` once on (data,
        offsets, n, x), 1-D x, and returns y."""
        lib, nd = libs[label], len(offsets)
        fn = lib.pyamg_dia_spmv_f32
        offs = dk._device_ints(offsets, dev)
        if label == "parent":
            def call():
                y = torch.empty_like(x)
                dk._check(fn(data.data_ptr(), nd, data.shape[1],
                             offs.data_ptr(), n, x.data_ptr(), y.data_ptr(),
                             dk._stream(dev)), "dia_spmv (parent)")
                return y
            return call
        g = dk.spmv_geometry(n, 1, data.shape[1], 4, sms)
        t = threads or g.threads
        groups = -(-n // g.rows)
        blocks = -(-groups // t)
        host = dk._host_ints(tuple(offsets))
        far = offs.data_ptr() if nd > lib.spmv_capacity else None

        def call():
            y = torch.empty_like(x)
            dk._check(fn(data.data_ptr(), nd, data.shape[1], host, far, n, 1,
                         x.data_ptr(), y.data_ptr(), t, blocks,
                         dk._stream(dev)), f"dia_spmv ({label})")
            return y
        return call

    _, ml2, _ = cs.build_hierarchy(500, 4096, dev)
    ml2.to_device(dev)
    _, ml3 = cs.build_sa3d(64)
    ml3.to_device(dev)
    ops = {"500^2 level 0": ml2.levels[0].A, "500^2 level 1": ml2.levels[1].A,
           "64^3 A0": ml3.levels[0].A,
           "2048^2": dia_from_ell(poisson((2048, 2048)).astype(np.float32))}
    rng = np.random.default_rng(2022)
    flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
    skip = cs.flush_ops(flush)
    ok = True

    def timed(tag, call, want):
        nonlocal ok
        err = float((call() - want).abs().max())
        ok &= err == 0
        cold = cs.flushed_ms(call, flush, skip)
        print(f"k1: {tag}: {statistics.median(cold) * 1e3:.2f} us flushed "
              f"(median; {min(cold) * 1e3:.2f}-{max(cold) * 1e3:.2f}), "
              f"{cs.device_ms(call) * 1e3:.2f} us L2-warm, "
              f"max_abs_err={err:.3e}", flush=True)

    for name, D in ops.items():
        n, offsets = D.shape[0], tuple(D.offsets)
        data = torch.as_tensor(D.data, device=dev).float()
        x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        want = dk.dia_spmv_plain(data, offsets, n, x)
        g = dk.spmv_geometry(n, 1, data.shape[1], 4, sms)
        order = ["parent", "new", "new", "parent"] if args.parent else \
            ["new", "new"]
        for label in order + ["generic", "new", "new", "generic",
                              *(f"offsets {c}" for c in OFFSETS)]:
            timed(f"{name} {label} {g}", caller(label, data, offsets, n, x),
                  want)
        for t in THREADS:
            timed(f"{name} new, threads {t}",
                  caller("new", data, offsets, n, x, t), want)
        if name != "500^2 level 0":
            continue
        # the host's time a launch against the size of the parameter
        for label in ("new", *(f"offsets {c}" for c in OFFSETS)):
            call = caller(label, data, offsets, n, x)
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                call()
            t_host = (time.perf_counter() - t0) / 2000
            torch.cuda.synchronize()
            t_all = (time.perf_counter() - t0) / 2000
            print(f"k1: {name} {label} launch: host {t_host * 1e6:.2f} us a "
                  f"launch, {t_all * 1e6:.2f} us a launch with the device "
                  f"(2000 in a row)", flush=True)

    # each path's warm solve with the new K1 and with the parent's
    b2 = np.random.default_rng(2022).standard_normal(ml2.levels[0].A.shape[0])
    b3 = np.random.default_rng(0).standard_normal(ml3.levels[0].A.shape[0])
    S3 = to_scipy(poisson((64, 64, 64)))
    solves = {"500^2": lambda: ml2.solve_refined_device(b2),
              "64^3": lambda: ml3.solve_refined(b3, A_fine=S3, tol=1e-10,
                                                accel="cg")}
    wrapper = dk.dia_spmv

    def parent_spmv(data, offsets, n, x):
        """The parent's K1 behind the wrapper: once per column."""
        def one(xc):
            return caller("parent", data, tuple(offsets), n, xc)()
        return dk._columns(one, x)

    def generic_spmv(data, offsets, n, x):
        """The build for any width behind the wrapper (1-D x)."""
        return caller("generic", data, tuple(offsets), n, x)()

    kinds = ["new", "parent", "parent", "new"] if args.parent else ["new"]
    kinds += ["generic", "new", "new", "generic"]
    for kind in kinds:
        dk.dia_spmv = {"new": wrapper, "parent": parent_spmv,
                       "generic": generic_spmv}[kind]
        for tag, solve in solves.items():
            solve()
            wall, busy, events, _ = cs.profiled(solve)
            k1 = [(nm, t - s) for nm, s, t in events if "dia_spmv" in nm]
            # the new kernel's widths have names of their own
            by_name = {}
            for nm, d in k1:
                c, tot = by_name.get(nm, (0, 0.0))
                by_name[nm] = (c + 1, tot + d)
            print(f"k1: {tag} solve, {kind}: K1 {sum(d for _, d in k1):.1f} "
                  f"us device in {len(k1)} launches; busy {busy / 1e3:.3f} "
                  f"ms, wall {wall / 1e3:.3f} ms; by kernel (launches, us) "
                  f"{by_name}", flush=True)
    dk.dia_spmv = wrapper
    cs.check(ok, "a K1 variant disagreed with its plain version")
    print("k1: ok")


if __name__ == "__main__":
    main()
