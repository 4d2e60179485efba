#!/usr/bin/env python3
"""Drive pyamg_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the CUDA kernels from ``pyamg_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with each kernel's
   registers, shared memory, stack frame and spills from ``-Xptxas -v``;
2. kernels: K1 (banded SpMV) against its plain PyTorch version to 0 on
   every DIA operator of both paths (500^2 levels 0 and 1, 64^3 A0) and
   at 2048^2, float32 and float64; on a 2- and a 3-column x (one launch
   each), an x holding an inf and a NaN, an x off a 16-byte boundary, a
   band of 80 diagonals, a band wider than the offsets a launch takes by
   value (read from device memory), an ``npad`` that is not a multiple of
   4 with an n that is not a multiple of the rows a thread, and the
   one-sided band {-1500, -40, -1, 0}; K2 (multicolor Gauss-Seidel
   sweep, one launch a sweep) on the DIA operators of both paths (500^2
   levels 0 and 1 in the staged regime, 64^3 A0 in the regime that reads
   the band each pass), on 2-D Poisson 2048^2 (the band past shared
   memory), and in the staged regime on a one-sided band and on a band
   of 80 diagonals: symmetric, omega 1 and 0.8, float32 and float64, on
   an x holding an inf and a NaN and on a 2-column x, each to 0; the
   double-single ``two_prod`` against float64; K3 (SELL SpMV) on every
   SELL operator of the 3-D Poisson 64^3 hierarchy, on x and on x holding
   an inf and a NaN, and, in the K4 regime, on the SELL plan of 2-D Poisson
   1800^2; K5 (hybrid Gauss-Seidel) forward, backward and symmetric, omega
   1 and 0.8, on the 64^3 path's square SELL levels A1 and A2 (and on x
   holding inf and NaN) and, with x past shared memory, on the 1800^2 plan
   (off the main path);
3. main path: 2-D Poisson 500^2, grid smoothed aggregation, stencil
   compression, dense coarse tail, double-single refinement, solved to
   1e-10 on the card with the kernels' launch counts read around it, K1's
   launches and K2's launches and color passes per DIA level; then a 96^2
   solve on the card against the same solve on the CPU;
4. sa3d: 3-D Poisson 64^3, standard smoothed aggregation, DIA and SELL
   layouts, ``solve_refined(tol=1e-10, accel="cg")`` as
   ``bench_suite.bench_sa_poisson_3d_64`` runs it, with the launch counts
   read around the solve, per kernel, per SELL operator and per DIA level;
   then a 24^3 solve on the card against the same solve on the CPU;
5. times after a warm-up: for each path the warm solve (host clock) and
   one warm solve under torch.profiler, broken down into device busy
   time, idle share, device operations, host syncs and kernels by device
   time; one 500^2 V-cycle; and one row per kernel and operator (K1 and
   K2 on each DIA operator of both paths and at 2048^2, K3 on the six 64^3
   operators and in the K4 regime, K5 on A1 and A2) beside its byte
   bound, plain version and library call (device time per call from
   torch.profiler: the median of calls made with L2 flushed before each,
   for the kernel and the library call, and the mean with L2 warm; and
   CUDA events around back-to-back calls).  A bound counts each
   input read once and each output written once: for a SELL operator its
   stored non-zeros (value and column), not the padded slots of its plan.

It then prints the kernel table as one JSON line and, last, the device
line.  Any failed check exits non-zero; without a CUDA device it exits
non-zero before printing a result.
"""

import json
import re
import statistics
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
SEED = 2022
# the JAX package's inner CG iterations per outer step on the 64^3 path
# (tests/jax_sell_reference.py 64, Pallas kernels in interpret mode on a
# CPU): the port's counts must equal them within 1
JAX_INNER_64 = (6, 7)
# (kind, t, passes, Sy) of the SELL operators at 64^3 and the layout of
# each level's (A, P, R)
SELL_64 = {"P0": ("tall", 8, 13, 2048), "R0": ("fat", 8, 152, 256),
           "A1": ("tall", 1, 66, 256), "P1": ("tall", 41, 11, 328),
           "R1": ("fat", 41, 839, 8), "A2": ("tall", 1, 89, 8)}
LAYOUT_64 = [("DIA", "SELL", "SELL"), ("SELL", "SELL", "SELL"),
             ("SELL", "ELL", "ELL"), ("DIA", "NoneType", "NoneType")]
# the JAX package's iterations on the solvers phase's paths (CPU, full
# size; JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/jax_solver_reference.py): S1-S5 iterations, S6 (outer, inner per
# outer); the port's must equal them within 1
JAX_SOLVERS = {"S1": 5, "S2": 7, "S3": 10, "S4": 16, "S5": 4,
               "S6": (2, (6, 8))}
# the JAX package's true relative residual on S1 (the same command): GMRES
# stops on the preconditioned residual, so S1's true one is held to twice
# the JAX package's, not to tol
JAX_S1_TRUE_RELRES = 4.6727206771483163e-05
# the (omega, sweep) pairs the solvers phase adds to K2 and K5
SOLVER_K2_PAIRS = ((1.2, "symmetric"), (1.2, "forward"), (1.2, "backward"))
SOLVER_K5_PAIRS = ((1.2, "forward"), (1.2, "backward"))
# a profiler trace that comes back without its device operations is taken
# again, after a pause (an empty trace has come back whole after one)
TRACE_TRIES = 5
TRACE_PAUSE_S = 0.5


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def cuda_ms(fn, reps=200, warmup=10):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(body, n):
    """The device operations that torch.profiler records over ``n`` calls
    of ``body``, in order of their start.  Every caller's body runs work on
    the device, so a trace that holds none (the profiler now and then
    returns one) is taken again after a pause, up to TRACE_TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for k in range(TRACE_TRIES):
        if k:
            time.sleep(TRACE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                body()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break
    return events


def device_ms(fn, reps=50):
    """Mean device milliseconds per call of ``fn``: the kernel intervals
    that torch.profiler records over ``reps`` calls, summed.  Unlike
    events around back-to-back calls, this leaves out the host's time
    between launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start
                   for e in device_events(fn, reps))
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / reps / 1e3


def flush_ops(flush):
    """The names of the device operations of one read through ``flush``."""
    names = {e.name for e in device_events(flush.sum, 1)}
    check(names, "the trace of the L2 flush holds no device operation")
    return names


def flushed_ms(fn, flush, skip, reps=50):
    """Device milliseconds of each of ``reps`` calls of ``fn``, each made
    after reading through ``flush`` (a tensor larger than the card's 50 MB
    L2), so that the call finds its inputs in device memory, not in L2.
    The read's own operations (``skip``, from ``flush_ops``) mark the
    calls apart and are not counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    check(not skip & {e.name for e in device_events(fn, 1)},
          "the L2 flush runs a kernel that the timed call runs too")

    def body():
        flush.sum()
        fn()

    for k in range(TRACE_TRIES):    # a trace that lost operations is taken
        if k:                       # again
            time.sleep(TRACE_PAUSE_S)
        calls, cur = [], None
        for e in device_events(body, reps):
            if e.name in skip:
                if cur is not None:
                    calls.append(cur)
                cur = None
            else:
                cur = (cur or 0.0) + e.time_range.end - e.time_range.start
        calls.append(cur)
        if len(calls) == reps and all(c for c in calls):
            break
    check(len(calls) == reps and all(c for c in calls),
          f"{len(calls)} flushed calls traced, {reps} made")
    return [c / 1e3 for c in calls]


def rel_err(got, want):
    """(max |got - want|, max |want|)."""
    return (float((got - want).abs().max()), float(want.abs().max()))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def build_hierarchy(N, max_n, device, ds=True, dtype=np.float32, **kw):
    """The main path's setup on 2-D Poisson N^2 (``kw`` to
    ``smoothed_aggregation_solver``): (A64, ml, levels and operator
    complexity of the hierarchy before the coarse collapse)."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    A64 = poisson((N, N))
    ml = smoothed_aggregation_solver(A64.astype(dtype),
                                     aggregate=("grid", {}), max_coarse=10,
                                     **kw)
    full = (len(ml.levels), ml.operator_complexity())
    ml.compress_stencils()
    if max_n:
        ml.collapse_coarse(max_n=max_n, device=device)
    if ds:
        ml.enable_ds_refinement(A64, device=device)
    return A64, ml, full


def ptxas_report(log):
    """[(kernel, registers, shared-memory bytes, stack frame, spill
    stores, spill loads)] from an ``nvcc -Xptxas -v`` log."""
    out, name, spills = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = name = m.group(1)
            # <length><identifier> pieces of the mangled name
            for k in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
                ident = k.group(2)[:int(k.group(1))]
                if ident.endswith("_kernel"):
                    name = ident
            args = re.search(r"_kernelI(.+?)EEv", mangled)
            if args:
                name += "<" + ",".join(
                    a.replace("Li", ",").replace("Lb0", "false")
                    .replace("Lb1", "true").strip(",")
                    for a in args.group(1).split("E") if a) + ">"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spills = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, *spills))
            name, spills = None, (0, 0, 0)
    return out


def same_non_finite(got, want):
    """Whether two vectors are non-finite (inf, NaN) at the same places."""
    import torch
    return bool(torch.equal(torch.isfinite(got), torch.isfinite(want)) and
                torch.equal(torch.isnan(got), torch.isnan(want)))


def non_finite(x):
    """A copy of x with an inf at a third and a NaN at two thirds."""
    x = x.clone()
    x[x.shape[0] // 3] = float("inf")
    x[2 * x.shape[0] // 3] = float("nan")
    return x


def build_kernels():
    """Build every CUDA source of the port at once (one nvcc each)."""
    from concurrent.futures import ThreadPoolExecutor
    from pyamg_tpu_torch.ops import dia_kernels, sell_kernels
    with ThreadPoolExecutor(2) as pool:
        futures = [(m.__name__.rsplit(".", 1)[-1], pool.submit(m.build))
                   for m in (dia_kernels, sell_kernels)]
        return {name: f.result() for name, f in futures}


def build_sa3d(N, **kw):
    """The 3-D Poisson N^3 path's setup (``bench_suite.py:65-80``; ``kw``
    to ``smoothed_aggregation_solver``): (A64, ml) with standard smoothed
    aggregation, ``max_coarse=50``, stencils compressed (DIA and SELL)."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    A64 = poisson((N, N, N))
    ml = smoothed_aggregation_solver(A64.astype(np.float32), max_coarse=50,
                                     **kw)
    return A64, ml.compress_stencils()


def sell_operators(ml):
    """{name: (placed SELL, host ELL original)} of a compressed hierarchy."""
    from pyamg_tpu_torch.sparse.sell import SELL
    out = {}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            op = getattr(lvl, attr)
            if isinstance(op, SELL):
                out[f"{attr}{i}"] = (op, getattr(lvl, attr + "_ell"))
    return out


def layout(ml):
    return [tuple(type(getattr(l, a)).__name__ for a in "APR")
            for l in ml.levels]


def csr_on(S, device):
    """A scipy matrix as a float32 torch CSR tensor (the library yardstick)."""
    import torch
    S = S.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(S.indptr, dtype=torch.int64),
        torch.as_tensor(S.indices, dtype=torch.int64),
        torch.as_tensor(S.data, dtype=torch.float32), size=S.shape,
        device=device)


def profiled(fn):
    """Run ``fn`` once under torch.profiler: (wall us, device busy us,
    device ops [(name, start, end)], host syncs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for k in range(TRACE_TRIES):    # as device_events: a trace with no
        if k:                       # device operation is taken again
            time.sleep(TRACE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops, syncs = [], 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ops.append((e.name, e.time_range.start, e.time_range.end))
            elif e.name == "aten::_local_scalar_dense":
                syncs += 1
        if ops:
            break
    busy = busy_us([(s, t) for _, s, t in ops])
    check(busy > 0, "the profiled solve ran nothing on the device")
    return wall_us, busy, ops, syncs


def print_profile(tag, wall_us, busy, ops, syncs, top=12, phase="times"):
    print(f"{phase}: {tag} profiled warm solve wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.4f}, device ops {len(ops)}, host syncs "
          f"{syncs}")
    by_name = {}
    for name, s, t in ops:
        c, d = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, d + (t - s))
    for name, (c, d) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        print(f"{phase}: {tag} device {d:9.1f} us = {c:5d} x {d / c:7.2f} "
              f"us  {name[:90]}")


def solver_paths(dev, N2=500, N3=64):
    """The paths of the ``solvers:`` phase: [(name, what it runs, run,
    scipy A, b, tol, kernels it must launch, M)], ``run(residuals)``
    returning (x, info).  The true relative residual is checked below tol,
    except S1's: GMRES stops on the preconditioned residual, and a true
    relative residual below 1e-6 is not what it promises (the JAX
    package's own S1 stops at 4.7e-5), so S1's is checked through its
    preconditioner ``M`` (||M (b - A x)|| / ||M b|| in float64 below tol)
    and its true one against the JAX package's (``solvers_phase``).
    S1-S5 on 2-D Poisson N2^2, grid SA, float64 (in
    float32 no path reaches a true relative residual of 1e-6 at 500^2,
    the JAX package's neither: ``tests/jax_solver_reference.py
    --float32``); S6 on 3-D Poisson N3^3, standard SA, float32 (SELL)."""
    import torch
    from pyamg_tpu_torch import krylov
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A64, s1, _ = build_hierarchy(N2, 4096, dev, ds=False, dtype=np.float64)
    s1.to_device(dev)

    def grid_sa(smoother, **kw):
        _, ml, _ = build_hierarchy(N2, 0, dev, ds=False, dtype=np.float64,
                                   presmoother=smoother,
                                   postsmoother=smoother, **kw)
        return ml.to_device(dev)

    s2 = grid_sa(("sor", {"omega": 1.2, "sweep": "symmetric"}),
                 coarse_solver="splu")
    s3 = grid_sa(("chebyshev", {"degree": 3}), coarse_solver="cholesky")
    s4 = grid_sa(("jacobi", {"omega": 4.0 / 3.0, "iterations": 2}))
    S2, b = to_scipy(A64), np.random.default_rng(SEED).standard_normal(
        A64.shape[0])
    A3, s6 = build_sa3d(N3, presmoother=("sor", {"omega": 1.2,
                                                 "sweep": "forward"}),
                        postsmoother=("sor", {"omega": 1.2,
                                              "sweep": "backward"}))
    s6.to_device(dev)
    S3, b3 = to_scipy(A3), np.random.default_rng(0).standard_normal(
        A3.shape[0])
    dia = ("dia_spmv", "dia_gs_sweep")
    M1 = s1.aspreconditioner("W")

    def s1_precond(v):
        return M1.matvec(torch.as_tensor(v, device=dev)).cpu().numpy()

    def s6_run(res):
        it = {}
        x = s6.solve_refined(b3, A_fine=S3, tol=1e-10, accel="gmres",
                             cycle="W", residuals=res, iterations_out=it)
        return x, (it["outer"], tuple(it["inner"]))

    return [
        ("S1", "GMRES around a W-cycle, symmetric GS, dense coarse tail",
         lambda res: s1.solve(b, tol=1e-6, accel="gmres", cycle="W",
                              residuals=res, return_info=True),
         S2, b, 1e-6, dia, s1_precond),
        ("S2", "FGMRES around an F-cycle, SOR omega 1.2, LU coarse solve",
         lambda res: s2.solve(b, tol=1e-6, accel="fgmres", cycle="F",
                              residuals=res, return_info=True),
         S2, b, 1e-6, dia, None),
        ("S3", "CG around a V-cycle, Chebyshev degree 3, Cholesky coarse "
         "solve", lambda res: s3.solve(b, tol=1e-6, accel="cg",
                                       residuals=res, return_info=True),
         S2, b, 1e-6, ("dia_spmv",), None),
        ("S4", "standalone AMLI cycling, Jacobi omega 4/3 twice",
         lambda res: s4.solve(b, tol=1e-6, cycle="AMLI", maxiter=60,
                              residuals=res, return_info=True),
         S2, b, 1e-6, ("dia_spmv",), None),
        ("S5", "krylov.bicgstab preconditioned by S1's V-cycle",
         lambda res: krylov.bicgstab(s1.levels[0].A, b, tol=1e-6,
                                     M=s1.aspreconditioner("V"),
                                     residuals=res),
         S2, b, 1e-6, dia, None),
        ("S6", "solve_refined GMRES around a W-cycle, SOR omega 1.2 forward "
         "and backward", s6_run, S3, b3, 1e-10,
         dia + ("sell_spmv", "sell_gs_sweep"), None),
    ]


def solvers_phase(dev, paths, jax_counts, jax_s1_relres, reps=5):
    """Drive each path once cold with the launch counts set to 0 just
    before it and read just after, then ``reps`` warm solves and one
    profiled; check the iterations against the JAX package's within 1,
    the true relative residual below tol (S1's preconditioned one below
    tol and its true one at most twice ``jax_s1_relres``, the JAX
    package's), the kernels the path runs and no CG warning.  Returns
    {name: launches per kernel}."""
    import warnings
    import torch
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import sell_kernels as sk
    kernels = dk.KERNELS + sk.KERNELS
    out = {}
    for name, what, run, S, b, tol, must, M in paths:
        dk.reset_launch_counts()
        sk.reset_launch_counts()
        res = []
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            x, info = run(res)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        per_op = {k.__name__: dict(getattr(k, "by_op", None) or k.by_plan)
                  for k in kernels if k.launches}
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        r = b - S @ x.astype(np.float64)
        relres = float(np.linalg.norm(r) / np.linalg.norm(b))
        gated = relres if M is None else \
            float(np.linalg.norm(M(r)) / np.linalg.norm(M(b)))
        its = info if name == "S6" else len(res) - 1
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run([])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"solvers: {name} {what}: iterations {its} (JAX package "
              f"{jax_counts[name]}), info {info}, true_relres {relres:.3e}"
              + ("" if M is None else f" (JAX package "
                 f"{jax_s1_relres:.3e}), preconditioned {gated:.3e}") +
              f" (tol {tol:g}), warnings {[str(w.message)[:60] for w in warned]}"
              f", cold {cold:.3f} s, warm median of {reps} "
              f"{statistics.median(walls) * 1e3:.3f} ms (all "
              f"{[round(w * 1e3, 3) for w in walls]}), launches per solve "
              f"{launches}, per operator {per_op}")
        print_profile(name, *profiled(lambda: run([])), phase="solvers")
        want = jax_counts[name]
        if name == "S6":
            check(its[0] == want[0] and len(its[1]) == len(want[1]) and
                  all(abs(a - c) <= 1 for a, c in zip(its[1], want[1])),
                  f"{name}: iterations {its} differ from the JAX package's "
                  f"{want} by more than 1")
        else:
            check(abs(its - want) <= 1, f"{name}: {its} iterations, the JAX "
                                        f"package {want}")
        check(x.shape == b.shape and np.isfinite(x).all() and gated < tol,
              f"{name}: true relative residual {gated:.3e} not below {tol}")
        check(M is None or relres <= 2 * jax_s1_relres,
              f"{name}: true relative residual {relres:.3e} above twice the "
              f"JAX package's {jax_s1_relres:.3e}")
        check(all(launches[k] > 0 for k in must) and
              all(v == 0 for k, v in launches.items() if k not in must),
              f"{name}: launches {launches}, expected exactly {must}")
        check(name != "S3" or not warned, f"{name} raised a warning")
        out[name] = launches
    return out


def main():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import ds as dsm
    from pyamg_tpu_torch.ops import sell_kernels as sk
    from pyamg_tpu_torch.sparse import sell as sellm
    from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gs_order,
                                                       make_coloring)
    from pyamg_tpu_torch.sparse.matrix import (DIA, DIA_TILE, dia_from_ell,
                                               to_scipy)
    from pyamg_tpu_torch.gallery import poisson

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for name, built in build_kernels().items():
        print(f"device: {name} build {built['seconds']:.1f} s -> "
              f"{built['path']}")
        for kname, regs, smem, frame, st, ld in ptxas_report(built["log"]):
            print(f"device: ptxas {name} {kname}: {regs} registers, {smem} "
                  f"bytes static shared memory, stack frame {frame} B, spill "
                  f"stores {st} B, spill loads {ld} B")
    print(f"device: kernels built in {time.perf_counter() - t0:.1f} s")

    # -- 2. kernels against their plain versions ---------------------------
    _, ml_k, _ = build_hierarchy(500, 0, dev, ds=False)
    t0 = time.perf_counter()
    _, ml_s = build_sa3d(64)
    ml_s.to_device(dev)
    print(f"kernels: 64^3 setup+compress+place {time.perf_counter() - t0:.2f}"
          f" s")
    kernel_inputs = {}
    k1_capacity = dk._lib().spmv_capacity

    def k1_case(name, band, offsets, n, dtype, cols=1, x=None):
        """K1 once against its plain version to 0 (non-finite at the same
        places), one launch: (data, x, error)."""
        data = band if isinstance(band, torch.Tensor) else \
            torch.as_tensor(np.asarray(band), device=dev)
        data = data.to(dtype)
        shape = (n,) if cols == 1 else (n, cols)
        if x is None:
            x = torch.as_tensor(rng.standard_normal(shape),
                                device=dev).to(dtype)
        before = dk.dia_spmv.launches
        y = dk.dia_spmv(data, offsets, n, x)
        launched = dk.dia_spmv.launches - before
        want = dk.dia_spmv_plain(data, offsets, n, x)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        err = float((y[fin] - want[fin]).abs().max())
        same = same_non_finite(y, want)
        g = dk.spmv_geometry(n, cols, data.shape[1], data.element_size(),
                             sms)
        print(f"kernels: K1 {name} {str(dtype)[6:]} x {tuple(x.shape)} "
              f"ndiag={len(offsets)} npad={data.shape[1]} {g} launches "
              f"{launched} non-finite {int((~fin).sum())} same places "
              f"{same} max_abs_err={err:.3e}")
        check(y.shape == want.shape and same and err == 0 and launched == 1,
              f"K1 {name} {dtype} disagrees with its plain version or took "
              f"{launched} launches")
        return data, x, err

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P2048 = poisson((2048, 2048)).astype(np.float32)
    big = dia_from_ell(P2048)
    k1_ops = {"500^2 level 0": ml_k.levels[0].A,
              "500^2 level 1": ml_k.levels[1].A,
              "64^3 A0": ml_s.levels[0].A, "2048^2": big}
    for name, D in k1_ops.items():
        for dtype in (torch.float32, torch.float64):
            data, x, err = k1_case(name, D.data, D.offsets, D.shape[0],
                                   dtype)
            if dtype == torch.float32:
                kernel_inputs[f"K1 {name}"] = (D, data, x, err)
            if name == "500^2 level 0":
                k1_case(f"{name}, x with inf and NaN", data, D.offsets,
                        D.shape[0], dtype, x=non_finite(x))
    D = ml_k.levels[0].A
    n = D.shape[0]
    for cols in (2, 3):
        k1_case("500^2 level 0", D.data, D.offsets, n, torch.float32, cols)
    xo = torch.as_tensor(rng.standard_normal(n + 1), device=dev).float()
    k1_case("500^2 level 0, x off a 16-byte boundary", D.data, D.offsets, n,
            torch.float32, x=xo[1:])
    # 80 diagonals, and more than the launch takes by value (the offsets
    # from device memory)
    wide = tuple(sorted(rng.choice(np.arange(-3000, 3001), 80,
                                   replace=False).tolist()))
    wider = tuple(sorted(rng.choice(np.arange(-30_000, 30_001),
                                    k1_capacity + 1, replace=False).tolist()))
    wider_band = rng.standard_normal((len(wider), 8_192), dtype=np.float32)
    for dtype in (torch.float32, torch.float64):
        k1_case("80 diagonals", rng.standard_normal((80, 250_000)), wide,
                250_000, dtype)
        k1_case(f"{len(wider)} diagonals, past the {k1_capacity} by value",
                wider_band, wider, 8_000, dtype)
        # npad not a multiple of 4, n not a multiple of the rows a thread
        k1_case("npad 250,001, n 249,999", rng.standard_normal((5, 250_001)),
                D.offsets, 249_999, dtype)
        k1_case("one-sided band", rng.standard_normal((4, 262_144)),
                (-1500, -40, -1, 0), 262_144, dtype)

    def dia_level(lvl):
        """(DIA, colors, ncolors, Dinv) of a level's presmoother."""
        _, sopts, params = lvl.pre
        return lvl.A, params["colors"], sopts["ncolors"], params["Dinv"]

    colors_b, nc_b = make_coloring(P2048)
    k2_ops = {"500^2 level 0": dia_level(ml_k.levels[0]),
              "500^2 level 1": dia_level(ml_k.levels[1]),
              "64^3 A0": dia_level(ml_s.levels[0]),
              "2048^2": (big, colors_b, nc_b, dinv_vec(P2048))}

    def k2_case(name, D, colors, nc, Dinv):
        """K2 symmetric, omega 1 and 0.8, float32 and float64, on an x
        holding inf and NaN and on a 2-column x, each against the plain
        version to 0: (DIA, data, x, b, Dinv, colors, order, error) of
        float32, omega 1."""
        n, nd = D.shape[0], len(D.offsets)
        col = torch.as_tensor(colors, device=dev)
        halo = max(abs(o) for o in D.offsets)
        first = None
        for dtype in (torch.float32, torch.float64):
            data = torch.as_tensor(D.data, device=dev).to(dtype)
            Di = torch.as_tensor(Dinv, device=dev).to(dtype)
            x = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            b = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            print(f"kernels: K2 {name} {str(dtype)[6:]} n={n} ndiag={nd} "
                  f"{dk.gs_geometry(n, nd, halo, data.element_size(), sms)}")
            for omega in (1.0, 0.8):
                order = gs_order(nc, "symmetric", 1, omega)
                got = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col,
                                      order, omega)
                want = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Di,
                                             col, order, omega)
                torch.cuda.synchronize()
                err, _ = rel_err(got, want)
                print(f"kernels: K2 {name} {str(dtype)[6:]} omega={omega} "
                      f"order={order} max_abs_err={err:.3e}")
                check(err == 0, f"K2 {name} {dtype} omega={omega} disagrees "
                                f"with its plain version")
                if first is None:
                    first = (D, data, x, b, Di, col, order, err)
            order = gs_order(nc, "symmetric", 1, 1.0)
            xn = non_finite(x)
            got = dk.dia_gs_sweep(data, D.offsets, n, xn, b, Di, col, order)
            want = dk.dia_gs_sweep_plain(data, D.offsets, n, xn, b, Di, col,
                                         order, 1.0)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max())
            print(f"kernels: K2 {name} {str(dtype)[6:]} x with inf and NaN: "
                  f"{int((~fin).sum())} non-finite, same places "
                  f"{same_non_finite(got, want)}, max_abs_err={err:.3e}")
            check(same_non_finite(got, want) and err == 0,
                  f"K2 {name} {dtype} disagrees with its plain version on an "
                  f"x holding inf and NaN")
        _, data, _, _, Di, _, order, _ = first
        x2 = torch.as_tensor(rng.standard_normal((n, 2)), device=dev).float()
        b2 = torch.as_tensor(rng.standard_normal((n, 2)), device=dev).float()
        got = dk.dia_gs_sweep(data, D.offsets, n, x2, b2, Di, col, order)
        want = dk.dia_gs_sweep_plain(data, D.offsets, n, x2, b2, Di, col,
                                     order, 1.0)
        torch.cuda.synchronize()
        err, _ = rel_err(got, want)
        print(f"kernels: K2 {name} float32 x {tuple(x2.shape)} "
              f"max_abs_err={err:.3e}")
        check(got.shape == (n, 2) and err == 0,
              f"K2 {name} disagrees with its plain version on a 2-column x")
        return first

    for name, op in k2_ops.items():
        kernel_inputs[f"K2 {name}"] = k2_case(name, *op)

    def k2_pairs(name, D, colors, nc, Dinv, pairs):
        """K2 for each (omega, sweep) of ``pairs`` in float32 and float64
        against the plain version to 0, with its launch shape."""
        n = D.shape[0]
        col = torch.as_tensor(colors, device=dev)
        halo = max(abs(o) for o in D.offsets)
        for dtype in (torch.float32, torch.float64):
            data = torch.as_tensor(D.data, device=dev).to(dtype)
            Di = torch.as_tensor(Dinv, device=dev).to(dtype)
            x = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            b = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            g = dk.gs_geometry(n, len(D.offsets), halo, data.element_size(),
                               sms)
            for omega, sweep in pairs:
                order = gs_order(nc, sweep, 1, omega)
                got = dk.dia_gs_sweep(data, D.offsets, n, x, b, Di, col,
                                      order, omega)
                want = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Di,
                                             col, order, omega)
                torch.cuda.synchronize()
                err, _ = rel_err(got, want)
                print(f"kernels: K2 {name} {str(dtype)[6:]} n={n} "
                      f"omega={omega} sweep={sweep} order={order} {g} "
                      f"max_abs_err={err:.3e}")
                check(err == 0, f"K2 {name} {dtype} omega={omega} {sweep} "
                                f"disagrees with its plain version")

    # the (omega, sweep) pairs of the solvers phase: SOR symmetric with
    # omega 1.2 on the 500^2 levels (S2, float64), forward and backward on
    # 64^3 A0 (S6, float32); each pair on each operator in both dtypes
    for name in ("500^2 level 0", "500^2 level 1", "64^3 A0"):
        k2_pairs(name, *k2_ops[name], SOLVER_K2_PAIRS)

    # the solvers phase's uncollapsed float64 500^2 hierarchies run K1 and
    # K2 on the small DIA levels below the main path's dense tail too: K1
    # in both dtypes and K2 symmetric with omega 1 (GS) and 1.2 (S2's SOR)
    _, ml_k64, _ = build_hierarchy(500, 0, dev, ds=False, dtype=np.float64)
    for i in range(2, len(ml_k64.levels) - 1):
        D = ml_k64.levels[i].A
        check(isinstance(D, DIA), f"500^2 float64 level {i} is not a DIA")
        for dtype in (torch.float32, torch.float64):
            k1_case(f"500^2 float64 level {i}", D.data, D.offsets,
                    D.shape[0], dtype)
        k2_pairs(f"500^2 float64 level {i}", *dia_level(ml_k64.levels[i]),
                 ((1.0, "symmetric"), (1.2, "symmetric")))
    del ml_k64

    def random_band(n, offsets, scale):
        """(DIA, colors, 4, Dinv): random entries times ``scale`` on
        ``offsets``, 4 on the main diagonal, 4 random colors."""
        data = np.zeros((len(offsets), -(-n // DIA_TILE) * DIA_TILE),
                        np.float32)
        data[:, :n] = rng.standard_normal((len(offsets), n)) * scale
        data[offsets.index(0), :n] = 4.0
        return (DIA(data, tuple(offsets), (n, n)),
                rng.integers(0, 4, n).astype(np.int32), 4,
                np.full(n, 0.25, np.float32))

    # K2 in the staged regime on a one-sided band (a block waits for blocks
    # that do not read its rows) and on 80 diagonals (the kernel for any
    # width), 7 and 8 passes
    wide80 = sorted({0, *rng.choice(np.arange(-250, 251), 79,
                                    replace=False).tolist()})
    while len(wide80) < 80:
        wide80 = sorted({*wide80, int(rng.integers(-250, 251))})
    for name, op in (("one-sided band",
                      random_band(262_144, [-1500, -40, -1, 0], 1.0)),
                     ("80 diagonals", random_band(30_000, wide80, 0.02))):
        D, n = op[0], op[0].shape[0]
        halo = max(abs(o) for o in D.offsets)
        check(all(dk.gs_geometry(n, len(D.offsets), halo, item, sms).staged
                  for item in (4, 8)),
              f"K2's {name} case is not in the staged regime")
        k2_case(name, *op)

    a = torch.as_tensor(rng.standard_normal(1 << 20), device=dev).float()
    c = torch.as_tensor(rng.standard_normal(1 << 20), device=dev).float()
    p, e = dsm.two_prod(a, c)
    exact = p.double() + e.double() == a.double() * c.double()
    print(f"kernels: two_prod exact on {int(exact.sum())}/{exact.numel()}")
    check(bool(exact.all()), "double-single two_prod is not exact on the "
                             "card (a fused multiply-add crept in)")

    # K3 on every SELL operator of the 64^3 path, K5 on its square levels
    sell_ops = sell_operators(ml_s)
    check(sorted(sell_ops) == sorted(SELL_64),
          f"SELL operators {sorted(sell_ops)} at 64^3")
    for name, (S, _) in sell_ops.items():
        x = torch.as_tensor(rng.standard_normal(S.shape[1]),
                            device=dev).float()
        y = sk.sell_spmv(S, x)
        want = sk.sell_spmv_plain(S, x)
        xn = non_finite(x)
        yn, wantn = sk.sell_spmv(S, xn), sk.sell_spmv_plain(S, xn)
        torch.cuda.synchronize()
        err, scale = rel_err(y, want)
        tol = 1e-6 * scale
        fin = torch.isfinite(wantn)
        errn = float((yn[fin] - wantn[fin]).abs().max())
        print(f"kernels: K3 {name} {S.kind}/{S.t} {S.shape} passes "
              f"{S.n_passes} K={S.K} Sy={S.Sy} "
              f"{sk.spmv_geometry(S.n_passes, S.shape[0])} "
              f"max_abs_err={err:.3e} tol={tol:.3e}; x with inf and NaN: "
              f"{int((~fin).sum())} non-finite, same places "
              f"{same_non_finite(yn, wantn)}, max_abs_err={errn:.3e}")
        check(err <= tol, f"K3 {name} disagrees with its plain version")
        check(same_non_finite(yn, wantn) and errn <= tol,
              f"K3 {name} disagrees with its plain version on an x holding "
              f"inf and NaN")
        kernel_inputs[f"K3 {name}"] = (S, x, err)

    t0 = time.perf_counter()
    big_s = sellm.sell_from_ell(poisson((1800, 1800)).astype(np.float32))
    t_plan = time.perf_counter() - t0
    check(big_s is not None and big_s.square and
          big_s.x_rows * sellm.LANE * 4 > sellm._VMEM_X_BUDGET,
          "the 1800^2 plan is not a square SELL in the K4 regime")
    big_sd = big_s.to(dev)
    x = torch.as_tensor(rng.standard_normal(big_s.shape[1]),
                        device=dev).float()
    y = sk.sell_spmv(big_sd, x)
    want = sk.sell_spmv_plain(big_sd, x)
    torch.cuda.synchronize()
    err, scale = rel_err(y, want)
    print(f"kernels: K4 regime 1800^2 plan {t_plan:.2f} s, passes "
          f"{big_s.n_passes} K={big_s.K} Sy={big_s.Sy}, x "
          f"{big_s.x_rows * sellm.LANE * 4 / 2**20:.1f} MiB in the "
          f"reference's layout (VMEM budget "
          f"{sellm._VMEM_X_BUDGET / 2**20:.0f} MiB) max_abs_err={err:.3e} "
          f"tol={1e-6 * scale:.3e}")
    check(err <= 1e-6 * scale, "K3 in the K4 regime disagrees with its "
                               "plain version")
    kernel_inputs["K4"] = (big_sd, big_s, x, err)

    def k5_case(name, S, Dinv, nonfinite):
        """K5 forward, backward and symmetric, omega 1 and 0.8, against the
        plain version (and, with ``nonfinite``, forward and backward on an
        x holding inf and NaN): (S, x, b, Dinv, error of forward, omega 1)."""
        n = S.shape[0]
        x = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        b = torch.as_tensor(rng.standard_normal(n), device=dev).float()
        print(f"kernels: K5 {name} n={n} passes {S.n_passes} "
              f"{sk.gs_geometry(S.n_passes, S.Sy * sellm.LANE)}")
        first = None
        for sweep in ("forward", "backward", "symmetric"):
            for omega in (1.0, 0.8):
                got = sk.sell_gs_sweep(S, x, b, Dinv, omega, sweep)
                want = sk.sell_gs_sweep_plain(S, x, b, Dinv, omega, sweep)
                torch.cuda.synchronize()
                err, scale = rel_err(got, want)
                tol = 1e-5 * scale
                print(f"kernels: K5 {name} {sweep} omega={omega} "
                      f"max_abs_err={err:.3e} tol={tol:.3e}")
                check(err <= tol, f"K5 {name} {sweep} disagrees with its "
                                  f"plain version")
                first = err if first is None else first
        for sweep in ("forward", "backward") if nonfinite else ():
            xn = non_finite(x)
            got = sk.sell_gs_sweep(S, xn, b, Dinv, 1.0, sweep)
            want = sk.sell_gs_sweep_plain(S, xn, b, Dinv, 1.0, sweep)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) if fin.any() \
                else 0.0
            print(f"kernels: K5 {name} {sweep} x with inf and NaN: "
                  f"{int((~fin).sum())} non-finite, same places "
                  f"{same_non_finite(got, want)}, max_abs_err={err:.3e}")
            check(same_non_finite(got, want) and
                  err <= 1e-5 * float(want[fin].abs().max()),
                  f"K5 {name} {sweep} disagrees with its plain version on "
                  f"an x holding inf and NaN")
        return S, x, b, Dinv, first

    for name in ("A1", "A2"):
        S, _ = sell_ops[name]
        Dinv = ml_s.levels[int(name[1])].pre[2]["Dinv"]
        kernel_inputs[f"K5 {name}"] = k5_case(name, S, Dinv, True)

    # the (omega, sweep) pairs of the solvers phase (S6: SOR forward before
    # and backward after, omega 1.2) on A1 and A2, to 0
    for name in ("A1", "A2"):
        S, _ = sell_ops[name]
        Dinv = ml_s.levels[int(name[1])].pre[2]["Dinv"]
        x = torch.as_tensor(rng.standard_normal(S.shape[0]),
                            device=dev).float()
        b = torch.as_tensor(rng.standard_normal(S.shape[0]),
                            device=dev).float()
        for omega, sweep in SOLVER_K5_PAIRS:
            got = sk.sell_gs_sweep(S, x, b, Dinv, omega, sweep)
            want = sk.sell_gs_sweep_plain(S, x, b, Dinv, omega, sweep)
            torch.cuda.synchronize()
            err, _ = rel_err(got, want)
            print(f"kernels: K5 {name} {sweep} omega={omega} "
                  f"max_abs_err={err:.3e}")
            check(err == 0, f"K5 {name} {sweep} omega={omega} disagrees "
                            f"with its plain version")

    # K5 where x does not fit in shared memory, off the main path
    k5_case("1800^2 (off the main path)", big_sd, 1.0 / big_sd.diag, False)

    def k2_per_level(hier, tag):
        """{level: (K2 launches, color passes, passes a sweep)} of the DIA
        levels of ``hier`` from the counters of the last solve; fails
        unless every DIA level ran and each launch ran one whole sweep."""
        out = {}
        for i, lvl in enumerate(hier.levels):
            if not isinstance(lvl.A, DIA) or lvl.pre[0] != "gauss_seidel":
                continue
            key = (lvl.A.shape[0], len(lvl.A.offsets))
            per = {len(gs_order(so["ncolors"], so["sweep"], so["iterations"],
                                so["omega"])) for _, so, _ in (lvl.pre,
                                                               lvl.post)}
            out[f"{tag} level {i}"] = (dk.dia_gs_sweep.by_op[key],
                                       dk.dia_gs_sweep.passes[key],
                                       per.pop() if len(per) == 1 else None)
        check(out and all(l > 0 and (k is None or p == l * k)
                          for l, p, k in out.values()) and
              sum(l for l, _, _ in out.values()) ==
              dk.dia_gs_sweep.launches,
              f"K2 at {tag} is not one launch per sweep on every DIA level")
        return out

    def k1_per_level(hier, tag):
        """{level: K1 launches} of the DIA levels of ``hier`` from the
        counters of the last solve (keyed by operator, as the wrapper
        counts); fails unless every DIA level but the coarsest (solved
        directly) ran K1 and the levels add up to the kernel's total."""
        out = {f"{tag} level {i}": dk.dia_spmv.by_op[(lvl.A.shape[0],
                                                      len(lvl.A.offsets))]
               for i, lvl in enumerate(hier.levels) if isinstance(lvl.A, DIA)}
        last = f"{tag} level {len(hier.levels) - 1}"
        check(out and all(v > 0 for k, v in out.items() if k != last) and
              sum(out.values()) == dk.dia_spmv.launches,
              f"K1 at {tag} did not run on every DIA level, or its launches "
              f"per level do not add up to its total")
        return out

    # -- 3. main path --------------------------------------------------------
    dk.reset_launch_counts()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    A64, ml, (nlev_setup, oc) = build_hierarchy(500, 4096, dev)
    ml.to_device(dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    b = np.random.default_rng(SEED).standard_normal(A64.shape[0])
    it, res = {}, []
    t0 = time.perf_counter()
    x = ml.solve_refined_device(b, tol=1e-10, inner_tol=1e-5,
                                inner_maxiter=30, max_outer=10,
                                residuals=res, iterations_out=it)
    t_cold = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in dk.KERNELS}
    As = to_scipy(A64)
    relres = float(np.linalg.norm(b - As @ x) / np.linalg.norm(b))
    print(f"main: setup+prep {t_setup:.2f} s, cold solve {t_cold:.3f} s")
    print(f"main: levels {nlev_setup} active {len(ml.levels)} "
          f"operator_complexity {oc:.6f} outer {it['outer']} "
          f"inner {it['inner']} true_relres {relres:.3e} "
          f"residuals {res} launches {launches}")
    check(x.shape == (A64.shape[0],) and np.isfinite(x).all(),
          "x is not a finite vector of the right shape")
    check(nlev_setup == 6 and len(ml.levels) == 3,
          "expected 6 levels, 3 active")
    check(abs(oc - 1.2244) <= 1e-3, "operator complexity off 1.2244")
    check(it["outer"] == 2 and abs(it["inner"] - 12) <= 1,
          "expected 2 outer and 12 +- 1 inner iterations")
    check(relres < 1e-10, "true relative residual not below 1e-10")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    k2_500 = k2_per_level(ml, "500^2")
    k1_500 = k1_per_level(ml, "500^2")
    print(f"main: K1 launches per solve {launches['dia_spmv']}, per DIA "
          f"level {k1_500}; K2 launches per solve "
          f"{launches['dia_gs_sweep']}, per DIA level (launches, color "
          f"passes, passes a sweep) {k2_500}")

    # the same small solve on the card and on the CPU (plain versions)
    xs = {}
    for d in ("cuda", "cpu"):
        A64s, mls, _ = build_hierarchy(96, 600, d)
        mls.to_device(d)
        bs = np.random.default_rng(SEED).standard_normal(A64s.shape[0])
        xs[d] = mls.solve_refined_device(bs)
    diff = float(np.linalg.norm(xs["cuda"] - xs["cpu"]) /
                 np.linalg.norm(xs["cpu"]))
    print(f"main: 96^2 solve, card vs CPU relative difference {diff:.3e} "
          f"(tol 1e-9)")
    check(diff < 1e-9, "the card's solve disagrees with the CPU's")

    # -- 4. sa3d: 3-D Poisson 64^3, standard SA, SELL ----------------------
    t0 = time.perf_counter()
    A3, ml3 = build_sa3d(64)
    nlev3, oc3 = len(ml3.levels), ml3.operator_complexity()
    ml3.to_device(dev)
    torch.cuda.synchronize()
    t_setup3 = time.perf_counter() - t0
    lay = layout(ml3)
    plans = {k: (S.kind, S.t, S.n_passes, S.Sy)
             for k, (S, _) in sell_operators(ml3).items()}
    print(f"sa3d: setup+compress+place {t_setup3:.2f} s, levels {nlev3} "
          f"operator_complexity {oc3:.7f} layout {lay} plans {plans}")
    check(nlev3 == 4, "expected 4 levels at 64^3")
    check(abs(oc3 - 1.5504) <= 1e-3, "operator complexity off 1.5504")
    check(lay == LAYOUT_64 and plans == SELL_64,
          "the 64^3 layouts differ from the reference's")
    S3 = to_scipy(A3)
    b3 = np.random.default_rng(0).standard_normal(A3.shape[0])
    dk.reset_launch_counts()
    sk.reset_launch_counts()
    it3, res3 = {}, []
    t0 = time.perf_counter()
    x3 = ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg",
                           residuals=res3, iterations_out=it3)
    t_cold3 = time.perf_counter() - t0
    launches3 = {k.__name__: k.launches for k in dk.KERNELS + sk.KERNELS}
    relres3 = float(np.linalg.norm(b3 - S3 @ x3) / np.linalg.norm(b3))
    print(f"sa3d: cold solve_refined {t_cold3:.3f} s, outer {it3['outer']} "
          f"inner {it3['inner']} (JAX package {list(JAX_INNER_64)}) "
          f"true_relres {relres3:.3e} residuals {res3} launches "
          f"{launches3}")
    check(x3.shape == (A3.shape[0],) and np.isfinite(x3).all(),
          "x is not a finite vector of the right shape")
    check(it3["outer"] == 2, "expected 2 outer iterations")
    check(len(it3["inner"]) == len(JAX_INNER_64) and
          all(abs(a - b) <= 1 for a, b in zip(it3["inner"], JAX_INNER_64)),
          "inner CG iterations differ from the JAX package's by more than 1")
    check(relres3 < 1e-10, "true relative residual not below 1e-10")
    check(all(v > 0 for v in launches3.values()),
          "a kernel of the 64^3 path was never launched")
    # the same launches per operator (keyed by plan, as the wrappers count)
    ops3 = sell_operators(ml3)
    per_op3 = {k.__name__: {name: k.by_plan[sk.plan_key(S)]
                            for name, (S, _) in ops3.items()
                            if k is sk.sell_spmv or S.square}
               for k in sk.KERNELS}
    k2_64 = k2_per_level(ml3, "64^3")
    k1_64 = k1_per_level(ml3, "64^3")
    print(f"sa3d: launches per operator {per_op3}; K1 launches per solve "
          f"{launches3['dia_spmv']}, per DIA level {k1_64}; K2 launches per "
          f"solve {launches3['dia_gs_sweep']}, per DIA level (launches, "
          f"color passes, passes a sweep) {k2_64}")
    check(all(v > 0 for d in per_op3.values() for v in d.values()) and
          all(sum(per_op3[k.__name__].values()) == k.launches
              for k in sk.KERNELS),
          "a SELL operator of the 64^3 path was never launched, or the "
          "per-operator counts do not add up to the kernels' totals")

    # the same small solve on the card and on the CPU (plain versions)
    xs = {}
    for d in ("cuda", "cpu"):
        A24, ml24 = build_sa3d(24)
        ml24.to_device(d)
        b24 = np.random.default_rng(0).standard_normal(A24.shape[0])
        xs[d] = ml24.solve_refined(b24, A_fine=to_scipy(A24), tol=1e-10)
    diff = float(np.linalg.norm(xs["cuda"] - xs["cpu"]) /
                 np.linalg.norm(xs["cpu"]))
    print(f"sa3d: 24^3 solve, card vs CPU relative difference {diff:.3e} "
          f"(tol 1e-9)")
    check(diff < 1e-9, "the card's 24^3 solve disagrees with the CPU's")

    # -- 5. times -------------------------------------------------------------
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml.solve_refined_device(b)
        walls.append(time.perf_counter() - t0)
    print_profile("500^2", *profiled(lambda: ml.solve_refined_device(b)))

    cyc = ml._make_cycle("V")
    rv = torch.as_tensor(rng.standard_normal(A64.shape[0]),
                         device=dev).float()

    def vcycle():
        return cyc(torch.zeros_like(rv), rv)

    print(f"times: warm solve median of 5 "
          f"{statistics.median(walls) * 1e3:.3f} ms (all "
          f"{[round(w * 1e3, 3) for w in walls]}); V-cycle "
          f"{cuda_ms(vcycle, reps=50):.4f} ms per call, "
          f"{device_ms(vcycle, reps=10):.4f} ms of device time")

    # read before each timed kernel call, so that the call reads its inputs
    # from device memory as the bound assumes (5x the 50 MB L2)
    flush = torch.zeros(1 << 26, dtype=torch.float32, device=dev)
    skip = flush_ops(flush)

    def row(name, replaces, launches, err, fn, plain, library, nbytes, ops,
            source="pyamg_tpu_torch/csrc/dia_kernels.cu", plain_reps=50,
            tag=None):
        """A kernel's line: device times per call (profiler; the kernel's
        and the library call's the median of calls made with L2 flushed,
        and also their mean L2-warm), and its bound, the larger of bytes
        over the memory rate and float32 operations over the float32
        rate."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        cold = flushed_ms(fn, flush, skip)
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": statistics.median(cold),
             "plain_ms": device_ms(plain, plain_reps),
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None if library is None else
             statistics.median(flushed_ms(library, flush, skip))}
        lib = "-" if library is None else \
            f"{r['library_ms'] * 1e3:.2f} us (L2 flushed, median; " \
            f"{device_ms(library) * 1e3:.2f} us L2-warm)"
        print(f"times: {tag or name} device {r['ms'] * 1e3:.2f} us per call "
              f"with L2 flushed (median; {min(cold) * 1e3:.2f}-"
              f"{max(cold) * 1e3:.2f} us over {len(cold)} calls), "
              f"{device_ms(fn) * 1e3:.2f} us L2-warm "
              f"({cuda_ms(fn) * 1e3:.2f} us per call with the host), bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, "
              f"{nbytes / 1e6:.2f} MB), plain {r['plain_ms'] * 1e3:.2f} us "
              f"(L2-warm), library {lib}, launches on the main path "
              f"{launches}")
        return r

    # K1 on each DIA operator, launches per solve from each path's cold
    # solve (2048^2 is off both paths); the library call is torch.sparse's
    # CSR product of the same operator
    k1_launches = {"500^2 level 0": k1_500["500^2 level 0"],
                   "500^2 level 1": k1_500["500^2 level 1"],
                   "64^3 A0": k1_64["64^3 level 0"], "2048^2": 0}
    rows = []
    for name in k1_ops:
        D, data, xk, err1 = kernel_inputs[f"K1 {name}"]
        n, nd = D.shape[0], len(D.offsets)
        Acsr = csr_on(to_scipy(DIA(data.cpu().numpy(), D.offsets, D.shape)),
                      dev)
        e_lib, scale = rel_err(Acsr @ xk,
                               dk.dia_spmv_plain(data, D.offsets, n, xk))
        check(e_lib <= 1e-5 * scale, f"library CSR product disagrees ({name})")
        g = dk.spmv_geometry(n, 1, data.shape[1], 4, sms)
        off_path = name == "2048^2"
        rows.append(row(
            f"dia_spmv {name}" + (" (off the main path)" if off_path else ""),
            "pyamg_tpu/ops/pallas_kernels.py:52", k1_launches[name], err1,
            lambda: dk.dia_spmv(data, D.offsets, n, xk),
            lambda: dk.dia_spmv_plain(data, D.offsets, n, xk),
            lambda: Acsr @ xk,
            # the band's rows, x read once and y written once
            (nd * n + 2 * n) * 4, 2 * nd * n,
            plain_reps=5 if off_path else 50,
            tag=f"dia_spmv {name} ({nd} diagonals, {g})"))

    # K2 on each DIA operator, launches per solve from each path's cold
    # solve (2048^2 is off both paths)
    k2_launches = {"500^2 level 0": k2_500["500^2 level 0"][0],
                   "500^2 level 1": k2_500["500^2 level 1"][0],
                   "64^3 A0": k2_64["64^3 level 0"][0], "2048^2": 0}
    for name in k2_ops:
        D, data, xg, bg, Dinv, colors, order, err2 = \
            kernel_inputs[f"K2 {name}"]
        n, nd = D.shape[0], len(D.offsets)
        # each pass updates only the rows of its color: 2 flops per stored
        # diagonal and 3 for the update
        per_color = torch.bincount(colors.long()).tolist()
        off_path = name == "2048^2"
        g = dk.gs_geometry(n, nd, max(abs(o) for o in D.offsets), 4, sms)
        rows.append(row(
            f"dia_gs_sweep {name}" + (" (off the main path)" if off_path
                                      else ""),
            "pyamg_tpu/ops/pallas_kernels.py:126", k2_launches[name], err2,
            lambda: dk.dia_gs_sweep(data, D.offsets, n, xg, bg, Dinv, colors,
                                    order),
            lambda: dk.dia_gs_sweep_plain(data, D.offsets, n, xg, bg, Dinv,
                                          colors, order, 1.0),
            None,
            # each input (data, b, Dinv, colors, x) read once, x written once
            (nd * n + 4 * n) * 4 + 4 * n,
            sum(per_color[c] for c in order) * (2 * nd + 3),
            plain_reps=5 if off_path else 50,
            tag=f"dia_gs_sweep {name} ({len(order)} passes, {g})"))

    # the 64^3 path: warm solves, one profiled, then K3-K5 at its shapes
    walls3 = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml3.solve_refined(b3, A_fine=S3, tol=1e-10, accel="cg")
        walls3.append(time.perf_counter() - t0)
    print(f"times: 64^3 warm solve_refined median of 5 "
          f"{statistics.median(walls3) * 1e3:.3f} ms (all "
          f"{[round(w * 1e3, 3) for w in walls3]})")
    print_profile("64^3", *profiled(lambda: ml3.solve_refined(
        b3, A_fine=S3, tol=1e-10, accel="cg")), top=16)

    sell_src = "pyamg_tpu_torch/csrc/sell_kernels.cu"

    def slot_model(S, vectors_bytes, tag):
        """Print the bytes of the plan's padded slots beside the bound."""
        T, Sy, _ = S.vals.shape
        nbytes = T * Sy * sellm.LANE * 8 + vectors_bytes
        print(f"times: {tag} plan-slot byte model ({T * Sy * sellm.LANE} "
              f"slots for {S.nnz} stored entries): "
              f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us ({nbytes / 1e6:.2f} "
              f"MB)")

    def sell_row(name, replaces, S, S_scipy, x, err, tag, launches):
        """K3/K4 at one operator: bound from its stored entries (value and
        column each), x read and y written; 2 flops per stored entry."""
        lib = csr_on(S_scipy, dev)
        e_lib, scale = rel_err(lib @ x, sk.sell_spmv_plain(S, x))
        check(e_lib <= 1e-5 * scale, f"library CSR product disagrees ({tag})")
        vectors = (S.shape[0] + S.shape[1]) * 4
        r = row(name, replaces, launches, err, lambda: sk.sell_spmv(S, x),
                lambda: sk.sell_spmv_plain(S, x), lambda: lib @ x,
                S.nnz * 8 + vectors, 2 * S.nnz, source=sell_src,
                plain_reps=5, tag=tag)
        slot_model(S, vectors, tag)
        return r

    for name, (S, S_host) in sell_operators(ml_s).items():
        _, x, err = kernel_inputs[f"K3 {name}"]
        rows.append(sell_row(
            f"sell_spmv {name}", "pyamg_tpu/ops/sell_kernels.py:29", S,
            to_scipy(S_host), x, err, f"sell_spmv {name}",
            per_op3["sell_spmv"][name]))
    # no square SELL past the TPU's 6 MB budget runs on either main path
    big_sd, big_s, xk4, err4 = kernel_inputs["K4"]
    rows.append(sell_row(
        "sell_spmv (K4 regime, 2-D Poisson 1800^2, off the main path)",
        "pyamg_tpu/ops/sell_kernels.py:108", big_sd,
        sellm.sell_to_scipy(big_s), xk4, err4, "sell_spmv K4 regime 1800^2",
        0))

    for name in ("A1", "A2"):
        S, xg, bg, Dinv, err5 = kernel_inputs[f"K5 {name}"]
        n = S.shape[0]
        tag = f"sell_gs_sweep {name} forward"
        # one directional sweep reads the stored entries, b, Dinv and x
        # once and writes x; 2 flops per stored entry and 3 per row for the
        # update
        rows.append(row(
            tag, "pyamg_tpu/ops/sell_kernels.py:241",
            per_op3["sell_gs_sweep"][name], err5,
            lambda: sk.sell_gs_sweep(S, xg, bg, Dinv, 1.0, "forward"),
            lambda: sk.sell_gs_sweep_plain(S, xg, bg, Dinv, 1.0, "forward"),
            None, S.nnz * 8 + 4 * n * 4, 2 * S.nnz + 3 * n,
            source=sell_src, plain_reps=2, tag=tag))
        slot_model(S, 4 * n * 4, tag)

    # -- 6. solvers: the rest of the solve phase -----------------------------
    t0 = time.perf_counter()
    paths = solver_paths(dev)
    print(f"solvers: setup+compress+place of the six paths "
          f"{time.perf_counter() - t0:.2f} s")
    solver_launches = solvers_phase(dev, paths, JAX_SOLVERS,
                                    JAX_S1_TRUE_RELRES)
    print(f"solvers: launches per solve {solver_launches}")
    del paths

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
