#!/usr/bin/env python3
"""Drive pyamg_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the CUDA kernels from ``pyamg_tpu_torch/csrc``;
2. kernels: K1 (banded SpMV) and K2 (multicolor Gauss-Seidel sweep) against
   their plain PyTorch versions at the main path's shapes, and the
   double-single ``two_prod`` against float64;
3. main path: 2-D Poisson 500^2, grid smoothed aggregation, stencil
   compression, dense coarse tail, double-single refinement, solved to
   1e-10 on the card with the kernels' launch counts read around it; then a
   96^2 solve on the card against the same solve on the CPU;
4. times after a warm-up: the warm solve (host clock); one warm solve
   under torch.profiler, broken down into device busy time, idle share,
   device operations, host syncs and kernels by device time; one V-cycle;
   and K1/K2 beside their byte bound, plain versions and library call
   (device time per call from torch.profiler, and CUDA events around
   back-to-back calls).

It then prints the kernel table as one JSON line and, last, the device
line.  Any failed check exits non-zero; without a CUDA device it exits
non-zero before printing a result.
"""

import json
import statistics
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
SEED = 2022


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


def device_ms(fn, reps=50):
    """Mean device milliseconds per call of ``fn``: the kernel intervals
    that torch.profiler records over ``reps`` calls, summed.  Unlike
    events around back-to-back calls, this leaves out the host's time
    between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / reps / 1e3


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


def build_hierarchy(N, max_n, device, ds=True):
    """The main path's setup on 2-D Poisson N^2: (A64, ml, levels and
    operator complexity of the hierarchy before the coarse collapse)."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    A64 = poisson((N, N))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    full = (len(ml.levels), ml.operator_complexity())
    ml.compress_stencils()
    if max_n:
        ml.collapse_coarse(max_n=max_n, device=device)
    if ds:
        ml.enable_ds_refinement(A64, device=device)
    return A64, ml, full


def main():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    from pyamg_tpu_torch.ops import dia_kernels as dk
    from pyamg_tpu_torch.ops import ds as dsm
    from pyamg_tpu_torch.relaxation.relaxation import gs_order
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell, to_scipy
    from pyamg_tpu_torch.gallery import poisson
    from torch.profiler import ProfilerActivity, profile

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
    built = dk.build()
    print(f"device: kernel build {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"device: ptxas {line.strip()}")

    # -- 2. kernels against their plain versions ---------------------------
    _, ml_k, _ = build_hierarchy(500, 0, dev, ds=False)
    kernel_inputs = {}
    K1_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}

    def k1_case(name, D, dtype):
        data = torch.as_tensor(np.asarray(D.data), device=dev).to(dtype)
        n = D.shape[0]
        x = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
        y = dk.dia_spmv(data, D.offsets, n, x)
        want = dk.dia_spmv_plain(data, D.offsets, n, x)
        torch.cuda.synchronize()
        err, scale = rel_err(y, want)
        tol = K1_RTOL[dtype] * scale
        print(f"kernels: K1 {name} {str(dtype)[6:]} n={n} "
              f"ndiag={len(D.offsets)} max_abs_err={err:.3e} tol={tol:.3e}")
        check(err <= tol, f"K1 {name} {dtype} disagrees with its plain "
                          f"version")
        return data, x, err

    big = dia_from_ell(poisson((2048, 2048)).astype(np.float32))
    for name, D in (("fine500", ml_k.levels[0].A),
                    ("level1", ml_k.levels[1].A), ("2048sq", big)):
        for dtype in (torch.float32, torch.float64):
            data, x, err = k1_case(name, D, dtype)
            if (name, dtype) == ("fine500", torch.float32):
                kernel_inputs["K1"] = (D, data, x, err)

    for lvl_i in (0, 1):
        lvl = ml_k.levels[lvl_i]
        D = lvl.A
        kind, sopts, params = lvl.pre
        n = D.shape[0]
        colors = torch.as_tensor(params["colors"], device=dev)
        for dtype, omega, rtol in ((torch.float32, 1.0, 1e-5),
                                   (torch.float64, 1.0, 1e-12),
                                   (torch.float32, 0.8, 1e-5)):
            order = gs_order(sopts["ncolors"], sopts["sweep"],
                             sopts["iterations"], omega)
            data = torch.as_tensor(np.asarray(D.data), device=dev).to(dtype)
            Dinv = torch.as_tensor(params["Dinv"], device=dev).to(dtype)
            x = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            b = torch.as_tensor(rng.standard_normal(n), device=dev).to(dtype)
            got = dk.dia_gs_sweep(data, D.offsets, n, x, b, Dinv, colors,
                                  order, omega)
            want = dk.dia_gs_sweep_plain(data, D.offsets, n, x, b, Dinv,
                                         colors, order, omega)
            torch.cuda.synchronize()
            err, scale = rel_err(got, want)
            tol = rtol * scale
            print(f"kernels: K2 level{lvl_i} {str(dtype)[6:]} omega={omega} "
                  f"n={n} ndiag={len(D.offsets)} order={order} "
                  f"max_abs_err={err:.3e} tol={tol:.3e}")
            check(err <= tol, f"K2 level{lvl_i} disagrees with its plain "
                              f"version")
            if (lvl_i, dtype, omega) == (0, torch.float32, 1.0):
                kernel_inputs["K2"] = (D, data, x, b, Dinv, colors, order,
                                       err)

    a = torch.as_tensor(rng.standard_normal(1 << 20), device=dev).float()
    c = torch.as_tensor(rng.standard_normal(1 << 20), device=dev).float()
    p, e = dsm.two_prod(a, c)
    exact = p.double() + e.double() == a.double() * c.double()
    print(f"kernels: two_prod exact on {int(exact.sum())}/{exact.numel()}")
    check(bool(exact.all()), "double-single two_prod is not exact on the "
                             "card (a fused multiply-add crept in)")

    # -- 3. main path --------------------------------------------------------
    dk.reset_launch_counts()
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
          f"(tol 1e-7)")
    check(diff < 1e-7, "the card's solve disagrees with the CPU's")

    # -- 4. times --------------------------------------------------------------
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml.solve_refined_device(b)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ml.solve_refined_device(b)
        wall_us = (time.perf_counter() - t0) * 1e6
    ops, syncs = [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name == "aten::_local_scalar_dense":
            syncs += 1
    busy = busy_us([(s, t) for _, s, t in ops])
    check(busy > 0, "the profiled solve ran nothing on the device")
    print(f"times: profiled warm solve wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}, "
          f"device ops {len(ops)}, host syncs {syncs}")
    by_name = {}
    for name, s, t in ops:
        c, d = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, d + (t - s))
    for name, (c, d) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:12]:
        print(f"times: device {d:9.1f} us = {c:5d} x {d / c:7.2f} us  "
              f"{name[:90]}")

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

    def row(name, replaces, launches, err, fn, plain, library, nbytes, ops):
        """A kernel's line: device times per call (profiler), and its
        bound, the larger of bytes over the memory rate and float32
        operations over the float32 rate."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        r = {"name": name, "route": "cuda",
             "source": "pyamg_tpu_torch/csrc/dia_kernels.cu",
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": device_ms(fn), "plain_ms": device_ms(plain),
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None if library is None else device_ms(library)}
        lib = "-" if library is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"times: {name} device {r['ms'] * 1e3:.2f} us per call "
              f"({cuda_ms(fn) * 1e3:.2f} us per call with the host), bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, launches on "
              f"the main path {launches}")
        return r

    D, data, xk, err1 = kernel_inputs["K1"]
    n, nd = D.shape[0], len(D.offsets)
    S = to_scipy(D).tocsr()
    Acsr = torch.sparse_csr_tensor(
        torch.as_tensor(S.indptr, dtype=torch.int64),
        torch.as_tensor(S.indices, dtype=torch.int64),
        torch.as_tensor(S.data, dtype=torch.float32), size=S.shape,
        device=dev)
    e_lib, scale = rel_err(Acsr @ xk,
                           dk.dia_spmv_plain(data, D.offsets, n, xk))
    check(e_lib <= 1e-5 * scale, "library CSR product disagrees")
    rows = [row("dia_spmv", "pyamg_tpu/ops/pallas_kernels.py:51",
                launches["dia_spmv"], err1,
                lambda: dk.dia_spmv(data, D.offsets, n, xk),
                lambda: dk.dia_spmv_plain(data, D.offsets, n, xk),
                lambda: Acsr @ xk,
                (nd * n + 2 * n) * 4, 2 * nd * n)]

    D, data, xg, bg, Dinv, colors, order, err2 = kernel_inputs["K2"]
    n, nd = D.shape[0], len(D.offsets)
    # each pass updates only the rows of its color: 2 flops per stored
    # diagonal and 3 for the update
    per_color = torch.bincount(colors.long()).tolist()
    rows.append(row(
        "dia_gs_sweep", "pyamg_tpu/ops/pallas_kernels.py:125",
        launches["dia_gs_sweep"], err2,
        lambda: dk.dia_gs_sweep(data, D.offsets, n, xg, bg, Dinv, colors,
                                order),
        lambda: dk.dia_gs_sweep_plain(data, D.offsets, n, xg, bg, Dinv,
                                      colors, order, 1.0),
        None,
        # each input (data, b, Dinv, colors, x) read once, x written once
        (nd * n + 4 * n) * 4 + 4 * n,
        sum(per_color[c] for c in order) * (2 * nd + 3)))
    per_pass = len(order) * ((nd * n + 4 * n) * 4 + 4 * n)
    print(f"times: dia_gs_sweep per-pass byte model ({len(order)} passes, "
          f"each reading the band, b, Dinv, colors and x and writing x): "
          f"{per_pass / HBM_BYTES_PER_S * 1e6:.2f} us")

    # K1 where data and x exceed the 50 MB L2 (2048^2, float32)
    data = torch.as_tensor(np.asarray(big.data), device=dev)
    xb = torch.as_tensor(rng.standard_normal(big.shape[0]),
                         device=dev).float()
    nb = big.shape[0]
    ms_big = device_ms(lambda: dk.dia_spmv(data, big.offsets, nb, xb))
    bytes_big = (len(big.offsets) * nb + 2 * nb) * 4
    print(f"times: dia_spmv 2048^2 f32 device {ms_big * 1e3:.2f} us, bound "
          f"{bytes_big / HBM_BYTES_PER_S * 1e6:.2f} us, "
          f"{bytes_big / (ms_big * 1e-3) / 1e9:.1f} GB/s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
