#!/usr/bin/env python3
"""Run the device-stopped solves that ``chip_smoke.py`` profiles under
``compute-sanitizer --tool memcheck`` on one CUDA card.

    python3 probes/sanitizer.py [--rounds 3] [--timeout 300] [--logs DIR]

Each case runs in its own process under the sanitizer (``--child CASE``),
with ``chip_smoke.py``'s setting ``TEARDOWN_CUPTI=1``:

- ``cupti``: the ``cupti:`` phase's solves (``chip_smoke.cupti_phase``:
  profiler sessions one after another, each around a device-stopped CG
  recorded afresh or a GMRES of restart 100 replayed, on the float64
  500^2 grid-SA hierarchy of the ``launch:`` phase), ``2 * rounds``
  sessions;
- ``unsharded``: the ``parallel:`` phase's unsharded float64 500^2 SA
  hierarchy, CG to 1e-8 device-stopped, ``rounds`` times plain and
  ``rounds`` times under torch.profiler;
- ``gspmd``: the same on the hierarchy sharded over a one-rank NCCL group
  (gspmd products), NCCL's collectives inside the CG's WHILE body.

Every round's x and history must equal the first's.  The kernels are
built once, before the first case, so that no case builds under the
sanitizer.  The sanitizer's whole output of each case goes to
``DIR/sanitizer_<case>.log`` (by default the git-ignored
``pyamg_tpu_torch/_build/sanitizer``); what it reported, the end of the
log and the case's exit code are printed.  Without ``compute-sanitizer`` in
the CUDA toolkit the probe says so and runs nothing.
"""

import argparse
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("cupti", "unsharded", "gspmd")


def sanitizer():
    """The path of compute-sanitizer in the CUDA toolkit, or None."""
    for path in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer",
                 "/usr/local/cuda/compute-sanitizer/compute-sanitizer"):
        if path and os.access(path, os.X_OK):
            return path
    return None


def child(case, rounds):
    """One case's solves, in this process (under the sanitizer)."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if case == "cupti":
        _, ml, _ = cs.build_hierarchy(500, 4096, dev, ds=False,
                                      dtype=np.float64)
        ml.to_device(dev)
        b = torch.as_tensor(np.random.default_rng(cs.SEED).standard_normal(
            ml.levels[0].A.shape[0]), device=dev)
        cs.cupti_phase(ml, b, rounds=2 * rounds)
        print(f"sanitizer: {case} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return
    import torch.distributed as dist
    want = cs.JAX_PARALLEL[500]
    if case == "unsharded":
        A, ml = cs.parallel_build(500, want, dev)
    else:
        from pyamg_tpu_torch.parallel import make_row_mesh
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
        A, ml = cs.parallel_build(500, want, dev, make_row_mesh(1, device=dev),
                                  spmv=case)
    b = np.random.default_rng(0).standard_normal(A.shape[0])

    def solve():
        res = []
        x = ml.solve(b, residuals=res, maxiter=100, tol=1e-8, accel="cg")
        return x, res

    try:
        x0, res0 = solve()
        for k in range(2 * rounds):
            got = []
            if k < rounds:
                got.extend(solve())
            else:
                cs.profiled(lambda: got.extend(solve()))
            torch.cuda.synchronize()
            cs.check(torch.equal(got[0], x0) and got[1] == res0,
                     f"{case} round {k} differs from the first solve")
            print(f"sanitizer: {case} round {k} "
                  f"({'profiled' if k >= rounds else 'plain'}) "
                  f"{len(got[1]) - 1} iterations, last residual "
                  f"{got[1][-1]:.6e}, {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_case(tool, case, rounds, timeout, out_dir):
    """One case under the sanitizer: prints what it reported; returns its
    exit code (or 'timeout')."""
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, f"sanitizer_{case}.log")
    cmd = [tool, "--tool", "memcheck", "--error-exitcode", "99",
           "--print-limit", "100", sys.executable, os.path.abspath(__file__),
           "--child", case, "--rounds", str(rounds)]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    seconds = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    summary = [ln for ln in text.splitlines() if "ERROR SUMMARY" in ln]
    # the sanitizer's own refusals (a device it does not support) and the
    # first line of each error it reports
    said = sorted({ln for ln in text.splitlines()
                   if ln.startswith(("========= Error",
                                     "========= Program hit",
                                     "========= Invalid"))})
    print(f"sanitizer: {case} under memcheck: exit {rc} after {seconds:.1f} "
          f"s, {summary[-1] if summary else 'no error summary'}; it said: "
          f"{said}; last lines of {os.path.relpath(log, ROOT)}:")
    for ln in text.splitlines()[-25:]:
        print(f"  {ln}")
    return rc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=CASES)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a case may take under the sanitizer")
    ap.add_argument("--logs", default=os.path.join(
        ROOT, "pyamg_tpu_torch", "_build", "sanitizer"),
                    help="directory of the sanitizer's logs")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.rounds)
        return
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    tool = sanitizer()
    if tool is None:
        print("sanitizer: compute-sanitizer is not in this CUDA toolkit; "
              "nothing run")
        return
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    print(f"sanitizer: {tool}: {version[-1] if version else '?'}")
    for name, built in cs.build_kernels().items():
        print(f"sanitizer: {name} built in {built['seconds']:.1f} s")
    rcs = {case: run_case(tool, case, args.rounds, args.timeout,
                          os.path.abspath(args.logs))
           for case in CASES}
    print(f"sanitizer: exit codes {rcs} (0: no error found; 99: the "
          f"sanitizer found one)")


if __name__ == "__main__":
    main()
