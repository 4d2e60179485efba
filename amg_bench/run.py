"""Run one cell of the benchmark of pyamg_tpu_torch once:

    python3 amg_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and
metrics are found by name through ``BENCHMARK.json``
(``amg_bench/harness/core.py``).  The last line of standard output is the
result as one JSON object; the numbers the comparison judged are the last
lines of standard error.  Exits non-zero, with no result, where the cell's
cards are missing, the program is not in the checkout, or JAX or the JAX
package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of the program and of PyTorch at fixed places inside the checkout
# (the port builds its kernels into pyamg_tpu_torch/_build by itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "amg_bench", "_cache", sub)
# torch.profiler detaches CUPTI after each traced section, so no launch after the
# traced section pays for it
os.environ.setdefault("TEARDOWN_CUPTI", "1")
# one process with few threads: the window's host work is one thread's
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)

from amg_bench.harness import core  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    result = core.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    return 0 if result is not None else 3


if __name__ == "__main__":
    sys.exit(main())
