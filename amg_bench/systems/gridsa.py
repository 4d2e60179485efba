"""The system of the grid smoothed-aggregation main path
(``configs/poisson2d_gridsa.json``): the program's set-up and prep as the
JAX package's main path runs them, its ``solve_refined_device`` as the
window's entry, and the comparison of what it answered with the plain
reference (``reference/gridsa.py``)."""

import numpy as np
import torch

from amg_bench.reference import gridsa as ref
from amg_bench.reference.poisson import poisson2d, true_relres


class Cell:
    """The program on this configuration and traffic."""

    profiled_calls = 5

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.device = config, traffic, device

    def setup(self, mark):
        from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
        from pyamg_tpu_torch.gallery import poisson
        n, s = self.traffic["grid"], self.config["setup"]
        A64 = poisson((n, n))
        A32 = A64.astype(np.float32)
        mark("operator")
        ml = smoothed_aggregation_solver(A32, aggregate=("grid", {}),
                                         max_coarse=s["max_coarse"])
        mark("hierarchy")
        self.desc = {"levels": len(ml.levels),
                     "rows": [int(l.A.shape[0]) for l in ml.levels],
                     "nnz": [int(l.A.nnz) for l in ml.levels]}
        ml.compress_stencils()
        ml.collapse_coarse(max_n=s["collapse_max_n"], device=self.device)
        ml.enable_ds_refinement(A64, device=self.device)
        ml.to_device(self.device)
        mark("prep")
        self.ml = ml
        self.itemsize = np.dtype(A32.dtype).itemsize

    def solve(self, b):
        t = self.traffic
        res, it = [], {}
        x = self.ml.solve_refined_device(
            b, tol=t["tol"], inner_tol=t["inner_tol"],
            inner_maxiter=t["inner_maxiter"], max_outer=t["max_outer"],
            residuals=res, iterations_out=it)
        relres = float(res[-1]) / float(res[0])
        return x, {"inner": int(it["inner"]), "outer": int(it["outer"]),
                   "relres": relres, "ok": relres <= t["tol"]}

    @staticmethod
    def graph_module():
        from pyamg_tpu_torch import _graph
        return _graph

    def per_step(self):
        return self.graph_module().per_step()

    @staticmethod
    def reset_kernel_counts():
        from pyamg_tpu_torch.ops import dia_kernels as dk
        dk.reset_launch_counts()

    def kernel_counts(self):
        """{kernel: {"by_op": {(rows, diagonals): launches}, "itemsize"}}
        from the program's own counters."""
        from pyamg_tpu_torch.ops import dia_kernels as dk
        return {k.__name__: {"by_op": dict(k.by_op),
                             "itemsize": self.itemsize}
                for k in (dk.dia_spmv, dk.dia_gs_sweep)}

    @staticmethod
    def kept_to_host(kept):
        return kept

    def describe(self):
        return self.desc

    def free(self):
        self.ml = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class Control(Cell):
    """The control: the plain reference in the program's place, computed
    in float32 (the precision below the float64 answer that the
    configuration states), through the same window and comparison."""

    def setup(self, mark):
        n = self.traffic["grid"]
        levels = ref.hierarchy(n, np.float32,
                               max_coarse=self.config["setup"]["max_coarse"])
        mark("hierarchy")
        self.desc = ref.describe(levels)
        self.solver = ref.Solver(levels, self.device, torch.float32,
                                 self.config["setup"]["collapse_max_n"])
        mark("prep")

    def solve(self, b):
        t = self.traffic
        x, outer, inner = self.solver.solve(b, t["tol"], t["inner_tol"],
                                            t["inner_maxiter"],
                                            t["max_outer"])
        return x, {"inner": inner, "outer": outer, "relres": None,
                   "ok": True}

    def free(self):
        self.solver = None


def compare(config, traffic, seed, desc, kept, device):
    """The numbers that decide ``correct``, each (name, value, limit,
    passed): the hierarchy against the reference's (levels, rows and stored
    entries of each level: mismatches, exactly 0), the largest true
    relative residual of the kept answers (float64, the reference's own
    operator, each kept b as the solve was handed it; the limit is the
    traffic's tolerance), and the largest gaps between the program's outer
    and inner iterations and the reference's on the first
    ``reference_solves`` kept right-hand sides."""
    s, lim = config["setup"], config["limits"]
    n = traffic["grid"]
    levels = ref.hierarchy(n, max_coarse=s["max_coarse"])
    want = ref.describe(levels)
    mismatches = abs(desc["levels"] - want["levels"]) + sum(
        a != b for k in ("rows", "nnz") for a, b in zip(desc[k], want[k]))
    A = poisson2d(n)
    relres = max(true_relres(A, b, x) for _, b, x, _ in kept)
    solver = ref.Solver(levels, device, torch.float64, s["collapse_max_n"])
    outer_gap = inner_gap = 0
    for _, b, _, info in kept[:traffic["reference_solves"]]:
        _, outer, inner = solver.solve(
            b, traffic["tol"], traffic["inner_tol"], traffic["inner_maxiter"],
            traffic["max_outer"])
        outer_gap = max(outer_gap, abs(info["outer"] - outer))
        inner_gap = max(inner_gap, abs(info["inner"] - inner))
    numbers = [("hierarchy_mismatches", mismatches, 0),
               ("relres_max", relres, traffic["tol"]),
               ("outer_gap", outer_gap, lim["outer_gap"]),
               ("inner_gap", inner_gap, lim["inner_gap"])]
    return [(name, value, limit, bool(value <= limit))
            for name, value, limit in numbers]
