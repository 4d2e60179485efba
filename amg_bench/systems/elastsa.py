"""The system of 2-D linear elasticity on the main path
(``configs/elasticity2d_sa.json``): PyAMG's operator and rigid-body modes
(``reference/elasticity.py`` assembles them; the program takes them as a
block operator), the program's smoothed-aggregation set-up with B and its
prep as the grid path runs it, and the comparison of what it answered
with the plain reference.  The window's entry, ``solve_refined_device``,
and the rest of the driving are the grid system's (``gridsa.py``)."""

import numpy as np
import torch

from amg_bench.reference import elasticity as ref
from amg_bench.systems import gridsa


class Cell(gridsa.Cell):
    """The program on this configuration and traffic."""

    profiled_calls = 2

    def setup(self, mark):
        from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
        from pyamg_tpu_torch.sparse.matrix import bell_from_scipy
        n, s = self.traffic["grid"], self.config["setup"]
        A, B = ref.operator(n)
        A64 = bell_from_scipy(A)
        del A
        A32 = A64.astype(np.float32)
        mark("operator")
        ml = smoothed_aggregation_solver(A32, B=B,
                                         max_coarse=s["max_coarse"])
        mark("hierarchy")
        self.desc = {"levels": len(ml.levels),
                     "rows": [int(l.A.shape[0]) for l in ml.levels],
                     "blocksize": [int(l.A.blocksize[0]) for l in ml.levels],
                     "nnz": [int(l.A.nnz) for l in ml.levels]}
        ml.compress_stencils()
        ml.collapse_coarse(max_n=s["collapse_max_n"], device=self.device)
        ml.enable_ds_refinement(A64, device=self.device)
        ml.to_device(self.device)
        mark("prep")
        self.ml = ml

    @staticmethod
    def reset_kernel_counts():
        pass

    @staticmethod
    def kernel_counts():
        """None of K1-K6 runs here; the block products are counted in the
        program's store (``bell.products``)."""
        return {}


class Control(gridsa.Control):
    """The control: the plain reference in the program's place, computed
    in float32 (the precision below the float64 answer that the
    configuration states, and no double-single outer residual), through
    the same window and comparison."""

    def setup(self, mark):
        s = self.config["setup"]
        levels = ref.hierarchy(self.traffic["grid"], np.float32,
                               max_coarse=s["max_coarse"])
        mark("hierarchy")
        self.desc = ref.describe(levels)
        self.solver = ref.Solver(levels, self.device, torch.float32,
                                 s["collapse_max_n"])
        mark("prep")


def compare(config, traffic, seed, desc, kept, device):
    """The numbers that decide ``correct``, each (name, value, limit,
    passed): the hierarchy against the reference's (levels, and the rows,
    block size and stored entries of each level: mismatches, exactly 0),
    the largest true relative residual of the kept answers (float64, the
    reference's own operator, each kept b as the solve was handed it; the
    limit is the traffic's tolerance), and the largest gaps between the
    program's outer and inner iterations and the float64 reference's on
    the first ``reference_solves`` kept right-hand sides."""
    s, lim = config["setup"], config["limits"]
    levels = ref.hierarchy(traffic["grid"], max_coarse=s["max_coarse"])
    want = ref.describe(levels)
    mismatches = abs(desc["levels"] - want["levels"]) + sum(
        a != b for k in ("rows", "blocksize", "nnz")
        for a, b in zip(desc[k], want[k]))
    A = levels[0]["A"]
    relres = max(ref.true_relres(A, b, x) for _, b, x, _ in kept)
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
