"""The system of the distributed smoothed aggregation built on the card
(``configs/poisson2d_distsa.json``): a one-rank process group, the
program's row blocks of the grid and ``distributed_sa_setup`` as set-up,
``DistHierarchy.solve_cg`` as the window's entry, and the comparison of
what it answered with the plain reference (``reference/distsa.py``)."""

import numpy as np
import torch

from amg_bench.reference import distsa as ref
from amg_bench.reference.poisson import poisson2d, true_relres

STENCIL = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)


class Cell:
    """The program on this configuration and traffic."""

    profiled_calls = 2

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.group = False

    def setup(self, mark):
        import torch.distributed as dist
        from pyamg_tpu_torch.parallel import (dist_stencil_grid,
                                              distributed_sa_setup,
                                              make_row_mesh)
        s = self.config["setup"]
        cuda = self.device.type == "cuda"
        # one rank, its store in this process: no address, no network
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=s["ranks"],
                                **({"device_id": self.device} if cuda
                                   else {}))
        self.group = True
        mesh = make_row_mesh(s["ranks"], device=self.device)
        mark("group")
        n = self.traffic["grid"]
        cols, vals, ok, n_loc = dist_stencil_grid(STENCIL, (n, n), mesh,
                                                  dtype=torch.float32)
        hier = distributed_sa_setup(cols, vals, ok, n_loc, mesh,
                                    coarsen_until=s["coarsen_until"],
                                    smoother=s["smoother"])
        del cols, vals, ok
        mark("dist")
        self.desc = {"levels": len(hier.levels),
                     "rows": [int(L.n_loc) * s["ranks"] for L in hier.levels],
                     "nagg": [int(a) for a in hier.diagnostics["nagg"]]}
        self.hier = hier

    def solve(self, b):
        t = self.traffic
        x, relres, it = self.hier.solve_cg(b, tol=t["tol"],
                                           maxiter=t["maxiter"])
        return x, {"inner": int(it), "outer": None, "relres": float(relres),
                   "ok": float(relres) <= t["tol"]}

    @staticmethod
    def graph_module():
        from pyamg_tpu_torch import _graph
        return _graph

    def per_step(self):
        return self.graph_module().per_step()

    @staticmethod
    def reset_kernel_counts():
        pass

    @staticmethod
    def kernel_counts():
        return {}

    @staticmethod
    def kept_to_host(kept):
        return [(i, b, x.double().cpu().numpy(), info)
                for i, b, x, info in kept]

    def describe(self):
        return self.desc

    def free(self):
        self.hier = None
        if self.group:
            import torch.distributed as dist
            dist.destroy_process_group()
            self.group = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class Control(Cell):
    """The control: the plain reference in the program's place, its solve
    computed in bfloat16 (the precision below the float32 that the
    configuration states), through the same window and comparison."""

    def setup(self, mark):
        levels = ref.hierarchy(poisson2d(self.traffic["grid"]),
                               self.config["setup"]["coarsen_until"])
        mark("dist")
        self.desc = ref.describe(levels)
        self.solver = ref.Solver(levels, self.device, torch.bfloat16)

    def solve(self, b):
        x, it = self.solver.solve(b, self.traffic["tol"],
                                  self.traffic["maxiter"])
        return x, {"inner": it, "outer": None, "relres": None, "ok": True}

    @staticmethod
    def kept_to_host(kept):
        return kept

    def free(self):
        self.solver = None


def compare(config, traffic, seed, desc, kept, device):
    """The numbers that decide ``correct``, each (name, value, limit,
    passed): the hierarchy against the reference's (levels, rows of each
    level and the aggregates of level 0, which no value moves:
    mismatches, exactly 0), the largest true relative residual of the kept
    answers (float64, the reference's own operator), and the largest gap
    between the program's CG iterations and the reference's on the first
    ``reference_solves`` kept right-hand sides."""
    s, lim = config["setup"], config["limits"]
    n = traffic["grid"]
    A = poisson2d(n)
    relres = max(true_relres(A, b, x) for _, b, x, _ in kept)
    levels = ref.hierarchy(A, s["coarsen_until"], seed=int(seed) % 2 ** 32)
    want = ref.describe(levels)
    mismatches = abs(desc["levels"] - want["levels"]) + sum(
        a != b for a, b in zip(desc["rows"], want["rows"])) + \
        int(desc["nagg"][:1] != want["nagg"][:1])
    solver = ref.Solver(levels, device, torch.float64)
    it_gap = 0
    for _, b, _, info in kept[:traffic["reference_solves"]]:
        _, it = solver.solve(b, traffic["tol"], traffic["maxiter"])
        it_gap = max(it_gap, abs(info["inner"] - it))
    numbers = [("hierarchy_mismatches", mismatches, 0),
               ("relres_max", relres, lim["relres_max"]),
               ("iteration_gap", it_gap, lim["iteration_gap"])]
    return [(name, value, limit, bool(value <= limit))
            for name, value, limit in numbers]
