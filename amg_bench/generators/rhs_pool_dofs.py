"""Right-hand sides for one caller solving a system with several
unknowns a grid node against a fixed operator: as ``rhs_pool``, a pool of
``pool`` float64 vectors drawn by ``rhs_pool.draw`` from (seed, k), each
of ``dofs`` x grid^2 entries, and b_i = pool[i mod pool] handed to the
i-th solve.

Its parameters sit under the traffic's ``requests`` key:

    {"generator": "rhs_pool_dofs", "distribution": "normal", "pool": 16,
     "dofs": 2}"""

from amg_bench.generators.rhs_pool import draw


class Stream:
    """The requests of a run: ``stream(i)`` is the b of solve i."""

    def __init__(self, traffic, seed):
        spec = traffic["requests"]
        n_rows = spec["dofs"] * traffic["grid"] ** 2
        self.pool = [draw(seed, k, n_rows, spec["distribution"])
                     for k in range(spec["pool"])]

    def __call__(self, i):
        return self.pool[i % len(self.pool)]
