"""Right-hand sides for one caller solving against a fixed operator: a
pool of ``pool`` float64 vectors of grid^2 entries, b_k drawn from
(seed, k), and b_i = pool[i mod pool] handed to the i-th solve.  The pool
is drawn in set-up, so drawing stays out of the measured window.

Its parameters sit under the traffic's ``requests`` key:

    {"generator": "rhs_pool", "distribution": "normal", "pool": 128}

``distribution`` is one of ``DISTRIBUTIONS``: ``normal`` (standard
normal) or ``uniform`` (uniform on [0, 1), as PyAMG's README draws b)."""

import numpy as np

DISTRIBUTIONS = {"normal": lambda g, n: g.standard_normal(n),
                 "uniform": lambda g, n: g.random(n)}


def draw(seed, index, n_rows, distribution="normal"):
    """b_index of a run with ``seed``: a generator keyed by both, so that
    every seed gives its own stream and any b can be drawn again alone."""
    key = [int(seed) % 2 ** 64, int(index)]   # numpy takes no negative key
    return DISTRIBUTIONS[distribution](np.random.default_rng(key), n_rows)


class Stream:
    """The requests of a run: ``stream(i)`` is the b of solve i."""

    def __init__(self, traffic, seed):
        spec = traffic["requests"]
        n_rows = traffic["grid"] ** 2
        self.pool = [draw(seed, k, n_rows, spec["distribution"])
                     for k in range(spec["pool"])]

    def __call__(self, i):
        return self.pool[i % len(self.pool)]
