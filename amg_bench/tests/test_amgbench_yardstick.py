"""The yardstick's arithmetic: byte bounds against the port's kernel
table (PERF.md, "Bound" column), the busy/idle arithmetic, the roofline
share, the host-sync counter and the requests' generator."""

import os

import numpy as np
import pytest

from amg_bench.harness import core, trace
from amg_bench.harness.roofline import share
from amg_bench.yardstick.bounds import (bound_seconds, dia_gs_sweep_bytes,
                                        dia_spmv_bytes)


@pytest.mark.parametrize("n, ndiag, k1_us, k2_us", [
    (500 ** 2, 5, 2.09, 2.99),          # 500^2 level 0
    (167 ** 2, 9, 0.37, 0.47),          # 500^2 level 1
    (3163 ** 2, 5, 83.62, 119.46),      # 3163^2 level 0
    (1055 ** 2, 9, 14.62, 18.61),       # 3163^2 level 1
])
def test_dia_bounds_match_the_kernel_table(n, ndiag, k1_us, k2_us):
    assert round(bound_seconds(dia_spmv_bytes(n, ndiag, 4)) * 1e6, 2) == k1_us
    assert round(bound_seconds(dia_gs_sweep_bytes(n, ndiag, 4)) * 1e6,
                 2) == k2_us


def test_busy_is_the_union_of_intervals():
    assert trace.busy_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.busy_seconds([]) == 0


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    dev = [("k1", 0, 10), ("k2", 20, 30), ("k3", 31, 40)]
    host = [("outer", 0, 50), ("aten::item", 12, 19)]
    gaps = trace.idle_gaps(dev, host)
    assert gaps == [["aten::item", 10e-6], ["outer", 1e-6]]
    assert trace.top_device_ops(dev)[0] == ["k1", 10e-6]


def test_roofline_share_needs_every_launch_in_the_trace():
    rec = {"kernels": {"dia_spmv": {"by_op": {(250000, 5): 2},
                                    "itemsize": 4}},
           "profile": {"device_ops": [("void dia_spmv_kernel<float>", 0, 4),
                                      ("other", 4, 9),
                                      ("void dia_spmv_kernel<float>", 9, 13)]}}
    got = share(rec, "dia_spmv", ("dia_spmv_kernel",), dia_spmv_bytes,
                bound_seconds)
    assert got == pytest.approx(100 * 2 * 7e6 / 3.35e12 / 8e-6)
    rec["kernels"]["dia_spmv"]["by_op"] = {(250000, 5): 3}
    assert share(rec, "dia_spmv", ("dia_spmv_kernel",), dia_spmv_bytes,
                 bound_seconds) is None


def test_host_syncs_count_the_loops_read():
    class Graph:
        @staticmethod
        def read(tensors):
            return tensors

    def run():
        Graph.read([1])
        Graph.read([2])
    assert trace.host_syncs(run, Graph) == 2


def test_percentile_and_sample():
    p95 = core.load_module(os.path.join(core.BENCH_DIR, "metrics",
                                        "solve_p95_ms.py"), "p95").read
    assert p95({"window": {"walls": [i / 1e3 for i in range(1, 101)]}}) \
        == pytest.approx(95)
    assert p95({"window": {"walls": [3e-3]}}) == pytest.approx(3)
    kept = [i for i in range(100)
            if core.kept_solve({"check_every": 8}, 2 ** 31 + 3, i)]
    assert len(kept) in (12, 13) and all(b - a == 8 for a, b in
                                         zip(kept, kept[1:]))


@pytest.mark.parametrize("distribution", ["normal", "uniform"])
def test_requests_come_from_the_named_generator(distribution):
    traffic = {"grid": 6, "requests": {"generator": "rhs_pool",
                                       "distribution": distribution,
                                       "pool": 3}}
    a, b = core.requests(traffic, 2 ** 31 + 9), core.requests(traffic, 4)
    assert a(0).shape == (36,) and a(0) is a(3) and a(1) is not a(0)
    assert np.array_equal(a(4), core.requests(traffic, 2 ** 31 + 9)(1))
    assert not np.array_equal(a(0), b(0))
    if distribution == "uniform":
        assert 0 <= a(0).min() and a(0).max() < 1


@pytest.mark.parametrize("name, want", [("device.busy_ms_per_solve", 8.0),
                                        ("device.idle_share", 20.0)])
def test_device_readers(name, want):
    read = core.load_module(os.path.join(core.BENCH_DIR, "metrics",
                                         name + ".py"), name).read
    rec = {"profile": {"calls": 5, "busy_s": 0.040,
                       "device_stopped_s": 0.010}}
    assert read(rec) == pytest.approx(want)
    assert read({}) is None
    assert read({"profile": dict(rec["profile"], busy_s=0.0)}) is None
