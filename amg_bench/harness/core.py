"""One run of one cell: find the cell's configuration, traffic and
metrics by name, set the system up, warm it, run the measured window,
read the metrics, judge the answers against the plain reference, and
print the result line.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the names in
``BENCHMARK.json``:

- ``amg_bench/configs/<config>.json``: the configuration, its ``system``
  (``amg_bench/systems/<system>.py``, the code that drives the program on
  it and the comparison's limits);
- ``amg_bench/traffic/<traffic>.json``: the traffic mix's parameters; its
  ``requests`` name their generator (``amg_bench/generators/<name>.py``,
  whose ``Stream(traffic, seed)`` gives the request of each solve);
- ``amg_bench/metrics/<metric>.py``: a reader ``read(rec)`` of one metric,
  end-to-end or per-layer, from the run's records, None where it finds
  nothing to read."""

import importlib.util
import json
import os
import statistics
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# modules that must not be loaded in a run: JAX, and the JAX package the
# port was made from (top-level names compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pyamg_tpu")
# the system under test: the PyTorch and CUDA port, from this checkout
PROGRAM = "pyamg_tpu_torch"


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path, name):
    """A module from a file under the benchmark, by path (names may hold
    dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench, workload):
    """(cell, configuration entry, per-layer metrics, end-to-end metrics)
    of ``workload`` in ``BENCHMARK.json``; a metric with a ``workloads``
    key belongs only to the cells it lists."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(cells: {sorted(cells)})")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return cell, config, mine(bench["per_layer"]), mine(bench["end_to_end"])


def requests(traffic, seed):
    """The traffic's requests from ``seed``: the ``Stream`` of the
    generator that its ``requests`` name, made in set-up."""
    name = traffic["requests"]["generator"]
    gen = load_module(os.path.join(BENCH_DIR, "generators", name + ".py"),
                      "amg_bench_generator_" + name)
    return gen.Stream(traffic, seed)


def kept_solve(traffic, seed, i):
    """Whether solve i is in the sample that the comparison judges: every
    ``check_every``-th solve from an offset drawn from the seed."""
    every = traffic["check_every"]
    return (i + int(seed) % every) % every == 0


def window(cell, b_of, traffic, seed, seconds):
    """The measured window: one caller solving b_0, b_1, ... back to back
    until ``seconds`` have passed; returns the per-solve walls, the
    iteration counts, the solves the program reported as not converged,
    the kept (index, b, x, info) of the answers to judge and the window's
    wall time."""
    walls, inner, failed, kept = [], [], 0, []
    start = time.perf_counter()
    i, last = 0, None
    while True:
        b = b_of(i)
        t0 = time.perf_counter()
        x, info = cell.solve(b)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        inner.append(info["inner"])
        failed += not info["ok"]
        if kept_solve(traffic, seed, i):
            kept.append((i, b, x, info))
        else:
            last = (i, b, x, info)
        i += 1
        if t1 - start >= seconds:
            break
    if last is not None and last[0] == i - 1:
        kept.append(last)
    return {"walls": walls, "inner": inner, "failed": failed, "kept": kept,
            "wall_s": time.perf_counter() - start}


def read_metrics(specs, rec):
    """{name: {"value", "unit"}} of the metrics (``amg_bench/metrics/
    <name>.py``) whose readers find something to read in ``rec``."""
    out = {}
    for m in specs:
        path = os.path.join(BENCH_DIR, "metrics", m["name"] + ".py")
        value = load_module(path, "amg_bench_metric_" + m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(torch, device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def load_cell(workload, traffic_override=None):
    """(cell entry, configuration, traffic, per-layer metrics, end-to-end
    metrics, the configuration's system module) of ``workload``."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell_entry, config_entry, per_layer, end_to_end = find_cell(bench,
                                                                workload)
    config = load_json(ROOT, config_entry["file"])
    traffic = load_json(BENCH_DIR, "traffic", cell_entry["traffic"] + ".json")
    traffic.update(traffic_override or {})
    system = load_module(os.path.join(BENCH_DIR, "systems",
                                      config["system"] + ".py"),
                         "amg_bench_system_" + config["system"])
    return cell_entry, config, traffic, per_layer, end_to_end, system


def pick_device(device, chips, err):
    """The device of a run: ``device`` where given (the CPU tests), else
    CUDA card 0 when the program is in this checkout and ``chips`` cards
    are there; None, with the reason on ``err``, where not."""
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or not os.path.abspath(spec.origin).startswith(
            os.path.join(ROOT, PROGRAM) + os.sep):
        print(f"amg_bench: the program {PROGRAM} is not in this checkout "
              f"({ROOT}); found {spec.origin if spec else None}", file=err)
        return None
    import torch
    if device is not None:
        return torch.device(device)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f"amg_bench: this cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {count}", file=err)
        return None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


def run(workload, seed, seconds, trace, t_start, device=None,
        traffic_override=None, cell_factory=None, out=None, err=None):
    """One run of ``workload``; prints the result line on ``out`` and the
    compared numbers on ``err``, and returns the result (None where it
    refused to run).  ``device``, ``traffic_override`` and ``cell_factory``
    are for the CPU tests: they skip the look for a card, shrink the
    traffic and put another system in the program's place."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    cell_entry, config, traffic, per_layer, end_to_end, system = \
        load_cell(workload, traffic_override)
    chips = int(cell_entry["chips"])
    device = pick_device(device, chips, err)
    if device is None:
        return None
    import torch

    factory = system.Cell if cell_factory is None else cell_factory
    rec = {"setup": {}}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    clock = [time.perf_counter()]

    def mark(name):
        sync()
        now = time.perf_counter()
        rec["setup"][name] = now - clock[0]
        clock[0] = now

    rec["setup"]["start_s"] = clock[0] - t_start
    cell = factory(config, traffic, seed, device)
    b_of = requests(traffic, seed)
    mark("inputs")
    cell.setup(mark)
    # warm-up: the first solve captures the graphs, the second finds them
    cell.solve(b_of(0))
    mark("first_solve")
    cell.solve(b_of(1))
    mark("second_solve")
    setup_s = time.perf_counter() - t_start

    win = window(cell, b_of, traffic, seed, seconds)
    sync()
    dev = device_info(torch, device, chips)
    found = forbidden_modules()
    if found:
        print(f"amg_bench: modules loaded that the port must not use: "
              f"{found}", file=err)
        return None
    n = len(win["walls"])
    rec.update(setup_s=setup_s, window=win, inner=win["inner"])

    breakdown = None
    if trace:
        breakdown = traced(cell, b_of, rec, dev)

    kept = cell.kept_to_host(win["kept"])
    desc = cell.describe()
    cell.free()
    del cell
    numbers = system.compare(config, traffic, seed, desc, kept, device)
    correct = all(ok for _, _, _, ok in numbers)

    metrics = read_metrics(per_layer if trace else end_to_end, rec)
    result = {"correct": correct, "attempted": n, "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit, _ in numbers}
    q = [round(v * 1e3, 3) for v in statistics.quantiles(win["walls"], n=4)] \
        if n > 1 else []
    print(f"amg_bench: set-up seconds {rec['setup']}; window "
          f"{win['wall_s']:.3f} s, {n} solves, quartiles {q} ms, iterations "
          f"{sorted(set(win['inner']))}, kept {len(kept)}", file=err)
    for name, value, limit, ok in numbers:
        print(f"amg_bench: compared {name} = {value!r} (limit {limit!r}) "
              f"{'ok' if ok else 'FAILED'}", file=err)
    err.flush()
    if forbidden_modules():
        print(f"amg_bench: modules loaded that the port must not use: "
              f"{forbidden_modules()}", file=err)
        return None
    print(json.dumps(result), file=out)
    out.flush()
    return result


def traced(cell, b_of, rec, dev):
    """The traced part of a ``--trace 1`` run, after the window, all on
    b_0: the host syncs of one device-stopped solve; a few device-stopped
    solves timed before any profiler run (the idle share's wall); the
    same solves profiled in the per-step form (one graph a step, whose
    kernels the profiler sees), the program's kernel counters read around
    them."""
    from amg_bench.harness import trace
    import torch
    b = b_of(0)
    rec["host_syncs_per_solve"] = trace.host_syncs(lambda: cell.solve(b),
                                                   cell.graph_module())
    calls = cell.profiled_calls
    walls = []
    for _ in range(calls):          # the same b device-stopped, unprofiled
        t0 = time.perf_counter()
        cell.solve(b)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with cell.per_step():
        cell.solve(b)                       # capture the per-step graphs
        cell.reset_kernel_counts()
        prof = trace.profiled(lambda: cell.solve(b), calls)
        rec["kernels"] = cell.kernel_counts()
    busy_us = trace.busy_seconds([(s, e) for _, s, e in prof["device_ops"]])
    rec["profile"] = {"calls": calls, "wall_s": prof["wall_s"],
                      "device_stopped_s": statistics.median(walls),
                      "busy_s": busy_us / 1e6,
                      "device_ops": prof["device_ops"]}
    dev["busy_s"] = busy_us / 1e6
    dev["window_s"] = prof["wall_s"]
    return {"device_ops": trace.top_device_ops(prof["device_ops"]),
            "idle_gaps": trace.idle_gaps(prof["device_ops"],
                                         prof["host_ops"])}
