"""What the traced run reads from torch.profiler and from the program's
counters: the device operations of a few solves, the device's busy time
(the union of their intervals), the breakdown the result line carries,
and the host syncs of a call.  Only the traced run imports the profiler;
the measured window never runs under it."""

import bisect
import time


def busy_seconds(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profiled(fn, calls):
    """Run ``fn`` ``calls`` times under torch.profiler (host and device
    activity): {"wall_s", "device_ops": [(name, start_us, end_us)],
    "host_ops": [(name, start_us, end_us)]}; the device timeline's copies
    of the program's named ranges (``record_function``) are left out.  A trace that holds no device
    operation (the profiler returns one now and then) is taken again after
    a pause, up to 5 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(5):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev, host = [], []
        for e in prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(item)
            elif not getattr(e, "is_user_annotation", False):
                dev.append(item)        # a range the program names is no
                                        # operation of the device
        if dev or not torch.cuda.is_available():
            break
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return {"wall_s": wall, "device_ops": dev, "host_ops": host}


def top_device_ops(dev, top=10):
    """[[name, seconds]] of the device operations that took most time,
    summed by name."""
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return [[n, t] for n, t in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def idle_gaps(dev, host, top=10, lookback=256):
    """[[label, seconds]] of the device's idle gaps between its first and
    last operation, summed by what the host was doing in each (the
    innermost host operation that spans the gap's middle, else "host
    between operations"), longest first."""
    starts = [s for _, s, _ in host]
    gaps, end = {}, None
    for name, s, e in dev:
        if end is not None and s > end:
            mid = (s + end) / 2
            label = "host between operations"
            k = bisect.bisect_right(starts, mid) - 1
            for j in range(k, max(k - lookback, -1), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
        end = e if end is None else max(end, e)
    return [[n, t] for n, t in sorted(gaps.items(),
                                      key=lambda kv: -kv[1])[:top]]


def host_syncs(run, graph_module):
    """The host syncs of one call of ``run``, counted without the
    profiler: reads of a CUDA tensor's value (``item``, ``bool``, ``int``,
    ``float``, ``index``) and the captured loops' one read of their
    results (``graph_module.read``, the program's own read)."""
    import torch
    count = [0]
    real = {name: getattr(torch.Tensor, name) for name in
            ("item", "__bool__", "__int__", "__float__", "__index__")}

    def counted(name):
        def fn(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return real[name](self, *args, **kwargs)
        return fn

    real_read = graph_module.read

    def read(tensors):
        count[0] += 1
        return real_read(tensors)

    try:
        for name in real:
            setattr(torch.Tensor, name, counted(name))
        graph_module.read = read
        run()
    finally:
        for name, fn in real.items():
            setattr(torch.Tensor, name, fn)
        graph_module.read = real_read
    return count[0]
