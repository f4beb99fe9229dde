"""The traced run's reading of a torch.profiler trace: the device's busy
time, its operations by name, the hand kernels' kept events, and the
device's idle gaps by what the harness's host thread was doing.

The harness marks its own steps as profiler ranges (``bench.submit``,
``bench.dispatch``, ``bench.collect``, ``bench.idle``) and the window as
``bench.window``; device operations outside the window are left out.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from bench import stats

WINDOW = "bench.window"
HOST_RANGES = ("bench.submit", "bench.dispatch", "bench.collect",
               "bench.idle")


def read(prof, symbols: Dict[str, str]) -> dict:
    """``symbols``: hand kernel name -> its symbol in the trace.

    Reads the profiler's raw events (``kineto_results``), not its
    Python event tree, which takes minutes to build for a window of
    hundreds of thousands of device operations.  Range annotations that
    the profiler mirrors onto the device's timeline are not device work
    and are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if not (name.startswith("bench.") or e.is_user_annotation()):
                dev.append((a, b, name))
        elif name == WINDOW:
            window = (a, b)
        elif name in HOST_RANGES:
            host.append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    by_name: Dict[str, List[float]] = {}
    for a, b, n in dev:
        by_name.setdefault(n, []).append(b - a)
    kernels = {}
    other_us = 0.0
    for n, durs in by_name.items():
        k = next((k for k, s in symbols.items() if s in n), None)
        if k is None:
            other_us += sum(durs)
        else:
            kept, total = kernels.get(k, (0, 0.0))
            kernels[k] = (kept + len(durs), total + sum(durs))
    intervals = [(a, b) for a, b, _ in dev]
    idle: Dict[str, float] = {}
    # the harness's ranges follow one another: sorted by start, their ends
    # are sorted too
    host.sort()
    ends = [hb for _, hb, _ in host]
    for ga, gb in stats.gaps(intervals, w0, w1):
        covered = 0.0
        i = bisect.bisect_right(ends, ga)
        while i < len(host) and host[i][0] < gb:
            ha, hb, n = host[i]
            part = min(hb, gb) - max(ha, ga)
            idle[n] = idle.get(n, 0.0) + part
            covered += part
            i += 1
        if gb - ga > covered:
            idle["harness, between steps"] = \
                idle.get("harness, between steps", 0.0) + (gb - ga - covered)
    top = sorted(((n, sum(d)) for n, d in by_name.items()),
                 key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": stats.union_s(intervals) / 1e6,
        "device_events": len(dev),
        "torch_ops_s": other_us / 1e6,
        # kernel -> (events kept, their seconds)
        "kernels": {k: (n, us / 1e6) for k, (n, us) in kernels.items()},
        "device_ops": [[n[:120], us / 1e6] for n, us in top],
        "idle_gaps": [[n, us / 1e6] for n, us in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
