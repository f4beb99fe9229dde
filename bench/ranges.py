"""The device's idle gaps credited to the innermost host range over them.

``bench/trace.py`` credits each idle gap of a traced window to the
harness's own ranges, which follow one another.  ``repro_torch``'s
engine, built with ``trace=True``, opens ranges of its own inside them
while a profiler runs (``repro.dispatch.*``, ``repro.collect.*``), so a
gap under ``bench.dispatch`` may lie under ``repro.dispatch.launch``.
``credit`` splits every gap over the innermost range covering each part
of it (the one opened last among those still open), whatever the
nesting; a part under no range is ``UNCOVERED``.  ``read`` does so for a
profiler's trace.  Used by ``bench/stages.py``; the benchmark's own
``idle_gaps`` breakdown is ``bench/trace.py``'s.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from bench import stats

UNCOVERED = "harness, between steps"
PREFIXES = ("bench.", "repro.")
WINDOW = "bench.window"


def innermost(ranges: Iterable[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """Disjoint (start, end, name) pieces of the time the ranges cover,
    each named by the innermost range over it.  Ranges nest or follow one
    another; where two overlap without nesting, the later one holds the
    time until it ends."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []      # (end, name), innermost last
    at = -math.inf

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > at:
                out.append((at, end, name))
                at = end

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(a)
        if stack and a > at:
            out.append((at, a, stack[-1][1]))
        at = max(at, a)
        stack.append((b, name))
    close_until(math.inf)
    return [(a, b, n) for a, b, n in out if b > a]


def credit(gaps: List[Tuple[float, float]],
           ranges: Iterable[Tuple[float, float, str]]) -> Dict[str, float]:
    """Each gap's length by the innermost range over each part of it
    (``UNCOVERED`` where none is)."""
    pieces = innermost(ranges)
    out: Dict[str, float] = {}
    i = 0
    for ga, gb in sorted(gaps):
        while i < len(pieces) and pieces[i][1] <= ga:
            i += 1
        covered, j = 0.0, i
        while j < len(pieces) and pieces[j][0] < gb:
            a, b, name = pieces[j]
            part = min(b, gb) - max(a, ga)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
            j += 1
        if gb - ga > covered:
            out[UNCOVERED] = out.get(UNCOVERED, 0.0) + (gb - ga - covered)
    return out


def read(prof) -> Dict[str, float]:
    """Seconds of device idle in the trace's ``bench.window`` by the
    innermost ``bench.*`` or ``repro.*`` host range over them (the same
    device events as ``bench/trace.py`` counts)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if not (name.startswith("bench.") or e.is_user_annotation()):
                dev.append((a, b))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(PREFIXES):
            host.append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1]
    return {n: us / 1e6 for n, us in
            credit(stats.gaps(dev, w0, w1), host).items()}
