"""Open loop: independent users whose interactions arrive on a schedule
drawn from the seed, whatever the system does.

Arrivals are a Poisson process of ``rate_per_s``, given its expected
count, so that every seed offers the same number of interactions in
another order.  Every arrival is an interaction due at its time.
"""
from __future__ import annotations

import math

import numpy as np


class Loop:
    def __init__(self, params: dict, rng: np.random.Generator,
                 duration_s: float):
        self.duration = duration_s
        n = int(round(float(params["rate_per_s"]) * duration_s))
        # a Poisson process given its count: uniform arrival times
        self.offsets = np.sort(rng.uniform(0.0, duration_s, n))
        self.t0 = None
        self._next = 0
    def needed(self) -> int:
        """Interactions this phase releases at most."""
        return int(self.offsets.shape[0])

    def start(self, t0: float) -> None:
        self.t0 = t0

    def release(self, now: float) -> list:
        """(due time, client) of every interaction due by ``now``."""
        out = []
        offs, i, t0 = self.offsets, self._next, self.t0
        while i < offs.shape[0] and t0 + offs[i] <= now:
            out.append((t0 + float(offs[i]), None))
            i += 1
        self._next = i
        return out

    def completed(self, client, t: float) -> None:
        """Arrivals do not wait for answers."""

    def next_due(self) -> float:
        if self._next < self.offsets.shape[0]:
            return self.t0 + float(self.offsets[self._next])
        return math.inf
