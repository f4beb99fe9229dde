"""Closed loop: a pool of ``clients`` connections, each sending its next
interaction as soon as its previous one completed.

Every client is due at the phase's start; a client whose next due time
falls past the phase's end stops.  ``max_rate_per_s`` bounds the
interactions the phase can release, so that set-up generates them all.
"""
from __future__ import annotations

import heapq
import math

import numpy as np


class Loop:
    def __init__(self, params: dict, rng: np.random.Generator,
                 duration_s: float):
        self.duration = duration_s
        self.clients = int(params["clients"])
        self.cap = int(math.ceil(float(params["max_rate_per_s"])
                                 * duration_s)) + self.clients
        self.t0 = None
        self._heap = []
        self._released = 0

    def needed(self) -> int:
        return self.cap

    def start(self, t0: float) -> None:
        self.t0 = t0
        self._heap = [(t0, c) for c in range(self.clients)]
        heapq.heapify(self._heap)

    def release(self, now: float) -> list:
        out = []
        while self._heap and self._heap[0][0] <= now:
            due, client = heapq.heappop(self._heap)
            if self._released >= self.cap:
                raise RuntimeError(
                    f"closed pool released {self.cap} interactions, its "
                    "max_rate_per_s bound: raise it in the traffic file")
            self._released += 1
            out.append((due, client))
        return out

    def completed(self, client, t: float) -> None:
        if t < self.t0 + self.duration:
            heapq.heappush(self._heap, (t, client))

    def next_due(self) -> float:
        return self._heap[0][0] if self._heap else math.inf
