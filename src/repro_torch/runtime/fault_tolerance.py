"""Fault tolerance for 1000+-node runs: ``repro.runtime.fault_tolerance``
(pure Python) over the port's checkpoints.

Design (validated here by fault-injection tests; the hardware-specific
health signals are pluggable):

* checkpoint/restart — the training loop is a pure function of
  (params, opt, data_step); CheckpointManager commits atomically, so a
  restart resumes bit-exact from the last committed step (the data
  pipeline replays from its step counter — no data loss or duplication).
* heartbeats — each host publishes a monotonically increasing step; a
  host silent for `dead_after_s` is declared failed and triggers the
  elastic path (runtime/elastic.py).
* straggler mitigation — SharedDB's bounded cycles make stragglers
  well-defined: every step has the SAME work, so a host slower than
  median * straggler_factor for `patience` consecutive steps is flagged
  and (policy) either remapped out at the next checkpoint boundary or its
  shard is replicated to a hot spare.  There is no speculative re-execution
  inside a step: steps are deterministic and collectives would
  deadlock — mitigation happens at step granularity.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 1.5          # slower than median x factor == straggler
    patience: int = 5            # consecutive slow steps before flagging
    dead_after_s: float = 60.0   # heartbeat silence == failure


class HeartbeatBoard:
    """In-process stand-in for the cluster KV store (etcd/Borg/SLURM)."""

    def __init__(self):
        self._last: Dict[int, float] = {}
        self._step: Dict[int, int] = {}
        self._durations: Dict[int, List[float]] = {}
        # expected membership: registration time stands in for the first
        # beat of a host that never manages one (a host dead on arrival
        # would otherwise never appear in _last and never be declared dead)
        self._registered: Dict[int, float] = {}

    def register(self, host: int, now: Optional[float] = None):
        """Declare a host EXPECTED.  Silence counts from this moment."""
        self._registered.setdefault(
            host, now if now is not None else time.time())

    def beat(self, host: int, step: int, duration_s: float,
             now: Optional[float] = None):
        t = now if now is not None else time.time()
        self._registered.setdefault(host, t)
        self._last[host] = t
        self._step[host] = step
        self._durations.setdefault(host, []).append(duration_s)

    def dead_hosts(self, policy: StragglerPolicy,
                   now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return sorted(
            h for h, t0 in self._registered.items()
            if now - self._last.get(h, t0) > policy.dead_after_s)

    def stragglers(self, policy: StragglerPolicy) -> List[int]:
        if not self._durations:
            return []
        recent = {h: d[-policy.patience:]
                  for h, d in self._durations.items()}
        med = float(np.median([x for d in recent.values() for x in d]))
        out = []
        for h, d in recent.items():
            if len(d) >= policy.patience and \
                    all(x > policy.factor * med for x in d):
                out.append(h)
        return out


class FaultTolerantLoop:
    """Wraps a step function with checkpoint/restart + health tracking.

    step_fn(state, step) -> (state, metrics); state is a pytree.
    Failures raised by step_fn (or injected) roll back to the last
    committed checkpoint and replay — the paper-style bounded cycle makes
    replay cost at most `save_every` steps.
    """

    def __init__(self, step_fn: Callable, ckpt_manager, *,
                 save_every: int = 50,
                 policy: StragglerPolicy = StragglerPolicy(),
                 host_id: int = 0,
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.policy = policy
        self.host_id = host_id
        self.max_restarts = max_restarts
        self.board = HeartbeatBoard()
        self.board.register(self.host_id)
        self.restarts = 0

    def run(self, state, start_step: int, n_steps: int,
            fail_at: Optional[Dict[int, Exception]] = None):
        """fail_at: {step: exc} fault injection used by the test-suite."""
        step = start_step
        metrics_log = []
        injected = dict(fail_at or {})
        while step < start_step + n_steps:
            t0 = time.time()
            try:
                if step in injected:
                    raise injected.pop(step)
                state, metrics = self.step_fn(state, step)
            except Exception as e:  # noqa: BLE001 — restart path
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                last = self.ckpt.latest_step()
                if last is None:
                    raise RuntimeError("failure before first checkpoint") \
                        from e
                state, manifest = self.ckpt.restore(state, last)
                step = manifest["extra"]["next_step"]
                continue
            self.board.beat(self.host_id, step, time.time() - t0)
            metrics_log.append(metrics)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(state, step, extra={"next_step": step})
        return state, metrics_log
