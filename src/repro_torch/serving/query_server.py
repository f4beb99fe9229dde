"""SharedDB-facing serving front end with runtime template registration.

``QueryCycleServer`` wraps a ``SharedDBEngine`` with the client protocol
of the paper's middleware tier — submit / heartbeat / collect — plus the
one operation the always-on plan could not offer before dynamic plan
folding (core/folding.py): ``register_template()``, which admits a NEW
query shape into the running shared plan without stopping the world.

Fold-in-flight admission rules
------------------------------
* No fold in flight — a registration starts one immediately (background
  build; the current compiled heartbeat keeps serving).
* Fold in flight — the registration BATCHES: it is queued and folded in
  one shot right after the in-flight fold commits (one migration beat
  per batch, not per template).  ``heartbeat()`` advances the batch.
* Queries for a registered-but-not-yet-folded template are ACCEPTED and
  held; they flush into the engine's admission queues the moment the
  template's fold opens them, and are served after the fold's single
  migration (full-rescan) beat.  Already-admitted clients never see the
  fold: their templates keep their slot ranges (prefix-stable
  extension), and every beat until the swap runs the old compiled plan.
* Re-registering a known template is a no-op (idempotent client retry).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

from repro_torch.core.executor import (CycleResult, SharedDBEngine, Ticket,
                                      WriteTicket)
from repro_torch.core.plan import QueryTemplate


class QueryCycleServer:
    def __init__(self, engine: SharedDBEngine,
                 background_folds: bool = True):
        self.engine = engine
        self._background = background_folds
        # registrations batched while a fold is in flight
        self._pending_reg: List[Tuple[QueryTemplate, int]] = []
        # tickets held for templates the engine cannot queue yet
        self._held: Dict[str, collections.deque] = {}
        self.registered = set(engine.plan.templates)
        self.folds_started = 0

    # ------------------------------------------------------ registration
    def register_template(self, template: QueryTemplate,
                          cap: int) -> dict:
        """Admit a new query template into the running plan."""
        return self.register_templates([(template, cap)])[0]

    def register_templates(
            self, batch: List[Tuple[QueryTemplate, int]]) -> List[dict]:
        """Admit several templates in ONE fold — one migration beat for
        the whole batch (or one batched registration if a fold is
        already in flight)."""
        out: List[dict] = []
        todo: List[Tuple[QueryTemplate, int]] = []
        for template, cap in batch:
            if template.name in self.registered:
                out.append({"status": "already-registered",
                            "template": template.name})
                continue
            self.registered.add(template.name)
            self._held.setdefault(template.name, collections.deque())
            todo.append((template, cap))
        if not todo:
            return out
        if self.engine.fold_in_flight():
            self._pending_reg.extend(todo)
            out.extend({"status": "batched", "template": t.name,
                        "behind": len(self._pending_reg)}
                       for t, _ in todo)
            return out
        recipe = self.engine.begin_fold(
            [t for t, _ in todo], {t.name: c for t, c in todo},
            background=self._background)
        self.folds_started += 1
        self._flush_held()
        out.extend({"status": "folding", "template": t.name,
                    "recipe": recipe} for t, _ in todo)
        return out

    def _advance_folds(self) -> None:
        """Start the next batched fold once the engine is free, and
        flush held queries for any template whose queue now exists."""
        if self._pending_reg and not self.engine.fold_in_flight():
            batch, self._pending_reg = self._pending_reg, []
            self.engine.begin_fold(
                [t for t, _ in batch], {t.name: c for t, c in batch},
                background=self._background)
            self.folds_started += 1
        self._flush_held()

    def _flush_held(self) -> None:
        for name in list(self._held):
            if self.engine.accepts(name):
                q = self._held.pop(name)
                while q:
                    self.engine.submit_ticket(q.popleft())

    # --------------------------------------------------------- admission
    def submit(self, template: str, params) -> Ticket:
        if template not in self.registered:
            raise KeyError(
                f"unknown template {template!r} — register_template() "
                "first")
        if self.engine.accepts(template):
            return self.engine.submit(template, params)
        t = self.engine.make_ticket(template, params)
        self._held[template].append(t)
        return t

    def submit_update(self, table: str, kind: str,
                      payload: dict) -> WriteTicket:
        """A write, acknowledged by the collect() of the beat that carries
        it (``SharedDBEngine.submit_update``)."""
        return self.engine.submit_update(table, kind, payload)

    def pending(self) -> int:
        return self.engine.pending() + sum(
            len(q) for q in self._held.values())

    # --------------------------------------------------------- heartbeat
    def heartbeat(self, max_cycles: int = 1000,
                  pipelined: bool = False) -> List[CycleResult]:
        """Run the engine until drained, advancing batched folds at the
        beat boundaries (a fold can only start/commit between beats)."""
        self._advance_folds()
        out = list(self.engine.run_until_drained(max_cycles=max_cycles,
                                                 pipelined=pipelined))
        # a fold that committed during the drain may have unblocked a
        # batched registration (and its held queries): serve those too
        # within the same client call
        self._advance_folds()
        if self.engine.pending():
            out.extend(self.engine.run_until_drained(
                max_cycles=max_cycles, pipelined=pipelined))
        return out
