"""Elastic scaling: re-mesh and re-lower when hosts join or leave, and
the drain -> re-lower -> resume recipe, as data
(``repro.runtime.elastic``).

SharedDB's always-on plan is compiled for a fixed layout; changes to it
land at CYCLE boundaries, never inside a step:

  1. failure/resize detected (heartbeats, scheduler event);
  2. drain: finish the in-flight cycle, checkpoint (atomic);
  3. pick the largest supported mesh <= surviving chips from the ladder
     (``ElasticMeshManager``);
  4. re-lower the same step functions under the new mesh;
  5. restore the checkpoint re-sharded and resume at the saved step.

The same skeleton drives plan FOLDING (core/folding.py), where the
re-lower happens in the BACKGROUND while the old cycles keep serving and
the drain/swap collapses to a single beat boundary.  ``relower_recipe``
produces both variants.

The port's mesh (``make_mesh``) is a description, a ``DeviceMesh`` of
the shape, axis names and ``torch.device``s: the port's LM runs on one
device and its SharedDB mesh is ``core/sharding.RowMesh``; nothing here
opens a process group.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

# (pods, data, model) ladder — model axis kept at 16 so TP-sharded configs
# stay valid; shrink sheds data-parallel rows first (batch divisibility is
# re-checked against the config at selection time).
DEFAULT_LADDER: List[Tuple[int, ...]] = [
    (2, 16, 16), (1, 16, 16), (1, 8, 16), (1, 4, 16), (1, 2, 16),
    (1, 1, 16), (1, 1, 8), (1, 1, 4), (1, 1, 2), (1, 1, 1),
]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A mesh of devices: ``shape`` over ``axis_names``, ``devices`` in
    row-major order."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]


def alive_devices() -> List[torch.device]:
    """Every CUDA card of this host (none without one)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def relower_recipe(current, target, *, what: str = "step functions",
                   background: bool = False) -> dict:
    """The drain -> re-lower -> resume recipe as structured data.

    ``background=False`` is the elastic-shrink variant (stop-the-world at
    a cycle boundary: drain, checkpoint, re-lower, restore).
    ``background=True`` is the plan-folding variant: the re-lower
    overlaps serving and only the swap itself lands at a beat boundary,
    so already-admitted clients keep their 2-cycle latency bound."""
    if background:
        steps = [
            f"re-lower {what} under {target} in the background "
            "(old compiled heartbeat keeps serving)",
            "drain in-flight beats at the next beat boundary",
            "migrate carries into the new layout (atomic swap)",
            "resume: first post-swap beat is a full-rescan reseed",
        ]
    else:
        steps = [
            "drain in-flight cycle",
            "checkpoint (atomic commit)",
            f"re-lower {what} under mesh {target}",
            "restore re-sharded checkpoint",
            "resume at saved step",
        ]
    return {"current": current, "target": target, "steps": steps}


@dataclasses.dataclass
class ElasticMeshManager:
    ladder: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_LADDER))

    def __post_init__(self):
        # ``select`` returns the FIRST rung that fits, which is the
        # LARGEST only when the ladder is sorted descending by chip count:
        # validate the rungs and sort them at construction.
        for shape in self.ladder:
            if len(shape) != 3 or any(
                    not isinstance(d, int) or d < 1 for d in shape):
                raise ValueError(
                    f"ladder rung {shape!r} is not a (pods, data, model) "
                    "tuple of positive ints")
        self.ladder = sorted(self.ladder,
                             key=lambda s: s[0] * s[1] * s[2],
                             reverse=True)

    def select(self, chips_alive: int,
               global_batch: Optional[int] = None) -> Tuple[int, ...]:
        """Largest rung that fits the surviving chips (and batch)."""
        for shape in self.ladder:
            n = shape[0] * shape[1] * shape[2]
            if n > chips_alive:
                continue
            if global_batch is not None:
                dp = shape[0] * shape[1]
                if global_batch % dp != 0:
                    continue
            return shape
        raise RuntimeError(f"no viable mesh for {chips_alive} chips")

    def make_mesh(self, shape: Tuple[int, ...],
                  devices: Optional[Sequence] = None) -> DeviceMesh:
        """The mesh of ``shape`` over the first devices of ``devices``
        (default: every CUDA card), which callers that learned of a death
        (heartbeats) pass as the surviving devices.  A pod axis only when
        there are pods: ``("pod", "data", "model")``, else ``("data",
        "model")``."""
        n = shape[0] * shape[1] * shape[2]
        pool = list(devices) if devices is not None else alive_devices()
        if len(pool) < n:
            raise RuntimeError(
                f"mesh shape {shape} needs {n} devices, only "
                f"{len(pool)} alive")
        pool = tuple(torch.device(d) for d in pool[:n])
        if shape[0] > 1:
            return DeviceMesh(tuple(shape), ("pod", "data", "model"), pool)
        return DeviceMesh(tuple(shape[1:]), ("data", "model"), pool)

    def shrink_plan(self, current: Tuple[int, ...], chips_alive: int,
                    global_batch: Optional[int] = None) -> dict:
        """The drain -> re-mesh -> restore recipe as structured data."""
        target = self.select(chips_alive, global_batch)
        return relower_recipe(current, target, what="step")
