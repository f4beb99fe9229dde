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

The port's mesh (``make_mesh``) is a torch ``DeviceMesh`` over ranks of
the default process group, which ``launch/mesh.make_axes`` takes.  A
real job re-forms its group over the survivors after a death (as
torchrun's elastic agent does); on one card the group is a fake one of
the rung's size under ``LocalTensorMode`` (``launch/dryrun.
simulated_group``).  ``shrink_and_resume`` runs the recipe's five steps
on a training state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import torch

# (pods, data, model) ladder — model axis kept at 16 so TP-sharded configs
# stay valid; shrink sheds data-parallel rows first (batch divisibility is
# re-checked against the config at selection time).
DEFAULT_LADDER: List[Tuple[int, ...]] = [
    (2, 16, 16), (1, 16, 16), (1, 8, 16), (1, 4, 16), (1, 2, 16),
    (1, 1, 16), (1, 1, 8), (1, 1, 4), (1, 1, 2), (1, 1, 1),
]


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
                  ranks: Optional[Sequence[int]] = None):
        """The torch ``DeviceMesh`` of ``shape`` over the first ranks of
        ``ranks`` (default: every rank of the default process group),
        which callers that learned of a death (heartbeats) pass as the
        surviving ranks; on the card where there is one, else the CPU.
        A pod axis only when there are pods: ``("pod", "data",
        "model")``, else ``("data", "model")``.  Raises when fewer ranks
        are alive than the rung needs."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        n = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 0
        pool = list(range(world)) if ranks is None else list(ranks)
        if len(pool) < n:
            raise RuntimeError(
                f"mesh shape {shape} needs {n} devices, only {len(pool)} "
                f"alive (ranks of the default process group: {world}; "
                f"cards here: {len(alive_devices())})")
        if any(not 0 <= r < world for r in pool[:n]):
            raise RuntimeError(f"ranks {pool[:n]} are not all in the "
                               f"default process group of {world}")
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
        if shape[0] > 1:
            dims, names = tuple(shape), ("pod", "data", "model")
        else:
            dims, names = tuple(shape[1:]), ("data", "model")
        return DeviceMesh(device_type, torch.tensor(pool[:n]).reshape(dims),
                          mesh_dim_names=names)

    def shrink_plan(self, current: Tuple[int, ...], chips_alive: int,
                    global_batch: Optional[int] = None) -> dict:
        """The drain -> re-mesh -> restore recipe as structured data."""
        target = self.select(chips_alive, global_batch)
        return relower_recipe(current, target, what="step")


@contextlib.contextmanager
def shrink_and_resume(mgr: ElasticMeshManager, current, chips_alive: int,
                      ckpt, *, steps: int, global_batch: int, regroup,
                      build):
    """A training run shrunk from rung ``current`` to the rung that
    ``chips_alive`` chips allow, ``relower_recipe(current, target)``'s
    five steps in order.  ``regroup(n)`` is the context of a default
    process group of n ranks (a real job's, re-formed over the survivors
    by its agent; on one card ``launch/dryrun.simulated_group``);
    ``build(axes)`` makes the trainer on a mesh (``launch/train.
    Trainer``: ``api``, ``init_state``, ``step_fn``).

    Before the shrink: ``steps`` steps on ``current``'s mesh
    (``make_mesh``).  Then:
      1. drain: the last step has returned;
      2. checkpoint: ``ckpt.save`` at step ``steps`` (atomic commit);
      3. re-lower: ``shrink_plan`` gives the target; the group is
         re-formed at its size, ``make_mesh(target)``, ``build`` on it;
      4. restore: the checkpoint re-sharded into the target's analytic
         template (``api.state_template``, the saved dtypes; nothing
         initialised first);
      5. resume: yields, inside the re-formed group's context, {"plan",
         "trainer", "state" (restored), "log" (the steps before, each
         with its "wall_s"), "save_s", "restore_s"}; the caller's next
         step is ``steps`` (``step_fn`` reads ``batch_at(steps)``)."""
    from repro_torch.core import pytree
    from repro_torch.launch.mesh import make_axes
    log = []
    with regroup(math.prod(current)):
        trainer = build(make_axes(mgr.make_mesh(current)))
        state = trainer.init_state()
        for step in range(steps):
            t0 = time.perf_counter()
            state, m = trainer.step_fn(state, step)
            log.append(dict(m, wall_s=time.perf_counter() - t0))
        t0 = time.perf_counter()
        ckpt.save(state, steps, extra={"next_step": steps})
        save_s = time.perf_counter() - t0
        dtypes = pytree.tree_map(lambda t: t.dtype, state)
        del state, trainer
    plan = mgr.shrink_plan(current, chips_alive, global_batch)
    with regroup(math.prod(plan["target"])):
        trainer = build(make_axes(mgr.make_mesh(plan["target"])))
        template = pytree.tree_map(
            lambda d, leaf: dataclasses.replace(leaf, dtype=d), dtypes,
            trainer.api.state_template())
        t0 = time.perf_counter()
        state, _ = ckpt.restore(template, steps)
        yield {"plan": plan, "trainer": trainer, "state": state,
               "log": log, "save_s": save_s,
               "restore_s": time.perf_counter() - t0}
