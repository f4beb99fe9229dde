"""Operator backend registry: plain torch ops vs hand-written Hopper kernels.

The lowered operator graph (lowering.py) is backend-agnostic: every stage
with a compute hot spot resolves its implementation through this registry
when the cycles are built.  Two backends ship:

  * ``torch``  — the plain PyTorch versions (kernels/ref.py): the CPU
                 execution path and the oracle every kernel is held to.
  * ``hopper`` — the CUDA kernels for ``sm_90a`` (kernels/), registered
                 by importing ``repro_torch.kernels``.

Backend surface (the shared-operator hot loops):

  scan(cols, lo, hi, valid)                 -> int32[T, W]    (ClockScan)
  scan_delta(cols, lo, hi, valid, rows)     -> int32[D, W]    (dirty rows)
  join_block(kl, ml, kr, mr, valid_r)       -> (rid, mask)    (block join)
  join_partitioned(kl, ml, bkeys, brows,
                   bounds, mr)              -> (rid, mask)    (bucketed join)
  join_delta(kl, rows, bkeys, brows,
             bounds)                        -> rid int32[D]   (dirty probe)
  groupby(codes, vals, mask, n_groups)      -> (count, sum)
  fused_delta(scan_in, join_in)             -> (words, rids)  (OPTIONAL:
      the whole delta beat in ONE op; None keeps the chained
      scan / scan_delta / join_delta ops in build_delta_cycle)

Resolution: ``resolve_backend("torch"|"hopper"|"auto", device)``.
``auto`` is ``hopper`` on a CUDA device of compute capability 9.0 or
higher and ``torch`` only when the CPU was asked for; ``device=None``
means the CUDA card and raises without one, and any other device
raises.  There is no environment override.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device


class FusedScanIn(NamedTuple):
    """One predicated scan stage's inputs to the fused delta op.

    ``rows`` is the stage table's sorted distinct dirty-row set padded
    with the capacity sentinel (== ``cols.shape[1]``), ``dn`` its live
    count; ``w0``/``span`` the admission pane's first word column and
    changed-word span (lowering._pane_window).  A zero span and an empty
    dirty set are exact identities on the carried words."""
    cols: object          # int32[C, T] predicated columns
    lo: object            # int32[C, Q] full-window predicate lows
    hi: object            # int32[C, Q] full-window predicate highs
    lo_p: object          # int32[C, 32*A] pane slice of lo at w0
    hi_p: object          # int32[C, 32*A] pane slice of hi at w0
    valid: object         # bool[T]
    carry: object         # int32[T, w] previous heartbeat's words
    w0: object            # int32 0-d: pane's first word column
    span: object          # int32 0-d: changed-word span (0 = none)
    rows: object          # int32[D] dirty rows (sentinel == T pads)
    dn: object            # int32 0-d: live dirty-row count


class FusedJoinIn(NamedTuple):
    """One carried (non-gather) join's inputs to the fused delta op.
    Block-kind joins arrive as single-bucket pseudo-partitions."""
    keys: object          # int32[Tl] the spine's full fk column
    rows: object          # int32[D] dirty spine rows (sentinel == Tl)
    dn: object            # int32 0-d: live dirty-row count
    bkeys: object         # int32[P, B] bucket keys
    brows: object         # int32[P, B] bucket row ids (-1 pad)
    bounds: object        # int32[P] bucket lower bounds
    rid_carry: object     # int32[Tl] previous heartbeat's rids


@dataclasses.dataclass(frozen=True)
class OperatorBackend:
    """Implementations for the shared-operator hot loops."""
    name: str
    scan: Callable
    join_block: Callable
    join_partitioned: Callable
    groupby: Callable
    scan_delta: Callable
    join_delta: Callable
    fused_delta: Optional[Callable] = None


_REGISTRY: Dict[str, OperatorBackend] = {}


def register_backend(backend: OperatorBackend) -> None:
    _REGISTRY[backend.name] = backend


def _ensure_registered() -> None:
    if "hopper" not in _REGISTRY:
        import repro_torch.kernels  # noqa: F401  (registers ``hopper``)


def available_backends() -> Tuple[str, ...]:
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> OperatorBackend:
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; "
                       f"available: {available_backends()}")
    return _REGISTRY[name]


def resolve_backend(kernels: str = "auto",
                    device=None) -> OperatorBackend:
    """Map a ``kernels=`` spec to a concrete backend.

    "torch" -> the plain ops; "hopper" -> the CUDA kernels; "auto" ->
    ``hopper`` on a CUDA device of capability >= 9.0, ``torch`` on
    ``device="cpu"``; ``device=None`` is the CUDA card (raises without
    one).  Any other registered name resolves too (wrapped backends in
    tests); unknown names raise ValueError."""
    if kernels != "auto":
        _ensure_registered()
        if kernels in _REGISTRY:
            return _REGISTRY[kernels]
        raise ValueError(f"kernels must be 'torch', 'hopper', 'auto' or a "
                         f"registered backend name, got {kernels!r}")
    device = resolve_device(device)
    if device.type == "cpu":
        return get_backend("torch")
    if device.type == "cuda" and \
            torch.cuda.get_device_capability(device) >= (9, 0):
        return get_backend("hopper")
    raise ValueError(f"kernels='auto' has no backend for {device}: the "
                     f"hand-written kernels need compute capability 9.0+")


# ---------------------------------------------------------------------------
# The torch backend (oracle + CPU execution path)
# ---------------------------------------------------------------------------


def _torch_backend() -> OperatorBackend:
    from repro_torch.kernels import ref
    return OperatorBackend(
        name="torch", scan=ref.clockscan_ref,
        join_block=ref.bitmask_join_ref,
        join_partitioned=ref.partitioned_join_ref,
        groupby=ref.shared_groupby_ref, scan_delta=ref.delta_scan_ref,
        join_delta=ref.delta_join_ref, fused_delta=ref.fused_delta_ref)


register_backend(_torch_backend())


# ---------------------------------------------------------------------------
# Instrumentation: per-op call counting
# ---------------------------------------------------------------------------

_COUNTED_OPS = ("scan", "join_block", "join_partitioned", "groupby",
                "scan_delta", "join_delta", "fused_delta")


def counting_backend(base: OperatorBackend,
                     counts: Dict[str, int]) -> OperatorBackend:
    """Wrap every op of ``base`` to bump ``counts[op]`` per call.

    The cycles run eagerly, so with the executor clearing ``counts`` at
    cycle entry these are the backend launches of one beat.  The wrapped
    ops delegate verbatim."""
    def wrap(op, opname):
        if op is None:
            return None

        def counted(*args, **kwargs):
            counts[opname] = counts.get(opname, 0) + 1
            return op(*args, **kwargs)
        return counted

    return OperatorBackend(
        name=f"counting-{base.name}",
        **{op: wrap(getattr(base, op), op) for op in _COUNTED_OPS})
