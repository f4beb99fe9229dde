"""Fused delta heartbeat (the ``fused_delta`` op): the whole incremental
beat — every predicated stage's admission pane and dirty-row rescan,
every carried join's dirty-row probe and rid merge — in ONE kernel
launch, with nothing else enqueued.

The kernel is ``csrc/fused_delta.cu`` (it replaces the JAX package's
``repro/kernels/fused_delta.py::fused_delta_pallas``).  It walks a static
descriptor ``int32[N, 3] = (kind, owner, idx)``, ``launch_schedule``:

  kind 0 (PANE)  — pane tile ``idx`` (PANE_TILE rows) of stage ``owner``,
                   taken by a whole block
  kind 1 (DIRTY) — dirty slot ``idx`` of stage ``owner``: row
                   ``rows[idx]``, read in the kernel; pads are skipped
  kind 2 (PROBE) — dirty slot ``idx`` of join ``owner``: the kernel
                   routes the row's key to its bucket over ``bounds``
  kind 3 (COPY)  — rid tile ``idx`` (COPY_TILE rows) of join ``owner``:
                   the carried rids of the rows no live PROBE writes

It is ``build_schedule`` (the reference's schedule, in torch) reordered —
the block items first, then the warp items — plus the COPY tiles; pure
geometry, made on the device once per geometry and cached, so the
descriptor never crosses from the host and nothing of it is rebuilt per
beat.  A CUDA graph that captures the launch holds the descriptor
(``kernels.hold``), since the cache may drop it.  The reference's runtime gather column (dirty row ids, routed
buckets) is computed inside the kernel instead.  ``w0``/``span``/``dn``
travel as pointers to their own 0-d tensors.  A grid of ``grid_blocks``
blocks (at most ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor)
walks the items: a whole block per PANE tile, a warp per DIRTY / PROBE /
COPY item.

The kernel merges straight into the carries: the scan words in place
(the reference donates that carry half, so each beat's words become the
next beat's carry), the rids into fresh tensors (the rid carry is also
the previous beat's in-flight result), each rid written exactly once —
by its PROBE slot if it is dirty, else by its COPY tile.  That rests on
a join's dirty rows being ascending and distinct (``FusedJoinIn``).

``delta_scan`` and ``delta_join`` are the chained delta ops (a backend
without ``fused_delta`` calls each once a beat, over every stage and
every partitioned join): the DIRTY and PROBE items as standalone
kernels in the same source (they replace the reference's
``delta_scan_pallas`` and ``delta_join_pallas``).  They write one output
row per slot, pad slots included, computed on the slot's row clamped
into range; ``delta_join`` routes inside its kernel.  ``delta_scan``
takes a tuple of ``backends.DeltaScanIn`` and covers up to
``DELTA_SCAN_STAGES`` stages a launch, a warp per slot of their flat
slot range (``delta_scan_blocks``); ``delta_join`` takes a tuple of
``backends.DeltaJoinIn`` and covers up to ``DELTA_JOINS`` joins a
launch, a lane per slot (``delta_join_blocks``), each routing its key
and binary-searching its bucket, so its buckets must be in
``storage.build_key_partitions``' layout
(``partitioned_join.buckets_ordered``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

PANE_TILE = 256            # kPaneTile in csrc/fused_delta.cu: a block's rows
COPY_TILE = 1024           # kCopyTile: rids one warp copies
MAX_STAGES = 16            # kMaxStages / kMaxJoins
MAX_JOINS = 16
# a pane tile's lo_p/hi_p pairs live in the block's shared memory:
# 2 * C * 32 * A int32 <= 48 KB
MAX_PANE_PREDICATES = 48 * 1024 // 8
WARPS = 8                  # warps a block (kWarpsPerBlock)
DELTA_SCAN_STAGES = 32     # kMaxDeltaStages: stages one delta_scan launch
                           # takes in its argument block
DELTA_JOINS = 32           # kMaxDeltaJoins: joins one delta_join launch
                           # takes in its argument block
THREADS = 256              # threads a block (kThreads)

_PANE, _DIRTY, _PROBE, _COPY = 0, 1, 2, 3


class ScanGeom(NamedTuple):
    """Static geometry of one predicated scan stage in the fused grid."""
    C: int        # predicated columns
    Q: int        # full window width (slots)
    A: int        # admission-pane words
    R: int        # pane tile rows (min(PANE_TILE, T))
    nt: int       # pane tiles (ceil(T / R))
    D: int        # dirty-row slots


class JoinGeom(NamedTuple):
    """Static geometry of one carried join in the fused grid."""
    B: int        # bucket pane width
    D: int        # dirty spine-row slots
    P: int        # bucket count (1 for block pseudo-partitions)


def scan_geometry(e) -> ScanGeom:
    """Geometry from a ``FusedScanIn``'s static shapes."""
    C, T = e.cols.shape
    R = min(PANE_TILE, T)
    return ScanGeom(C=C, Q=e.lo.shape[1], A=e.lo_p.shape[1] // 32,
                    R=R, nt=-(-T // R), D=e.rows.shape[0])


def join_geometry(e) -> JoinGeom:
    """Geometry from a ``FusedJoinIn``'s static shapes."""
    P, B = e.bkeys.shape
    return JoinGeom(B=B, D=e.rows.shape[0], P=P)


def copy_tiles(join_in) -> tuple:
    """Each join's COPY tile count, ceil(Tl / COPY_TILE)."""
    return tuple(-(-e.keys.shape[0] // COPY_TILE) for e in join_in)


def _segment(kind, owner, n, device):
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return torch.stack([torch.full_like(idx, kind),
                        torch.full_like(idx, owner), idx], 1)


@functools.lru_cache(maxsize=16)
def build_schedule(sgeom, jgeom, device):
    """The reference's schedule: int32[N, 3] rows of (kind, owner, idx) —
    one pane tile / dirty slot / probe slot each, in stage order.  Pure
    geometry (``sgeom``/``jgeom`` are tuples), made on ``device`` without
    a host copy and cached per geometry."""
    parts = []
    for s, g in enumerate(sgeom):
        parts.append(_segment(_PANE, s, g.nt, device))
        parts.append(_segment(_DIRTY, s, g.D, device))
    for j, g in enumerate(jgeom):
        parts.append(_segment(_PROBE, j, g.D, device))
    if not parts:
        return torch.zeros((0, 3), dtype=torch.int32, device=device)
    return torch.cat(parts)


@functools.lru_cache(maxsize=16)
def launch_schedule(sgeom, jgeom, ncopy, device):
    """The kernel's descriptor and its block-item count: (int32[N, 3],
    n_block).  ``build_schedule``'s rows reordered — every stage's PANE
    tiles (block items) first, then the warp items: each join's COPY
    tiles (``ncopy`` = ``copy_tiles``), each stage's DIRTY slots, each
    join's PROBE slots.  Cached per geometry."""
    sched = build_schedule(sgeom, jgeom, device)
    panes, dirty, at = [], [], 0
    for g in sgeom:
        panes.append(sched[at:at + g.nt])
        dirty.append(sched[at + g.nt:at + g.nt + g.D])
        at += g.nt + g.D
    copies = [_segment(_COPY, j, n, device) for j, n in enumerate(ncopy)]
    desc = torch.cat(panes + copies + dirty + [sched[at:]])
    return desc, sum(g.nt for g in sgeom)


def grid_blocks(n_block: int, n_warp: int, sms: int) -> int:
    """Blocks of one launch: enough for every block item or every warp
    item, at most ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor."""
    want = max(n_block, -(-n_warp // WARPS), 1)
    return min(want, sms * _k.BLOCKS_PER_SM)


class _ScanArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("cols", "lo", "hi", "lo_p", "hi_p", "valid", "carry",
                 "rows", "w0", "span", "dn")] + \
               [(n, ctypes.c_int) for n in ("C", "T", "Q", "A", "D")]


class _JoinArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("keys", "rows", "bkeys", "brows", "bounds", "rid_carry",
                 "rid", "dn")] + \
               [(n, ctypes.c_int) for n in ("Tl", "D", "P", "B")]


class _FusedArgs(ctypes.Structure):
    _fields_ = [("s", _ScanArgs * MAX_STAGES), ("j", _JoinArgs * MAX_JOINS),
                ("ns", ctypes.c_int), ("nj", ctypes.c_int)]


def _check_inputs(scan_in, join_in, dev):
    if len(scan_in) > MAX_STAGES or len(join_in) > MAX_JOINS:
        raise ValueError(f"fused_delta takes at most {MAX_STAGES} stages "
                         f"and {MAX_JOINS} joins, got {len(scan_in)} and "
                         f"{len(join_in)}")
    i32 = torch.int32
    for s, e in enumerate(scan_in):
        for t, name, nd in ((e.cols, "cols", 2), (e.lo, "lo", 2),
                            (e.hi, "hi", 2), (e.lo_p, "lo_p", 2),
                            (e.hi_p, "hi_p", 2), (e.carry, "carry", 2),
                            (e.rows, "rows", 1), (e.w0, "w0", 0),
                            (e.span, "span", 0), (e.dn, "dn", 0)):
            _k.require(t, i32, nd, f"scan_in[{s}].{name}", dev)
        _k.require(e.valid, torch.bool, 1, f"scan_in[{s}].valid", dev)
        C, T = e.cols.shape
        Q = e.lo.shape[1]
        if (e.lo.shape != (C, Q) or e.hi.shape != (C, Q) or Q % 32
                or e.lo_p.shape != e.hi_p.shape or e.lo_p.shape[0] != C
                or e.lo_p.shape[1] % 32 or e.lo_p.shape[1] > Q
                or e.carry.shape != (T, Q // 32) or e.valid.shape[0] != T
                or C < 1 or C * e.lo_p.shape[1] > MAX_PANE_PREDICATES):
            raise ValueError(f"fused_delta scan_in[{s}]: inconsistent "
                             f"shapes cols {tuple(e.cols.shape)} lo "
                             f"{tuple(e.lo.shape)} lo_p "
                             f"{tuple(e.lo_p.shape)} carry "
                             f"{tuple(e.carry.shape)} (pane predicates "
                             f"C * 32A <= {MAX_PANE_PREDICATES})")
    for j, e in enumerate(join_in):
        for t, name, nd in ((e.keys, "keys", 1), (e.rows, "rows", 1),
                            (e.bkeys, "bkeys", 2), (e.brows, "brows", 2),
                            (e.bounds, "bounds", 1),
                            (e.rid_carry, "rid_carry", 1), (e.dn, "dn", 0)):
            _k.require(t, i32, nd, f"join_in[{j}].{name}", dev)
        if (e.brows.shape != e.bkeys.shape
                or e.bounds.shape[0] != e.bkeys.shape[0]
                or e.bkeys.shape[0] < 1
                or e.rid_carry.shape != e.keys.shape):
            raise ValueError(f"fused_delta join_in[{j}]: inconsistent "
                             f"shapes")


def fused_delta(scan_in, join_in):
    """Tuples of backends.FusedScanIn / FusedJoinIn -> (merged words per
    stage, merged rids per join); contract of kernels/ref.fused_delta_ref.

    On CUDA the words are the stages' ``carry`` tensors, merged in place,
    and the rids are new tensors; the launch is the one device op."""
    scan_in, join_in = tuple(scan_in), tuple(join_in)
    if not scan_in and not join_in:
        return (), ()
    dev = (scan_in[0].cols if scan_in else join_in[0].keys).device
    if dev.type == "cpu":
        return ref.fused_delta_ref(scan_in, join_in)
    _check_inputs(scan_in, join_in, dev)
    sgeom = tuple(scan_geometry(e) for e in scan_in)
    jgeom = tuple(join_geometry(e) for e in join_in)
    desc, n_block = launch_schedule(sgeom, jgeom, copy_tiles(join_in), dev)
    _k.hold(desc)          # a captured launch reads it after any eviction
    rids = tuple(torch.empty_like(e.rid_carry) for e in join_in)

    args = _FusedArgs(ns=len(scan_in), nj=len(join_in))
    for s, (g, e) in enumerate(zip(sgeom, scan_in)):
        a = args.s[s]
        a.cols, a.lo, a.hi = e.cols.data_ptr(), e.lo.data_ptr(), \
            e.hi.data_ptr()
        a.lo_p, a.hi_p = e.lo_p.data_ptr(), e.hi_p.data_ptr()
        a.valid = e.valid.view(torch.uint8).data_ptr()
        a.carry, a.rows = e.carry.data_ptr(), e.rows.data_ptr()
        a.w0, a.span, a.dn = e.w0.data_ptr(), e.span.data_ptr(), \
            e.dn.data_ptr()
        a.C, a.T, a.Q, a.A, a.D = g.C, e.cols.shape[1], g.Q, g.A, g.D
    for j, (g, e, rid) in enumerate(zip(jgeom, join_in, rids)):
        a = args.j[j]
        a.keys, a.rows = e.keys.data_ptr(), e.rows.data_ptr()
        a.bkeys, a.brows = e.bkeys.data_ptr(), e.brows.data_ptr()
        a.bounds, a.rid_carry = e.bounds.data_ptr(), e.rid_carry.data_ptr()
        a.rid, a.dn = rid.data_ptr(), e.dn.data_ptr()
        a.Tl, a.D, a.P, a.B = e.keys.shape[0], g.D, g.P, g.B
    n_items = desc.shape[0]
    code = _k.library().shareddb_fused_delta(
        desc.data_ptr(), n_block, n_items,
        grid_blocks(n_block, n_items - n_block, _k.sm_count(dev)),
        max((8 * g.C * 32 * g.A for g in sgeom), default=0),
        ctypes.byref(args), _k.stream_of(desc))
    _k.count_launch("fused_delta")
    _k.check_launch(code, "fused_delta")
    return tuple(e.carry for e in scan_in), rids


class _DeltaStage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("cols", "lo", "hi", "valid", "rows", "out")] + \
               [(n, ctypes.c_int) for n in ("C", "T", "Q")]


class _DeltaScanArgs(ctypes.Structure):
    _fields_ = [("s", _DeltaStage * DELTA_SCAN_STAGES),
                ("start", ctypes.c_int * (DELTA_SCAN_STAGES + 1)),
                ("ns", ctypes.c_int)]


def delta_scan_blocks(slots: int, sms: int) -> int:
    """Blocks of one delta_scan launch over ``slots`` slots (a warp
    each): at most ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor."""
    return max(1, min(-(-slots // WARPS), sms * _k.BLOCKS_PER_SM))


def _groups(slots, per_launch: int) -> list:
    groups = []
    for g0 in range(0, len(slots), per_launch):
        start = [0]
        for d in slots[g0:g0 + per_launch]:
            start.append(start[-1] + d)
        if start[-1]:
            groups.append((g0, start))
    return groups


def delta_scan_groups(slots) -> list:
    """The launches of one ``delta_scan`` call, from each stage's slot
    count: (first stage, stage-start prefix sums) per launch, at most
    ``DELTA_SCAN_STAGES`` consecutive stages each; a group without a
    slot launches nothing."""
    return _groups(slots, DELTA_SCAN_STAGES)


def delta_join_groups(slots) -> list:
    """The launches of one ``delta_join`` call, from each join's slot
    count: (first join, join-start prefix sums) per launch, at most
    ``DELTA_JOINS`` consecutive joins each; a group without a slot
    launches nothing."""
    return _groups(slots, DELTA_JOINS)


def delta_join_blocks(slots: int, sms: int) -> int:
    """Blocks of one delta_join launch over ``slots`` slots (a lane
    each): at most ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor."""
    return max(1, min(-(-slots // THREADS), sms * _k.BLOCKS_PER_SM))


def _check_delta_scan(i, e, dev):
    for t, name in ((e.cols, "cols"), (e.lo, "lo"), (e.hi, "hi")):
        _k.require(t, torch.int32, 2, f"scan_in[{i}].{name}", dev)
    _k.require(e.valid, torch.bool, 1, f"scan_in[{i}].valid", dev)
    _k.require(e.rows, torch.int32, 1, f"scan_in[{i}].rows", dev)
    C, T = e.cols.shape
    Q = e.lo.shape[1]
    if (e.hi.shape != e.lo.shape or e.lo.shape[0] != C
            or e.valid.shape[0] != T or Q % 32 or C < 1 or T < 1):
        raise ValueError(f"delta_scan scan_in[{i}]: cols "
                         f"{tuple(e.cols.shape)}, lo {tuple(e.lo.shape)}, hi "
                         f"{tuple(e.hi.shape)}, valid {tuple(e.valid.shape)}:"
                         f" want C >= 1, T >= 1, Q % 32 == 0")


def delta_scan(scan_in):
    """A tuple of backends.DeltaScanIn (cols int32[C,T]; lo/hi
    int32[C,Q]; valid bool[T]; rows int32[D]) -> a tuple of int32[D,
    Q/32], one per stage; contract of kernels/ref.delta_scans_ref.  On
    CUDA: one launch per ``DELTA_SCAN_STAGES`` stages holding a slot."""
    scan_in = tuple(scan_in)
    if not scan_in:
        return ()
    dev = scan_in[0].cols.device
    if dev.type == "cpu":
        return ref.delta_scans_ref(scan_in)
    for i, e in enumerate(scan_in):
        _check_delta_scan(i, e, dev)
    outs = tuple(torch.empty((e.rows.shape[0], e.lo.shape[1] // 32),
                             dtype=torch.int32, device=dev) for e in scan_in)
    groups = delta_scan_groups([e.rows.shape[0] for e in scan_in])
    for g0, start in groups:
        args = _DeltaScanArgs(ns=len(start) - 1)
        for i, (e, out) in enumerate(zip(scan_in[g0:g0 + len(start) - 1],
                                         outs[g0:])):
            a = args.s[i]
            a.cols, a.lo, a.hi = e.cols.data_ptr(), e.lo.data_ptr(), \
                e.hi.data_ptr()
            a.valid = e.valid.view(torch.uint8).data_ptr()
            a.rows, a.out = e.rows.data_ptr(), out.data_ptr()
            a.C, a.T = e.cols.shape
            a.Q = e.lo.shape[1]
        args.start[:len(start)] = start
        code = _k.library().shareddb_delta_scan(
            ctypes.byref(args),
            delta_scan_blocks(start[-1], _k.sm_count(dev)),
            _k.stream_of(scan_in[0].cols))
        _k.count_launch("delta_scan")
        _k.check_launch(code, "delta_scan")
    return outs


class _DeltaJoin(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("keys", "rows", "bkeys", "brows", "bounds", "out")] + \
               [(n, ctypes.c_int) for n in ("Tl", "P", "B")]


class _DeltaJoinArgs(ctypes.Structure):
    _fields_ = [("j", _DeltaJoin * DELTA_JOINS),
                ("start", ctypes.c_int * (DELTA_JOINS + 1)),
                ("nj", ctypes.c_int)]


def _check_delta_join(i, e, dev):
    for t, name, nd in ((e.keys, "keys", 1), (e.rows, "rows", 1),
                        (e.bkeys, "bkeys", 2), (e.brows, "brows", 2),
                        (e.bounds, "bounds", 1)):
        _k.require(t, torch.int32, nd, f"join_in[{i}].{name}", dev)
    P, B = e.bkeys.shape
    if (e.brows.shape != e.bkeys.shape or e.bounds.shape[0] != P or P < 1
            or B < 1 or e.keys.shape[0] < 1):
        raise ValueError(
            f"delta_join join_in[{i}]: keys {tuple(e.keys.shape)}, buckets "
            f"{tuple(e.bkeys.shape)}/{tuple(e.brows.shape)}, bounds "
            f"{tuple(e.bounds.shape)}: want Tl, P, B >= 1")


def delta_join(join_in):
    """A tuple of backends.DeltaJoinIn (keys int32[Tl]; rows int32[D];
    buckets int32[P, B]; bounds int32[P]) -> a tuple of rid int32[D],
    one per join; contract of kernels/ref.delta_joins_ref.  On CUDA: one
    launch per ``DELTA_JOINS`` joins holding a slot.

    Precondition (not checked): every join's buckets are laid out as
    ``storage.build_key_partitions`` lays them out
    (``partitioned_join.buckets_ordered``), which the kernel's binary
    search inside a bucket rests on; the plain version scans the bucket
    and does not need it."""
    join_in = tuple(join_in)
    if not join_in:
        return ()
    dev = join_in[0].keys.device
    if dev.type == "cpu":
        return ref.delta_joins_ref(join_in)
    for i, e in enumerate(join_in):
        _check_delta_join(i, e, dev)
    outs = tuple(torch.empty((e.rows.shape[0],), dtype=torch.int32,
                             device=dev) for e in join_in)
    for g0, start in delta_join_groups([e.rows.shape[0] for e in join_in]):
        group = join_in[g0:g0 + len(start) - 1]
        args = _DeltaJoinArgs(nj=len(group))
        for i, (e, out) in enumerate(zip(group, outs[g0:])):
            a = args.j[i]
            a.keys, a.rows = e.keys.data_ptr(), e.rows.data_ptr()
            a.bkeys, a.brows = e.bkeys.data_ptr(), e.brows.data_ptr()
            a.bounds, a.out = e.bounds.data_ptr(), out.data_ptr()
            a.Tl = e.keys.shape[0]
            a.P, a.B = e.bkeys.shape
        args.start[:len(start)] = start
        code = _k.library().shareddb_delta_join(
            ctypes.byref(args),
            delta_join_blocks(start[-1], _k.sm_count(dev)),
            _k.stream_of(join_in[0].keys))
        _k.count_launch("delta_join")
        _k.check_launch(code, "delta_join")
    return outs
