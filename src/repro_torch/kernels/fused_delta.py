"""Fused delta heartbeat (the ``fused_delta`` op): the whole incremental
beat — every predicated stage's admission pane and dirty-row rescan,
every carried join's dirty-row probe — in ONE kernel launch.

The kernel is ``csrc/fused_delta.cu`` (it replaces the JAX package's
``repro/kernels/fused_delta.py::fused_delta_pallas``).  It walks the work
descriptor ``sdesc int32[N, 4] = (kind, owner, idx, gather)`` built here,
one thread block per row:

  kind 0 (PANE)  — pane tile ``idx`` (PANE_TILE rows) of stage ``owner``
  kind 1 (DIRTY) — dirty slot ``idx`` of stage ``owner``; ``gather`` is
                   the slot's row id, clamped into the padded tile range
  kind 2 (PROBE) — dirty slot ``idx`` of join ``owner``; ``gather`` is
                   the routed bucket of the slot's key

``build_schedule`` / ``build_sdesc`` are the reference's, in torch: the
schedule is pure geometry made with ``arange``/``full`` on the device and
the gather column is a device gather/``searchsorted``, so the descriptor
never crosses from the host and the beat never waits for it.

The kernel merges straight into the carries: the scan words in place
(the reference donates that carry half, so each beat's words become the
next beat's carry), the rids into fresh copies of the rid carry (its
tensors are also the previous beat's in-flight results).

``delta_scan`` and ``delta_join`` are the chained delta ops (a backend
without ``fused_delta`` calls them per stage and per join): the DIRTY
and PROBE blocks as standalone kernels in the same source (they replace
the reference's ``delta_scan_pallas`` and ``delta_join_pallas``).  They
write one output row per slot, pad slots included, computed on the
slot's row clamped into range; ``delta_join`` routes inside its kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

PANE_TILE = 256
MAX_STAGES = 16            # kMaxStages / kMaxJoins in csrc/fused_delta.cu
MAX_JOINS = 16

_PANE, _DIRTY, _PROBE = 0, 1, 2


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


@functools.lru_cache(maxsize=16)
def build_schedule(sgeom, jgeom, device):
    """The static part of the descriptor: int32[N, 3] rows of (kind,
    owner, idx) — one pane tile / dirty slot / probe slot per block, in
    stage order.  Pure geometry (``sgeom``/``jgeom`` are tuples), made on
    ``device`` without a host copy and cached per geometry."""
    parts = []

    def seg(kind, owner, n):
        idx = torch.arange(n, dtype=torch.int32, device=device)
        parts.append(torch.stack([torch.full_like(idx, kind),
                                  torch.full_like(idx, owner), idx], 1))

    for s, g in enumerate(sgeom):
        seg(_PANE, s, g.nt)
        seg(_DIRTY, s, g.D)
    for j, g in enumerate(jgeom):
        seg(_PROBE, j, g.D)
    if not parts:
        return torch.zeros((0, 3), dtype=torch.int32, device=device)
    return torch.cat(parts)


def build_sdesc(schedule, sgeom, jgeom, scan_rows, probe_buckets):
    """The full descriptor int32[N, 4] = (kind, owner, idx, gather): the
    schedule plus the runtime gather column — clamped dirty-row ids for
    DIRTY rows, routed bucket indices for PROBE rows, zeros for PANE."""
    dev = schedule.device
    gathers = []
    for g, rows in zip(sgeom, scan_rows):
        gathers.append(torch.zeros((g.nt,), dtype=torch.int32, device=dev))
        gathers.append(rows.clamp(0, g.nt * g.R - 1).to(torch.int32))
    gathers += [b.to(torch.int32) for b in probe_buckets]
    gather = torch.cat(gathers) if gathers else \
        torch.zeros((0,), dtype=torch.int32, device=dev)
    return torch.cat([schedule, gather[:, None]], dim=1)


def route_probes(join_in):
    """Each join's routed bucket per dirty slot (the PROBE gathers)."""
    out = []
    for e in join_in:
        P = e.bkeys.shape[0]
        kd = e.keys[e.rows.long().clamp(0, e.keys.shape[0] - 1)]
        b = torch.searchsorted(e.bounds, kd, right=True) - 1
        out.append(b.clamp(0, P - 1))
    return out


class _ScanArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("cols", "lo", "hi", "lo_p", "hi_p", "valid", "carry",
                 "rows", "scal")] + \
               [(n, ctypes.c_int) for n in ("C", "T", "Q", "A", "D", "nt")]


class _JoinArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("keys", "rows", "bkeys", "brows", "rid", "dn")] + \
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
                            (e.rows, "rows", 1)):
            _k.require(t, i32, nd, f"scan_in[{s}].{name}", dev)
        _k.require(e.valid, torch.bool, 1, f"scan_in[{s}].valid", dev)
        C, T = e.cols.shape
        Q = e.lo.shape[1]
        if (e.lo.shape != (C, Q) or e.hi.shape != (C, Q) or Q % 32
                or e.lo_p.shape != e.hi_p.shape or e.lo_p.shape[0] != C
                or e.lo_p.shape[1] % 32 or e.lo_p.shape[1] > Q
                or e.carry.shape != (T, Q // 32) or e.valid.shape[0] != T
                or C < 1):
            raise ValueError(f"fused_delta scan_in[{s}]: inconsistent "
                             f"shapes cols {tuple(e.cols.shape)} lo "
                             f"{tuple(e.lo.shape)} lo_p "
                             f"{tuple(e.lo_p.shape)} carry "
                             f"{tuple(e.carry.shape)}")
    for j, e in enumerate(join_in):
        for t, name, nd in ((e.keys, "keys", 1), (e.rows, "rows", 1),
                            (e.bkeys, "bkeys", 2), (e.brows, "brows", 2),
                            (e.bounds, "bounds", 1),
                            (e.rid_carry, "rid_carry", 1)):
            _k.require(t, i32, nd, f"join_in[{j}].{name}", dev)
        if (e.brows.shape != e.bkeys.shape
                or e.bounds.shape[0] != e.bkeys.shape[0]
                or e.rid_carry.shape != e.keys.shape):
            raise ValueError(f"fused_delta join_in[{j}]: inconsistent "
                             f"shapes")


def fused_delta(scan_in, join_in):
    """Tuples of backends.FusedScanIn / FusedJoinIn -> (merged words per
    stage, merged rids per join); contract of kernels/ref.fused_delta_ref.

    On CUDA the words are the stages' ``carry`` tensors, merged in place,
    and the rids are new tensors."""
    scan_in, join_in = tuple(scan_in), tuple(join_in)
    if not scan_in and not join_in:
        return (), ()
    dev = (scan_in[0].cols if scan_in else join_in[0].keys).device
    if dev.type == "cpu":
        return ref.fused_delta_ref(scan_in, join_in)
    _check_inputs(scan_in, join_in, dev)
    sgeom = tuple(scan_geometry(e) for e in scan_in)
    jgeom = tuple(join_geometry(e) for e in join_in)
    schedule = build_schedule(sgeom, jgeom, dev)
    sdesc = build_sdesc(schedule, sgeom, jgeom, [e.rows for e in scan_in],
                        route_probes(join_in))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    scal = torch.stack([torch.stack([e.w0, e.span, e.dn]).to(torch.int32)
                        for e in scan_in]) if scan_in else zero
    jdn = torch.stack([e.dn.to(torch.int32) for e in join_in]) \
        if join_in else zero
    rids = tuple(e.rid_carry.clone() for e in join_in)

    args = _FusedArgs(ns=len(scan_in), nj=len(join_in))
    for s, (g, e) in enumerate(zip(sgeom, scan_in)):
        a = args.s[s]
        a.cols, a.lo, a.hi = e.cols.data_ptr(), e.lo.data_ptr(), \
            e.hi.data_ptr()
        a.lo_p, a.hi_p = e.lo_p.data_ptr(), e.hi_p.data_ptr()
        a.valid = e.valid.view(torch.uint8).data_ptr()
        a.carry, a.rows = e.carry.data_ptr(), e.rows.data_ptr()
        a.scal = scal.data_ptr() + 12 * s
        a.C, a.T, a.Q, a.A, a.D, a.nt = g.C, e.cols.shape[1], g.Q, g.A, \
            g.D, g.nt
    for j, (g, e, rid) in enumerate(zip(jgeom, join_in, rids)):
        a = args.j[j]
        a.keys, a.rows = e.keys.data_ptr(), e.rows.data_ptr()
        a.bkeys, a.brows = e.bkeys.data_ptr(), e.brows.data_ptr()
        a.rid, a.dn = rid.data_ptr(), jdn.data_ptr() + 4 * j
        a.Tl, a.D, a.P, a.B = e.keys.shape[0], g.D, g.P, g.B
    code = _k.library().shareddb_fused_delta(
        sdesc.data_ptr(), sdesc.shape[0], ctypes.byref(args),
        _k.stream_of(sdesc))
    _k.LAUNCHES["fused_delta"] += 1
    _k.check_launch(code, "fused_delta")
    return tuple(e.carry for e in scan_in), rids


def delta_scan(cols, lo, hi, valid, rows):
    """cols int32[C,T]; lo/hi int32[C,Q]; valid bool[T]; rows int32[D]
    -> int32[D, Q/32]; contract of kernels/ref.delta_scan_ref."""
    if cols.device.type == "cpu":
        return ref.delta_scan_ref(cols, lo, hi, valid, rows)
    dev = cols.device
    for t, name in ((cols, "cols"), (lo, "lo"), (hi, "hi")):
        _k.require(t, torch.int32, 2, name, dev)
    _k.require(valid, torch.bool, 1, "valid", dev)
    _k.require(rows, torch.int32, 1, "rows", dev)
    C, T = cols.shape
    Q = lo.shape[1]
    if (hi.shape != lo.shape or lo.shape[0] != C or valid.shape[0] != T
            or Q % 32 or C < 1 or T < 1):
        raise ValueError(f"delta_scan: cols {tuple(cols.shape)}, lo "
                         f"{tuple(lo.shape)}, hi {tuple(hi.shape)}, valid "
                         f"{tuple(valid.shape)}: want C >= 1, T >= 1, "
                         f"Q % 32 == 0")
    D = rows.shape[0]
    out = torch.empty((D, Q // 32), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_delta_scan(
        cols.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        valid.view(torch.uint8).data_ptr(), rows.data_ptr(), out.data_ptr(),
        C, T, Q, D, _k.stream_of(cols))
    _k.LAUNCHES["delta_scan"] += 1
    _k.check_launch(code, "delta_scan")
    return out


def delta_join(keys_l, rows, bucket_keys, bucket_rows, bounds):
    """keys_l int32[Tl]; rows int32[D]; buckets int32[P, B]; bounds
    int32[P] -> rid int32[D]; contract of kernels/ref.delta_join_ref."""
    if keys_l.device.type == "cpu":
        return ref.delta_join_ref(keys_l, rows, bucket_keys, bucket_rows,
                                  bounds)
    dev = keys_l.device
    _k.require(keys_l, torch.int32, 1, "keys_l", dev)
    _k.require(rows, torch.int32, 1, "rows", dev)
    _k.require(bucket_keys, torch.int32, 2, "bucket_keys", dev)
    _k.require(bucket_rows, torch.int32, 2, "bucket_rows", dev)
    _k.require(bounds, torch.int32, 1, "bounds", dev)
    P, B = bucket_keys.shape
    Tl = keys_l.shape[0]
    if (bucket_rows.shape != bucket_keys.shape or bounds.shape[0] != P
            or P < 1 or Tl < 1):
        raise ValueError(
            f"delta_join: keys {tuple(keys_l.shape)}, buckets "
            f"{tuple(bucket_keys.shape)}/{tuple(bucket_rows.shape)}, "
            f"bounds {tuple(bounds.shape)}")
    D = rows.shape[0]
    rid = torch.empty((D,), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_delta_join(
        keys_l.data_ptr(), rows.data_ptr(), bucket_keys.data_ptr(),
        bucket_rows.data_ptr(), bounds.data_ptr(), rid.data_ptr(), Tl, D, P,
        B, _k.stream_of(keys_l))
    _k.LAUNCHES["delta_join"] += 1
    _k.check_launch(code, "delta_join")
    return rid
