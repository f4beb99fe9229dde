"""Kernel passes: static validation of the fused_delta kernel's launch
descriptor (``kernels/fused_delta.py::launch_schedule``).

The fused delta beat's correctness rests on a STATIC contract between
the descriptor ``desc int32[N, 3] = (kind, owner, idx)`` and the
kernel's walk (``csrc/fused_delta.cu``): the first ``n_block`` rows are
the PANE tiles, taken a block each; the rest are DIRTY / PROBE / COPY
items, taken a warp each; the grid has ``grid_blocks`` blocks.  The
descriptor is the reference's ``build_schedule`` reordered, plus COPY
tiles that carry every rid no live probe writes.  These passes re-derive
that contract from the same functions the wrapper ships and hold a given
descriptor to it — the one ``launch_schedule`` caches, on the CPU in the
tests or on the card in ``chip_smoke.py`` (passed in as an argument):

  * ``kernel-schedule-coverage`` — the non-COPY rows are a permutation of
    ``build_schedule``'s, and every pane tile, dirty slot, probe slot and
    rid tile is owned by exactly one row;
  * ``kernel-grid-length`` — the block-item prefix is exactly the pane
    tiles, the grid is ``grid_blocks``' within ``sm_count x
    BLOCKS_PER_SM``, and the geometry fits the kernel's compiled bounds
    (``MAX_STAGES``, ``MAX_JOINS``, ``MAX_PANE_PREDICATES``, the pane
    inside the window);
  * ``kernel-gather-bounds`` — every row, rid tile and bucket an item
    reads stays inside its extent, with the data-dependent indices (a
    dirty slot's row, a probe's routed bucket) taken at the far end of
    their extents (``synthesize_gathers``), as the reference's
    ``synthesize_sdesc`` does;
  * ``kernel-garbage-park`` — CUDA has no BlockSpec to park a write on,
    so the port's meaning is one writer per output: the descriptor's
    writes, replayed in numpy, give every scan-word row of every pane
    tile, every dirty slot and every rid exactly one writer (a live
    dirty row's PROBE, else the COPY tile that holds it).  This rests on
    each join's dirty rows being ascending and distinct (``FusedJoinIn``).
"""
from __future__ import annotations

from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.analysis_static.diagnostics import LintFinding
from repro_torch.analysis_static import registry as R
from repro_torch.analysis_static.registry import register_pass


class FusedGeometry(NamedTuple):
    """Everything the fused launch's shape depends on: the kernel's
    ``ScanGeom`` / ``JoinGeom`` tuples, each join's COPY tile count, and
    the row extents the items index (the stages' table rows, the joins'
    spine rows)."""
    sgeom: tuple
    jgeom: tuple
    ncopy: tuple
    T: tuple
    Tl: tuple


def geometry_from_lowered(lowered) -> FusedGeometry:
    """The fused geometry a delta-join beat over ``lowered`` launches
    with: one ``ScanGeom`` per predicated scan stage, one ``JoinGeom``
    per carried join (block joins arrive as single-bucket
    pseudo-partitions over the whole PK column)."""
    from repro_torch.kernels.fused_delta import (COPY_TILE, PANE_TILE,
                                                 JoinGeom, ScanGeom)
    cat = lowered.plan.catalog
    sgeom, T = [], []
    for st in lowered.scans:
        if not st.cols:
            continue
        rows = cat.schemas[st.table].capacity
        Rt = min(PANE_TILE, rows)
        sgeom.append(ScanGeom(
            C=len(st.cols), Q=st.q_window, A=st.delta_words, R=Rt,
            nt=-(-rows // Rt), D=cat.schemas[st.table].dirty_cap))
        T.append(rows)
    jgeom, Tl = [], []
    for j in lowered.joins:
        if j.kind == "gather":
            continue
        if j.kind == "partitioned":
            B, P = j.bucket_cap, j.n_partitions
        else:
            B, P = cat.schemas[j.pk_table].capacity, 1
        jgeom.append(JoinGeom(B=B, D=cat.schemas[j.spine].dirty_cap, P=P))
        Tl.append(cat.schemas[j.spine].capacity)
    return FusedGeometry(tuple(sgeom), tuple(jgeom),
                         tuple(-(-n // COPY_TILE) for n in Tl), tuple(T),
                         tuple(Tl))


def geometry_from_inputs(scan_in, join_in) -> FusedGeometry:
    """The geometry the ``fused_delta`` wrapper computes from one call's
    ``FusedScanIn`` / ``FusedJoinIn`` tuples."""
    from repro_torch.kernels import fused_delta as fd
    return FusedGeometry(
        tuple(fd.scan_geometry(e) for e in scan_in),
        tuple(fd.join_geometry(e) for e in join_in),
        fd.copy_tiles(join_in),
        tuple(int(e.cols.shape[1]) for e in scan_in),
        tuple(int(e.keys.shape[0]) for e in join_in))


def launch_descriptor(geom: FusedGeometry, device="cpu"
                      ) -> Tuple[np.ndarray, int]:
    """``launch_schedule``'s (cached) descriptor for ``geom`` on
    ``device``, copied to the host, and its block-item count."""
    from repro_torch.kernels.fused_delta import launch_schedule
    desc, n_block = launch_schedule(geom.sgeom, geom.jgeom, geom.ncopy,
                                    device)
    return desc.cpu().numpy(), int(n_block)


def _extents(geom: FusedGeometry) -> dict:
    """(kind, owner) -> how many units of it the descriptor must own."""
    from repro_torch.kernels.fused_delta import _COPY, _DIRTY, _PANE, _PROBE
    ext = {}
    for s, g in enumerate(geom.sgeom):
        ext[(_PANE, s)] = g.nt
        ext[(_DIRTY, s)] = g.D
    for j, g in enumerate(geom.jgeom):
        ext[(_PROBE, j)] = g.D
        ext[(_COPY, j)] = geom.ncopy[j]
    return ext


def _as_desc(desc) -> np.ndarray:
    if hasattr(desc, "cpu"):
        desc = desc.cpu().numpy()
    return np.asarray(desc)


@register_pass("fused-schedule", "kernel",
               (R.KERNEL_SCHEDULE_COVERAGE, R.KERNEL_GRID_LENGTH),
               "descriptor covers every unit once; block prefix, grid, "
               "compiled bounds")
def lint_fused_schedule(geom: FusedGeometry, desc, n_block: int,
                        sms: Optional[int] = None,
                        location: str = "fused") -> List[LintFinding]:
    """Every pane tile, dirty slot, probe slot and rid tile of every
    owner is covered by EXACTLY one descriptor row, the non-COPY rows
    are ``build_schedule``'s, the first ``n_block`` rows are exactly the
    PANE tiles, and the launch fits the kernel (with ``sms``, also the
    grid ``grid_blocks`` gives on that many streaming multiprocessors)."""
    from repro_torch import kernels as K
    from repro_torch.kernels import fused_delta as fd
    out = []

    def bad(rule, msg):
        out.append(LintFinding(rule, msg, location=location))

    desc = _as_desc(desc)
    if desc.ndim != 2 or desc.shape[1] != 3:
        bad(R.KERNEL_GRID_LENGTH,
            f"descriptor shape {desc.shape} is not [N, 3]")
        return out
    ext = _extents(geom)
    N = desc.shape[0]
    want_n = sum(ext.values())
    if N != want_n:
        bad(R.KERNEL_GRID_LENGTH,
            f"descriptor has {N} rows but the geometry demands {want_n} "
            "items")
    want_block = sum(g.nt for g in geom.sgeom)
    kinds = desc[:, 0]
    if n_block != want_block:
        bad(R.KERNEL_GRID_LENGTH,
            f"block-item count {n_block} != the {want_block} pane tiles")
    if (kinds[:n_block] != fd._PANE).any() or \
            (kinds[n_block:] == fd._PANE).any():
        bad(R.KERNEL_GRID_LENGTH,
            f"the first {n_block} rows are not exactly the PANE tiles "
            "(a block item would run as a warp item, or the reverse)")
    # the kernel's compiled bounds
    if len(geom.sgeom) > fd.MAX_STAGES or len(geom.jgeom) > fd.MAX_JOINS:
        bad(R.KERNEL_GRID_LENGTH,
            f"{len(geom.sgeom)} stages / {len(geom.jgeom)} joins exceed "
            f"the kernel's {fd.MAX_STAGES} / {fd.MAX_JOINS}")
    for s, g in enumerate(geom.sgeom):
        if g.C * 32 * g.A > fd.MAX_PANE_PREDICATES:
            bad(R.KERNEL_GRID_LENGTH,
                f"stage {s}: {g.C * 32 * g.A} pane predicates exceed the "
                f"kernel's shared staging ({fd.MAX_PANE_PREDICATES})")
        if g.Q % 32 or not 1 <= g.A <= g.Q // 32:
            bad(R.KERNEL_GRID_LENGTH,
                f"stage {s}: a {g.A}-word pane does not fit its "
                f"{g.Q // 32}-word window")
    for j, g in enumerate(geom.jgeom):
        if g.P < 1 or g.B < 1:
            bad(R.KERNEL_GRID_LENGTH,
                f"join {j}: degenerate buckets {g.P}x{g.B}")
    if sms is not None:
        blocks = fd.grid_blocks(n_block, N - n_block, sms)
        cap = sms * K.BLOCKS_PER_SM
        if not 1 <= blocks <= cap:
            bad(R.KERNEL_GRID_LENGTH,
                f"grid of {blocks} blocks outside [1, {cap}] "
                f"({sms} SMs x {K.BLOCKS_PER_SM})")
        # the grid must reach every item: the block items a block
        # each, the warp items a warp each, grid-stride loops
        if blocks < min(max(n_block, 1), cap):
            bad(R.KERNEL_GRID_LENGTH,
                f"grid of {blocks} blocks for {n_block} block items")
    # coverage: exactly one row per unit
    seen = Counter()
    for kind, owner, idx in desc:
        key = (int(kind), int(owner))
        if key not in ext:
            bad(R.KERNEL_SCHEDULE_COVERAGE,
                f"descriptor row targets unknown (kind, owner) {key}")
            continue
        if not 0 <= int(idx) < ext[key]:
            bad(R.KERNEL_SCHEDULE_COVERAGE,
                f"descriptor row (kind {key[0]}, owner {key[1]}) indexes "
                f"{int(idx)} outside [0, {ext[key]})")
            continue
        seen[(key, int(idx))] += 1
    for key, extent in ext.items():
        for idx in range(extent):
            n = seen.get((key, idx), 0)
            if n != 1:
                bad(R.KERNEL_SCHEDULE_COVERAGE,
                    f"(kind {key[0]}, owner {key[1]}) unit {idx} is "
                    f"covered by {n} descriptor rows (want exactly 1)")
    # the COPY tiles of a join cover its rids [0, Tl) and no more
    for j, n in enumerate(geom.ncopy):
        Tl = geom.Tl[j]
        if n * fd.COPY_TILE < Tl or (n and (n - 1) * fd.COPY_TILE >= Tl):
            bad(R.KERNEL_SCHEDULE_COVERAGE,
                f"join {j}: {n} COPY tiles of {fd.COPY_TILE} rids do not "
                f"tile its {Tl} rids")
    # the non-COPY rows: a permutation of the reference's schedule
    sched = fd.build_schedule(geom.sgeom, geom.jgeom, "cpu").numpy()
    mine = desc[kinds != fd._COPY]
    if sorted(map(tuple, mine.tolist())) != \
            sorted(map(tuple, sched.tolist())):
        bad(R.KERNEL_SCHEDULE_COVERAGE,
            "the non-COPY rows are not a permutation of build_schedule's")
    return out


def synthesize_gathers(geom: FusedGeometry, desc) -> np.ndarray:
    """int64[N, 2]: (row, bucket) each descriptor row reads, worst case:
    a PANE tile's first row, a COPY tile's first rid, a DIRTY slot's row
    at the far end of its stage's rows (T - 1), a PROBE slot's spine row
    at Tl - 1 routed to the last bucket (P - 1); bucket -1 where the
    item reads none.  The CPU replay of the walk
    (``tests/test_torch_kernels.py::_fused_walk``) reads exactly these
    indices."""
    from repro_torch.kernels import fused_delta as fd
    desc = _as_desc(desc)
    out = np.full((desc.shape[0], 2), -1, np.int64)
    for i, (kind, owner, idx) in enumerate(desc.tolist()):
        if kind == fd._PANE and owner < len(geom.sgeom):
            out[i, 0] = idx * fd.PANE_TILE
        elif kind == fd._DIRTY and owner < len(geom.sgeom):
            out[i, 0] = geom.T[owner] - 1
        elif kind == fd._PROBE and owner < len(geom.jgeom):
            out[i] = (geom.Tl[owner] - 1, geom.jgeom[owner].P - 1)
        elif kind == fd._COPY and owner < len(geom.jgeom):
            out[i, 0] = idx * fd.COPY_TILE
    return out


@register_pass("gather-bounds", "kernel", (R.KERNEL_GATHER_BOUNDS,),
               "rows, rid tiles and buckets read in bounds")
def lint_gather_bounds(geom: FusedGeometry, desc, gathers,
                       location: str = "fused") -> List[LintFinding]:
    """Every index an item dereferences stays inside its tensor: a
    DIRTY / PROBE slot inside the dirty-row set (D), a dirty row inside
    its table (T), a probe's spine row inside the rids (Tl) and its
    bucket inside the partitions (P), a PANE tile's first row inside the
    table and a COPY tile's first rid inside the rids."""
    from repro_torch.kernels import fused_delta as fd
    desc, gathers = _as_desc(desc), np.asarray(gathers)
    out = []

    def bad(msg):
        out.append(LintFinding(R.KERNEL_GATHER_BOUNDS, msg,
                               location=location))

    if gathers.shape != (desc.shape[0], 2):
        bad(f"gathers shape {gathers.shape} != ({desc.shape[0]}, 2)")
        return out
    for (kind, owner, idx), (row, bucket) in zip(desc.tolist(),
                                                 gathers.tolist()):
        if kind in (fd._PANE, fd._DIRTY) and 0 <= owner < len(geom.sgeom):
            g, T = geom.sgeom[owner], geom.T[owner]
            if kind == fd._DIRTY and not 0 <= idx < g.D:
                bad(f"dirty slot {idx} of scan {owner} escapes [0, {g.D})")
            if not 0 <= row < T:
                what = "pane tile row" if kind == fd._PANE else "dirty row"
                bad(f"{what} {row} of scan {owner} escapes [0, {T})")
        elif kind in (fd._PROBE, fd._COPY) and \
                0 <= owner < len(geom.jgeom):
            g, Tl = geom.jgeom[owner], geom.Tl[owner]
            if kind == fd._PROBE:
                if not 0 <= idx < g.D:
                    bad(f"probe slot {idx} of join {owner} escapes "
                        f"[0, {g.D})")
                if not 0 <= bucket < g.P:
                    bad(f"probe bucket {bucket} of join {owner} escapes "
                        f"[0, {g.P})")
            if not 0 <= row < Tl:
                what = "probe row" if kind == fd._PROBE else "COPY tile rid"
                bad(f"{what} {row} of join {owner} escapes [0, {Tl})")
    return out


def synthesize_dirty_rows(geom: FusedGeometry) -> Tuple[np.ndarray, ...]:
    """Each join's worst-case dirty-row set: D live rows at the far end
    of its spine, ascending and distinct (``FusedJoinIn``'s
    precondition), the pads the sentinel Tl."""
    out = []
    for g, Tl in zip(geom.jgeom, geom.Tl):
        live = np.arange(max(0, Tl - g.D), Tl, dtype=np.int64)
        out.append(np.concatenate(
            [live, np.full(g.D - len(live), Tl, np.int64)]))
    return tuple(out)


@register_pass("one-writer", "kernel", (R.KERNEL_GARBAGE_PARK,),
               "every scan-word row and every rid has one writer")
def lint_garbage_park(geom: FusedGeometry, desc, dirty_rows=None,
                      location: str = "fused") -> List[LintFinding]:
    """Replay the descriptor's writes in numpy: every row of every stage
    gets its pane words from exactly one PANE item, every dirty slot is
    rescanned by exactly one DIRTY item, and every rid of every join is
    written exactly once — by the PROBE of a live dirty row, else by the
    COPY tile that holds it (which skips the dirty rows it finds by
    binary search, as the kernel does).  ``dirty_rows`` (one int array
    per join, sentinel-padded) defaults to ``synthesize_dirty_rows``; a
    set that is not ascending and distinct breaks the COPY tiles' search
    and is reported."""
    from repro_torch.kernels import fused_delta as fd
    desc = _as_desc(desc)
    out = []

    def bad(msg):
        out.append(LintFinding(R.KERNEL_GARBAGE_PARK, msg,
                               location=location))

    pane_w = [np.zeros(T, np.int64) for T in geom.T]
    dirty_w = [np.zeros(g.D, np.int64) for g in geom.sgeom]
    rid_w = [np.zeros(Tl, np.int64) for Tl in geom.Tl]
    rows = [np.asarray(r, np.int64) for r in
            (synthesize_dirty_rows(geom) if dirty_rows is None
             else dirty_rows)]
    live = []
    for j, (r, Tl) in enumerate(zip(rows, geom.Tl)):
        real = r[(r >= 0) & (r < Tl)]
        if (np.diff(real) <= 0).any() or \
                (real.size and (r[:real.size] != real).any()):
            bad(f"dirty rows of join {j} are not ascending and distinct "
                "ahead of their pads: a COPY tile's binary search would "
                "miss one and write it a second time")
        live.append(real)
    for kind, owner, idx in desc.tolist():
        if kind == fd._PANE and 0 <= owner < len(geom.sgeom):
            a = idx * fd.PANE_TILE
            pane_w[owner][a:min(a + fd.PANE_TILE, geom.T[owner])] += 1
        elif kind == fd._DIRTY and 0 <= owner < len(geom.sgeom):
            if 0 <= idx < geom.sgeom[owner].D:
                dirty_w[owner][idx] += 1
        elif kind == fd._PROBE and 0 <= owner < len(geom.jgeom):
            if 0 <= idx < len(live[owner]):
                rid_w[owner][live[owner][idx]] += 1
        elif kind == fd._COPY and 0 <= owner < len(geom.jgeom):
            a = idx * fd.COPY_TILE
            b = min(a + fd.COPY_TILE, geom.Tl[owner])
            if a >= b:
                continue
            i = np.arange(a, b)
            near = live[owner][(live[owner] >= a) & (live[owner] < b)]
            rid_w[owner][i[~np.isin(i, near)]] += 1

    def report(label, counts):
        for n, what in ((0, "no writer"), (2, "several writers")):
            hit = np.flatnonzero(counts == n if n == 0 else counts >= n)
            if hit.size:
                bad(f"{hit.size} {label} with {what} (e.g. "
                    f"{int(hit[0])}, written {int(counts[hit[0]])} times)")

    for s, c in enumerate(pane_w):
        report(f"rows of scan {s}'s pane tiles", c)
    for s, c in enumerate(dirty_w):
        report(f"dirty slots of scan {s}", c)
    for j, c in enumerate(rid_w):
        report(f"rids of join {j}", c)
    return out


def run_kernel_passes(geom: FusedGeometry, desc, n_block: int,
                      sms: Optional[int] = None, dirty_rows=None,
                      location: str = "fused") -> List[LintFinding]:
    """The full kernel bundle for one fused geometry against a launch
    descriptor (``launch_descriptor``'s) and its block-item count."""
    if not geom.sgeom and not geom.jgeom:
        return []
    desc = _as_desc(desc)
    return (lint_fused_schedule(geom, desc, n_block, sms=sms,
                                location=location)
            + lint_gather_bounds(geom, desc, synthesize_gathers(geom, desc),
                                 location=location)
            + lint_garbage_park(geom, desc, dirty_rows, location=location))
