"""Trace passes: what a beat's body actually runs, recorded op by op —
the port's counterpart of the JAX package's ``jaxpr_passes``.

No jaxpr exists here, so ``record_beats`` runs one body of each cycle
flavour (full, delta, delta_join) of a built engine under a
``TorchDispatchMode`` recorder (``OpRecorder``) that keeps the output
shape of every range compare / key-equality op and the storage of every
tensor an op writes in place.  The bodies are the executor's own
(``SharedDBEngine._body``, the one a graph captures) on clones of the
engine's state, carry and results, with the engine's staged admission;
they run eagerly and nothing is captured.  Their cycles are rebuilt on
the ``torch`` backend, the plain version of every kernel: a hand-written
kernel's body is opaque to the recorder (its launch goes through
ctypes), so under ``hopper`` the recorder would see no compare inside
``fused_delta`` and no in-place merge of the carried words.

  * ``jaxpr-delta-width`` — steady state never pays window width: no
    ``ge`` / ``le`` range compare of a forbidden (rows, q_window) shape
    (and, on the delta-join flavour, no full-spine ``eq`` probe) is
    recorded on the delta path.  The forbidden and legitimate shape sets
    are the reference's (``_width_shape_sets`` / ``_probe_shape_sets``);
    a forbidden shape that collides with a legitimate one is reported as
    an info-severity ambiguity.
  * ``jaxpr-donated-alias`` — the port's fixed beat buffers (a captured
    graph reads and writes the same addresses every replay) in place of
    jit's donation: every slot's results, the scan carry, every slot's
    staging and the state occupy pairwise disjoint storage
    (``lint_buffer_aliasing``); a body never writes the rid carry it
    reads (the previous slot's in-flight results) nor anything of
    another slot; and the cycle arguments a body writes in place are
    exactly ``executor.DONATION_SPEC``'s (``lint_donation``).
  * ``jaxpr-delta-collective`` — on a sharded engine (``mesh=``) a delta
    or delta_join beat records no collective op (``all_gather_rows`` or
    a ``torch.distributed`` one), and each shard's ops touch only that
    shard's storages: its state, carry, rids, results and staged copy,
    its constants and what its own ops made (``lint_shard_locality``).
    Shards that share a card could otherwise read each other with a
    plain index op, so this is the torch meaning of "shard-local".
  * ``jaxpr-reseed-collective`` — a reseed records exactly one
    ``all_gather_rows`` per mirrored predicated stage, over per-shard
    operands of ``[Ts_mirror, w]``, and no read across shards besides.

Under a mesh the width sets take the ``ShardSpec``'s padded and
per-shard row counts too, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis_static.diagnostics import LintFinding
from repro_torch.analysis_static import registry as R
from repro_torch.analysis_static.registry import register_pass
from repro_torch.core.sharding import current_shard

COMPARES = ("ge", "le", "eq")
#: Ops that move data between shards, by dispatch name (trailing
#: underscores stripped): the port's one collective and the c10d ones.
COLLECTIVES = ("all_gather_rows", "all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast",
               "allgather", "allreduce", "reduce_scatter", "alltoall",
               "_allgather_base", "_reduce_scatter_base", "send", "recv")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def storage_key(t: torch.Tensor) -> Tuple[int, int]:
    """(first byte, end byte) of the storage a tensor lives in."""
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


class OpRecorder(TorchDispatchMode):
    """Records, per ATen op run inside it: the output shape of every
    ``ge`` / ``le`` / ``eq`` (``compares``, (op, shape) pairs), the
    storage of every argument the op's schema marks as written
    (``written``: the in-place and ``out=`` ops), every collective op
    with its operands' shapes (``collectives``) and with the bytes of its
    first output, one device's (``collective_bytes``, (op, bytes) pairs:
    the gathered tensor of an all-gather).

    ``shards=True`` also records, for each op run inside a
    ``sharding.shard_scope``, its shard and the storages of all its
    tensor arguments and outputs (``shard_ops``); it then holds every
    tensor it saw until it is dropped, so no storage is freed and its
    address reused by another shard's temporary within one recording."""

    def __init__(self, shards: bool = False):
        super().__init__()
        self.compares: List[Tuple[str, Tuple[int, ...]]] = []
        self.written: Set[Tuple[int, int]] = set()
        self.collectives: List[Tuple[str, Tuple[Tuple[int, ...], ...]]] = []
        self.collective_bytes: List[Tuple[str, int]] = []
        self.shard_ops: List[Tuple[str, int, Set[Tuple[int, int]]]] = []
        self._held: Optional[list] = [] if shards else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        if name in COMPARES and isinstance(out, torch.Tensor):
            self.compares.append((name, tuple(out.shape)))
        if name in COLLECTIVES:
            self.collectives.append((name, tuple(
                tuple(t.shape) for t in _tensors(args))))
            first = next(_tensors(out), None)
            self.collective_bytes.append((name, 0 if first is None else
                                          first.numel()
                                          * first.element_size()))
        if self._held is not None:
            seen = [t for t in _tensors((args, tuple(kwargs.values()), out))
                    if t.numel()]
            self._held.extend(seen)
            shard = current_shard()
            if shard is not None:
                self.shard_ops.append(
                    (name, shard, {storage_key(t) for t in seen}))
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(val):
                if t.numel():
                    self.written.add(storage_key(t))
        return out


@dataclasses.dataclass
class BeatRecord:
    """One recorded body: its compares, which of the body's buffers it
    wrote in place (labels from ``_buffer_labels``), its collectives and,
    on a sharded engine, its shard-scoped ops and the storages each
    shard owns from the start (``_shard_owners``); ``collective_bytes``
    are the collectives' (op, one device's output bytes), what
    ``roofline.collective_schedule`` takes."""
    flavour: str
    compares: List[Tuple[str, Tuple[int, ...]]]
    wrote: Set[str]
    collectives: List[Tuple[str, Tuple[Tuple[int, ...], ...]]] = \
        dataclasses.field(default_factory=list)
    shard_ops: List[Tuple[str, int, Set[Tuple[int, int]]]] = \
        dataclasses.field(default_factory=list)
    owners: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)
    collective_bytes: List[Tuple[str, int]] = \
        dataclasses.field(default_factory=list)


def _leaves(tree):
    from repro_torch.core.graphs import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


#: Each cycle flavour's positional arguments, by buffer label (the staged
#: admission's queries and updates share two flat device buffers, so one
#: label covers both).
CYCLE_ARGS = {"full": ("state", "queries", "updates"),
              "delta": ("state", "carry", "queries", "updates"),
              "delta_join": ("state", "carry", "rids", "queries",
                             "updates")}
#: Arguments reachable through another live reference: the rid carry (the
#: previous slot's in-flight results) and the staged admission (reused
#: by its slot's next beat); donating one is a use-after-donate.
ALIASED = {"rids": "rid carry (aliases the previous beat's in-flight "
                   "results)",
           "queries": "staged queries", "updates": "staged updates"}


def _written_args(flavour: str, wrote: Set[str]) -> Set[int]:
    """The flavour's arguments among the buffer labels a body wrote."""
    names = CYCLE_ARGS[flavour]
    hit = set()
    for label in wrote:
        for name in (("queries", "updates") if label == "staged"
                     else (label,)):
            if name in names:
                hit.add(names.index(name))
    return hit


def _buffer_labels(buf, staging, slot: int) -> Dict[Tuple[int, int], str]:
    """Storage -> label, for the buffers one body of slot ``slot`` sees:
    "state", "carry", "rids" (slot - 1's ``_join_rids``, the rid carry
    read), "out" (slot's results), "staged" (slot's admission) and
    "other slot" (every other slot's results and staging)."""
    n = len(buf.results)
    labels = {}

    def put(tree, label):
        for t in _leaves(tree):
            if t.numel():
                labels.setdefault(storage_key(t), label)
    put(buf.results[(slot - 1) % n]["_join_rids"], "rids")
    put(buf.state, "state")
    put(buf.carry, "carry")
    put(buf.results[slot], "out")
    put(staging[slot].staged, "staged")
    for s in range(n):
        if s != slot:
            put(buf.results[s], "other slot")
            put(staging[s].staged, "other slot")
    return labels


def _shard_owners(buf, staging, slot: int, n_shards: int
                  ) -> Dict[Tuple[int, int], int]:
    """Storage -> shard, for the per-shard buffers one body of slot
    ``slot`` sees: each shard's state, carry, rid carry read, results
    written and staged admission copy."""
    n = len(buf.results)
    owners = {}
    for i in range(n_shards):
        for tree in (buf.state[i], buf.carry[i],
                     buf.results[(slot - 1) % n]["_join_rids"][i],
                     buf.results[slot]["_join_rids"][i],
                     buf.results[slot]["_shard"][i], staging[slot].staged[i]):
            for t in _leaves(tree):
                if t.numel():
                    owners[storage_key(t)] = i
    return owners


def record_beats(eng) -> Dict[str, BeatRecord]:
    """One body of each flavour of ``eng``'s installed generation, run
    in order (full seeds the carry the delta flavours read) on clones of
    its state, carry and results, with its cycles rebuilt on the
    ``torch`` backend (the sharded flavours on a mesh engine); slot 1's
    staged admission in, slot 0's rids read.  Nothing of the engine
    changes and no kernel launches.  Raises on an engine with one
    pipeline slot."""
    from repro_torch import kernels as K
    from repro_torch.core import sharding
    from repro_torch.core.backends import get_backend
    from repro_torch.core.executor import FLAVOURS, _BeatBuffers
    from repro_torch.core.graphs import clone_tree
    from repro_torch.core.lowering import build_cycle, build_delta_cycle
    h = eng._gen
    if len(h.results) < 2:
        raise ValueError("record_beats needs two pipeline slots or more")
    be, dev, spec = get_backend("torch"), eng.device, h.spec
    if spec is None:
        cycles = {"full": build_cycle(h.lowered, be, dev),
                  "delta": build_delta_cycle(h.lowered, be, device=dev),
                  "delta_join": build_delta_cycle(
                      h.lowered, be, delta_joins=True, device=dev)}
    else:
        cycles = {"full": sharding.build_sharded_cycle(h.lowered, be, spec),
                  "delta": sharding.build_sharded_delta_cycle(
                      h.lowered, be, spec),
                  "delta_join": sharding.build_sharded_delta_cycle(
                      h.lowered, be, spec, delta_joins=True)}
    twin = dataclasses.replace(h, cycles=cycles, graphs={})
    buf = _BeatBuffers(clone_tree(eng.state), clone_tree(h.carry),
                       [clone_tree(r) for r in h.results])
    slot = 1
    labels = _buffer_labels(buf, h.staging, slot)
    owners = {} if spec is None else \
        _shard_owners(buf, h.staging, slot, spec.n_shards)
    out = {}
    with K.recording():
        for f in FLAVOURS:
            with OpRecorder(shards=spec is not None) as rec:
                eng._body(twin, buf, f, slot)
            out[f] = BeatRecord(f, rec.compares,
                                {labels[k] for k in rec.written
                                 if k in labels},
                                rec.collectives, rec.shard_ops, owners,
                                rec.collective_bytes)
    return out


# ---------------------------------------------------------------------------
# Width classifier
# ---------------------------------------------------------------------------


def _row_candidates(lowered, table: str, spec=None) -> Set[int]:
    """Row extents a compare over ``table`` could legitimately carry:
    the schema capacity and, under a mesh, the padded and per-shard
    extents."""
    cap = lowered.plan.catalog.schemas[table].capacity
    cands = {cap}
    if spec is not None:
        cands.add(spec.padded.get(table, cap))
        cands.add(spec.shard_rows.get(table, cap))
    return cands


def _width_shape_sets(lowered, spec=None
                      ) -> Tuple[Dict[Tuple[int, int], str],
                                 Set[Tuple[int, int]]]:
    """(forbidden shapes -> stage location, legitimate shapes), the
    reference's split (``spec``: a mesh's row counts too).

    Forbidden: a range compare at (table rows, FULL stage q_window) for
    any stage whose pane is narrower than its window — the full-rescan
    work shape, unreachable from a delta beat.  Legitimate: admission
    pane compares (rows, 32*delta_words) and dirty-set re-evals."""
    cat = lowered.plan.catalog
    legit: Set[Tuple[int, int]] = set()
    for st in lowered.scans:
        if not st.cols:
            continue
        for rows in _row_candidates(lowered, st.table, spec):
            legit.add((rows, 32 * st.delta_words))
        legit.add((cat.schemas[st.table].dirty_cap, st.q_window))
        legit.add((1, st.q_window))
    forbidden: Dict[Tuple[int, int], str] = {}
    for st in lowered.scans:
        if not st.cols or 32 * st.delta_words >= st.q_window:
            continue                          # pane IS the window: exempt
        for rows in _row_candidates(lowered, st.table, spec):
            forbidden[(rows, st.q_window)] = f"scan[{st.table}]"
    return forbidden, legit


def _probe_shape_sets(lowered, update_slots=None, spec=None
                      ) -> Tuple[Dict[Tuple[int, int], str],
                                 Set[Tuple[int, int]]]:
    """Same split for join probes on the delta-join path: a full-probe
    ``eq`` pane is (spine rows, bucket width); the delta path probes
    only (dirty rows, one bucket).  The update path's key-locate scans
    on index-less PK tables ((update slots, table rows) ``eq``s) run on
    EVERY beat and are legitimate."""
    cat = lowered.plan.catalog
    legit: Set[Tuple[int, int]] = set()
    forbidden: Dict[Tuple[int, int], str] = {}
    if update_slots is not None:
        for t, schema in cat.schemas.items():
            if schema.pk and not schema.indexed:
                for rows in _row_candidates(lowered, t, spec):
                    legit.add((update_slots.n_update, rows))
                    legit.add((update_slots.n_delete, rows))
    for j in lowered.joins:
        if j.kind == "gather":
            continue
        dirty = cat.schemas[j.spine].dirty_cap
        widths = {j.bucket_cap} if j.kind == "partitioned" \
            else _row_candidates(lowered, j.pk_table, spec)
        for w in widths:
            legit.add((dirty, w))
            legit.add((1, w))
            for rows in _row_candidates(lowered, j.spine, spec):
                forbidden[(rows, w)] = f"join[{j.spine}->{j.pk_table}]"
    return forbidden, legit


@register_pass("delta-width", "jaxpr", (R.JAXPR_DELTA_WIDTH,),
               "no full-window compare/probe recorded on the delta path")
def lint_delta_width(compares: Sequence[Tuple[str, Tuple[int, ...]]],
                     lowered, *, delta_joins: bool = False,
                     update_slots=None, spec=None,
                     location: str = "delta") -> List[LintFinding]:
    """No full-window range compare (and, on the delta-join flavour, no
    full-spine probe) among a delta beat's recorded ``compares``
    (``spec``: a mesh's padded and per-shard row counts as well)."""
    out = []
    forbidden, legit = _width_shape_sets(lowered, spec)
    prims = {"ge", "le"}
    if delta_joins:
        pf, pl_ = _probe_shape_sets(lowered, update_slots, spec)
        for shape, loc in pf.items():
            forbidden.setdefault(shape, loc)
        legit |= pl_
        prims.add("eq")
    ambiguous = set(forbidden) & legit
    for shape in sorted(ambiguous):
        out.append(LintFinding(
            R.JAXPR_DELTA_WIDTH,
            f"shape {shape} is both a full-window and a legitimate "
            "delta compare at this scale — not statically classifiable",
            severity="info", location=forbidden[shape]))
    check = {s: loc for s, loc in forbidden.items() if s not in ambiguous}
    hits: Dict[Tuple[int, int], int] = {}
    for op, shape in compares:
        if op in prims and len(shape) == 2 and shape in check:
            hits[shape] = hits.get(shape, 0) + 1
    for shape, n in sorted(hits.items()):
        out.append(LintFinding(
            R.JAXPR_DELTA_WIDTH,
            f"{n} full-window compare(s) of shape {shape} reachable "
            "on the delta path", location=f"{location} {check[shape]}"))
    return out


# ---------------------------------------------------------------------------
# Collectives and shard locality (a sharded engine's beats)
# ---------------------------------------------------------------------------


def lint_shard_locality(record: BeatRecord, rule: str,
                        location: str = "") -> List[LintFinding]:
    """Each shard's ops touch only that shard's storages: the per-shard
    buffers ``record.owners`` names, and every other storage belongs to
    the first shard whose op touched it (its constants, its temporaries,
    its half of a collective's outputs).  A storage two shards touch is
    a read across shards outside the collective."""
    owner = dict(record.owners)
    crossings: Dict[Tuple[str, int, int], int] = {}
    for name, shard, keys in record.shard_ops:
        for k in keys:
            o = owner.setdefault(k, shard)
            if o != shard:
                crossings[(name, shard, o)] = \
                    crossings.get((name, shard, o), 0) + 1
    return [LintFinding(
        rule, f"shard {i}'s {name} touches shard {j}'s storage ({n} "
        "time(s)): a read across shards outside the collective",
        location=location) for (name, i, j), n in sorted(crossings.items())]


@register_pass("delta-collectives", "jaxpr", (R.JAXPR_DELTA_COLLECTIVE,),
               "delta beats: no collective, each shard on its own storage")
def lint_delta_collectives(record: BeatRecord,
                           location: str = "delta") -> List[LintFinding]:
    """A recorded delta or delta_join body of a sharded engine holds no
    collective op, and each shard's ops stay on that shard's storages."""
    out = []
    hits = sorted({name for name, _ in record.collectives})
    if hits:
        out.append(LintFinding(
            R.JAXPR_DELTA_COLLECTIVE,
            f"collective ops on the delta path: {hits} — delta beats must "
            "be shard-local", location=location))
    return out + lint_shard_locality(record, R.JAXPR_DELTA_COLLECTIVE,
                                     location)


@register_pass("reseed-collectives", "jaxpr", (R.JAXPR_RESEED_COLLECTIVE,),
               "reseed = one all_gather per mirrored predicated stage")
def lint_reseed_collectives(record: BeatRecord, lowered, spec,
                            location: str = "full") -> List[LintFinding]:
    """The recorded full / reseed body's only collective is one
    ``all_gather_rows`` per mirrored predicated scan stage, each over the
    shards' ``[Ts, w]`` slices of that stage — the rescan touched every
    shard once before re-assembly — and no shard reads another's storage
    besides."""
    out = []
    names = {name for name, _ in record.collectives}
    mi_pred = [st for st in lowered.scans
               if spec.is_mirrored(st.table) and st.cols]
    if names - {"all_gather_rows"}:
        out.append(LintFinding(
            R.JAXPR_RESEED_COLLECTIVE,
            f"unexpected collectives on the reseed path: "
            f"{sorted(names - {'all_gather_rows'})}", location=location))
    gathers = [shapes for name, shapes in record.collectives
               if name == "all_gather_rows"]
    if len(gathers) != len(mi_pred):
        out.append(LintFinding(
            R.JAXPR_RESEED_COLLECTIVE,
            f"{len(gathers)} all_gathers != {len(mi_pred)} mirrored "
            "predicated scan stages", location=location))
    else:
        got = sorted((shapes[0] if len(set(shapes)) == 1
                      and len(shapes) == spec.n_shards else shapes
                      for shapes in gathers), key=repr)
        want = sorted(((spec.shard_rows[st.table], st.whi - st.wlo)
                       for st in mi_pred), key=repr)
        if got != want:
            out.append(LintFinding(
                R.JAXPR_RESEED_COLLECTIVE,
                f"all_gather operand shapes {got} != per-shard stage "
                f"slices {want} on each of {spec.n_shards} shards",
                location=location))
    return out + lint_shard_locality(record, R.JAXPR_RESEED_COLLECTIVE,
                                     location)


# ---------------------------------------------------------------------------
# Fixed buffers and the donation contract
# ---------------------------------------------------------------------------


@register_pass("buffer-aliasing", "jaxpr", (R.JAXPR_DONATED_ALIAS,),
               "fixed beat buffers occupy disjoint storage")
def lint_buffer_aliasing(handle, state,
                         location: str = "") -> List[LintFinding]:
    """Over a built ``_CompiledHandle`` and the engine's state: the
    leaves of every slot's results, the scan carry, every slot's staging
    buffers and the state occupy pairwise disjoint storage, so an in-place
    write of one beat never reaches a buffer a slot in flight still
    reads; and there are two slots at least, so slot s's body never
    reads the rids it writes.  On a mesh generation every shard's leaves
    are groups of their own (results, carry, staging, state per shard,
    the merged results apart), so two shards never share storage."""
    out = []
    spec = getattr(handle, "spec", None)
    if spec is None:
        groups = [(f"results[{s}]", r) for s, r in enumerate(handle.results)]
        groups.append(("carry", handle.carry))
        groups += [(f"staging[{s}]", b.staged)
                   for s, b in enumerate(handle.staging)]
        groups.append(("state", state))
    else:
        groups = []
        for s, r in enumerate(handle.results):
            groups += [(f"results[{s}] shard {i}",
                        (r["_join_rids"][i], r["_shard"][i]))
                       for i in range(spec.n_shards)]
            groups.append((f"results[{s}] merged", r["_merged"]))
        for i in range(spec.n_shards):
            groups.append((f"carry shard {i}", handle.carry[i]))
            groups += [(f"staging[{s}] shard {i}", b.staged[i])
                       for s, b in enumerate(handle.staging)]
            groups.append((f"state shard {i}", state[i]))
    spans = []                  # (start, end, group)
    for label, tree in groups:
        for t in _leaves(tree):
            if t.numel():
                a, b = storage_key(t)
                spans.append((a, b, label))
    spans.sort()
    clashes = set()
    end, owner = -1, None
    for a, b, label in spans:
        if a < end and label != owner:
            clashes.add(tuple(sorted((owner, label))))
        if b > end:
            end, owner = b, label
    for x, y in sorted(clashes):
        out.append(LintFinding(
            R.JAXPR_DONATED_ALIAS,
            f"{x} and {y} share storage: an in-place write of one beat "
            "would reach a buffer another reads", location=location))
    if len(handle.results) < 2:
        out.append(LintFinding(
            R.JAXPR_DONATED_ALIAS,
            f"{len(handle.results)} pipeline slot(s): slot 0's body reads "
            "the rid carry it writes", location=location))
    return out


@register_pass("donation", "jaxpr", (R.JAXPR_DONATED_ALIAS,),
               "a body writes in place exactly the donated arguments")
def lint_donation(records: Dict[str, BeatRecord],
                  donation_spec: Optional[Dict[str, tuple]] = None,
                  location: str = "") -> List[LintFinding]:
    """Each recorded body writes in place exactly the cycle arguments
    ``donation_spec`` (default ``executor.DONATION_SPEC``) donates —
    never the rid carry it reads, never its staged admission, never
    another slot's buffers."""
    if donation_spec is None:
        from repro_torch.core.executor import DONATION_SPEC
        donation_spec = DONATION_SPEC
    out = []
    for flavour, rec in records.items():
        loc = f"{location} {flavour}".strip()
        names = CYCLE_ARGS[flavour]
        want = set(donation_spec[flavour])
        for argnum in sorted(want):
            name = names[argnum] if argnum < len(names) else None
            if name in ALIASED or name is None:
                out.append(LintFinding(
                    R.JAXPR_DONATED_ALIAS,
                    f"argument {argnum} ({ALIASED.get(name, 'no such')}) "
                    "is donated but reachable through a non-donated "
                    "alias — use-after-donate", location=loc))
        for k, what in (("rids", "the rid carry it reads (the previous "
                                 "slot's in-flight results)"),
                        ("other slot", "another pipeline slot's buffers")):
            if k in rec.wrote:
                out.append(LintFinding(
                    R.JAXPR_DONATED_ALIAS,
                    f"the body writes {what} in place — use after "
                    "donate", location=loc))
        wrote = _written_args(flavour, rec.wrote)
        if wrote - want:
            out.append(LintFinding(
                R.JAXPR_DONATED_ALIAS,
                f"the body writes argument(s) {sorted(wrote - want)} in "
                f"place, which the donation spec {tuple(sorted(want))} "
                "does not donate", location=loc))
        if want - wrote - {names.index(n) for n in ALIASED if n in names}:
            out.append(LintFinding(
                R.JAXPR_DONATED_ALIAS,
                f"donated argument(s) {sorted(want - wrote)} are not "
                "rolled forward in place (the carry would be a copy)",
                severity="warning", location=loc))
    return out


def run_trace_passes(eng, location: str = "") -> List[LintFinding]:
    """Every trace pass against a built engine: record one body of each
    flavour (``record_beats``) and hold the delta flavours to the width
    classifier, the bodies to the donation spec, and the installed
    generation's buffers (with the engine's state) to disjoint
    storage; on a sharded engine also the delta flavours to no
    collective and shard locality, and the reseed to its all_gathers."""
    recs = record_beats(eng)
    lowered, spec = eng._gen.lowered, eng._gen.spec
    out = (lint_delta_width(recs["delta"].compares, lowered, spec=spec,
                            location=f"{location} delta".strip())
           + lint_delta_width(recs["delta_join"].compares, lowered,
                              delta_joins=True,
                              update_slots=eng.update_slots, spec=spec,
                              location=f"{location} delta_join".strip())
           + lint_donation(recs, location=location)
           + lint_buffer_aliasing(eng._gen, eng.state, location=location))
    if spec is not None:
        for f in ("delta", "delta_join"):
            out += lint_delta_collectives(
                recs[f], location=f"{location} {f}".strip())
        out += lint_reseed_collectives(recs["full"], lowered, spec,
                                       location=f"{location} full".strip())
    return out
