#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of SharedDB on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card of compute
capability 9.0+ and the CUDA toolkit.  It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written kernels from src/repro_torch/kernels/csrc
     into build/ (nvcc, one process per source, in parallel);
  3. holds each kernel against its plain PyTorch version on the card on
     small edge cases: padded tails, invalid rows, empty buckets, an
     empty dirty set and a zero pane span.  Tolerance everywhere: words,
     rids and group counts bit-equal; group sums within rtol 1e-6 (float
     atomics add in a varying order; TPC-W's integer sums are exact);
  4. drives the main path — SharedDBEngine at the paper's TPC-W scale
     (configs/shareddb_tpcw: 10 000 items, 28 800 customers), on the
     dense-index and the index-less catalog — through a reseed beat and
     slot-stable steady beats of the TPC-W shopping mix, with every
     kernel's launch count set to 0 before and read after; on every beat
     the tickets must equal those of the same engine on the plain
     ``torch`` backend and, on a sample, the query-at-a-time engine;
     steady beats must take the delta paths with one fused_delta launch,
     and ``dispatch()`` must not synchronise with the host; the last
     steady beat runs under torch.profiler, for the card's busy time;
  5. replays one beat's recorded kernel inputs (the main path's own
     shapes and data) through each kernel and its plain version, the
     plain version first: agreement, then each call's time on the card
     (torch.profiler: all device work of the call, and the hand-written
     kernel alone) and its wall time (a pair of CUDA events per call),
     beside a bound computed from the bytes and operations of those
     inputs;
  6. prints one JSON line of per-kernel results, then the one-line device
     record as the last line.

Any failed check raises and the script exits non-zero; with no CUDA
device it exits non-zero before printing any result.  The data is made
from ``SEED`` with numpy.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s fp32 outside
# the tensor cores, the rate used here for the kernels' int32 compares and
# float adds (none of them run on tensor cores)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
# each kernel's symbol, as it appears in a profiler trace
KERNEL_SYMBOLS = {"clockscan": "clockscan_kernel",
                  "shared_groupby": "groupby_kernel",
                  "partitioned_join": "partitioned_join_kernel",
                  "fused_delta": "fused_delta_kernel"}
N_INTERACTIONS = 150        # web interactions in the reseed beat
STEADY_BEATS = 3            # unprofiled steady beats, then one profiled
SAMPLE_PER_BEAT = 12        # tickets checked against query-at-a-time


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# ----------------------------------------------------------------- helpers
def clone_tree(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    return x


def wall_ms(fn, setup=None, reps=30):
    """Median milliseconds of one call of ``fn`` between its own pair of
    CUDA events, after a warm-up: what a caller waits for, host enqueue
    (checks, allocation, launch) and device time together.  ``setup``
    runs before each call, outside its window."""
    import torch
    samples = []
    for i in range(reps + 3):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 3:
            samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def device_ms(fn, kernel, setup=None, reps=20):
    """Time on the card per call of ``fn``, from a torch.profiler trace:
    (all device work that the call launched, that of the kernels whose
    name holds ``kernel``, launches of those kernels per call).

    Each call runs inside its own ``record_function`` range; the device
    work of a call is every kernel, copy and fill linked to that range or
    to an op inside it.  ``setup`` runs before each call, outside the
    range.  A kernel of ``kernel`` that the profiler did not link to a
    range is added to the total."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            with record_function("chip_smoke.call"):
                fn()
        torch.cuda.synchronize()
    events = prof.events()

    def linked(ev):
        yield from ev.kernels
        for ch in ev.cpu_children:
            yield from linked(ch)
    cpu = torch.autograd.DeviceType.CPU
    calls = [e for e in events
             if e.name == "chip_smoke.call" and e.device_type == cpu]
    if len(calls) != reps:
        fail(f"profiler: {len(calls)} call ranges, not {reps}")
    total = own_linked = 0.0
    for c in calls:
        for k in linked(c):
            total += k.duration
            own_linked += k.duration if kernel in k.name else 0.0
    own = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.name]
    own_us = sum(e.time_range.elapsed_us() for e in own)
    total += max(0.0, own_us - own_linked)
    return total / reps / 1e3, own_us / reps / 1e3, len(own) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(a, b):
    """Largest |a - b| over two results (int32 words compared as their
    uint32 values)."""
    import torch
    if isinstance(a, (tuple, list)):
        return max([max_abs_err(x, y) for x, y in zip(a, b)] + [0.0])
    if a.dtype == torch.int32:
        a, b = a.to(torch.int64) & 0xFFFFFFFF, b.to(torch.int64) & 0xFFFFFFFF
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def same(a, b, what):
    """Bit-equal tensors / tuples of tensors, or fail."""
    import torch
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            fail(f"{what}: {len(a)} outputs vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
        return
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        fail(f"{what}: kernel and plain version differ "
             f"(max abs err {max_abs_err(a, b)})")


# ---------------------------------------------------- 3. small edge cases
def edge_cases(dev):
    import numpy as np
    import torch
    from repro_torch.core.backends import FusedJoinIn, FusedScanIn
    from repro_torch.core.storage import INT_SENTINEL, build_key_partitions
    from repro_torch.kernels import (clockscan, fused_delta,
                                     partitioned_join, ref, shared_groupby)

    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def words(shape):
        return t(rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
                 .astype(np.uint32).view(np.int32))

    # clockscan: a padded tail (T % 256 != 0), invalid rows, 1..3 columns
    for C, T, Q in ((1, 256, 32), (3, 515, 64), (2, 300, 416)):
        cols = t(rng.integers(-50, 100, (C, T)))
        lo = t(rng.integers(-60, 50, (C, Q)))
        hi = lo + t(rng.integers(0, 80, (C, Q)))
        valid = t(rng.random(T) > 0.15, torch.bool)
        same(clockscan.clockscan(cols, lo, hi, valid),
             ref.clockscan_ref(cols, lo, hi, valid), f"clockscan {C}x{T}x{Q}")
    # shared_groupby: out-of-range codes contribute nothing
    for T, W, G in ((512, 1, 50), (700, 2, 100)):
        codes = t(rng.integers(-2, G + 2, T))
        vals = t(rng.integers(1, 10, T))
        mask = words((T, W))
        c1, s1 = shared_groupby.shared_groupby(codes, vals, mask, G)
        c2, s2 = ref.shared_groupby_ref(codes, vals, mask, G)
        same(c1, c2, "shared_groupby counts")
        if not torch.allclose(s1, s2, rtol=1e-6):
            fail("shared_groupby sums")
    # partitioned_join: empty buckets, all-invalid, duplicates
    for Tr, Tl, W, frac, B, extra in ((160, 120, 2, 0.8, 48, 0),
                                      (130, 300, 1, 0.2, 7, 3),
                                      (64, 64, 3, 0.0, 16, 1),
                                      (257, 129, 13, 1.0, 32, 0)):
        keys_r = t(rng.integers(-2, Tr, Tr))          # with duplicates
        valid_r = t(rng.random(Tr) < frac, torch.bool)
        P = -(-Tr // B) + extra
        parts = build_key_partitions(keys_r, valid_r, P, B)
        kl, ml, mr = t(rng.integers(-3, Tr + 3, Tl)), words((Tl, W)), \
            words((Tr, W))
        same(partitioned_join.partitioned_join(kl, ml, *parts, mr),
             ref.partitioned_join_ref(kl, ml, *parts, mr),
             f"partitioned_join {Tr}x{Tl}")

    # fused_delta: mixed stages / joins, pane-seam dirty rows, and the
    # dn == 0 / span == 0 identity
    def scan(T, C, Q, A, D, dn, span, seam=()):
        cols = t(rng.integers(0, 50, (C, T)))
        lo = t(rng.integers(0, 30, (C, Q)))
        hi = lo + t(rng.integers(0, 30, (C, Q)))
        w0 = int(rng.integers(0, Q // 32 - A + 1))
        pool = [r for r in seam if r < T]
        rest = [r for r in rng.permutation(T) if r not in pool]
        rows = np.sort(np.asarray(pool + rest, np.int64)[:dn])
        rows = np.concatenate([rows, np.full(D - dn, T)])
        return FusedScanIn(
            cols, lo, hi, lo[:, w0 * 32:(w0 + A) * 32].contiguous(),
            hi[:, w0 * 32:(w0 + A) * 32].contiguous(),
            t(rng.random(T) < 0.9, torch.bool), words((T, Q // 32)),
            t(w0), t(span), t(rows), t(dn))

    def join(Tl, Tr, D, dn, pseudo=False):
        kr = t(rng.permutation(Tr))
        vr = t(rng.random(Tr) < 0.9, torch.bool)
        if pseudo:
            parts = (torch.where(vr, kr, INT_SENTINEL)[None],
                     torch.where(vr, torch.arange(Tr, device=dev,
                                                  dtype=torch.int32),
                                 -1)[None],
                     t([-2147483647]))
        else:
            parts = build_key_partitions(kr, vr, 2, Tr // 2 + 8)
        rows = np.sort(rng.choice(Tl, dn, replace=False))
        rows = np.concatenate([rows, np.full(D - dn, Tl)])
        return FusedJoinIn(t(rng.integers(0, Tr, Tl)), t(rows), t(dn),
                           *parts, t(rng.integers(-1, Tr, Tl)))

    cases = {
        "mixed": ((scan(300, 2, 64, 1, 8, 5, 1), scan(256, 3, 96, 2, 16, 0, 0),
                   scan(700, 1, 32, 1, 4, 4, 1)),
                  (join(300, 128, 8, 3), join(256, 64, 8, 8, pseudo=True))),
        "seams": ((scan(300, 2, 64, 1, 8, 5, 1, seam=(0, 255, 256, 299)),),
                  (join(300, 64, 4, 2),)),
        "identity": ((scan(128, 2, 64, 2, 8, 0, 0),),
                     (join(128, 32, 4, 0),)),
    }
    for name, (si, ji) in cases.items():
        want = ref.fused_delta_ref(si, ji)
        got = fused_delta.fused_delta(clone_tree(si), clone_tree(ji))
        same(got, want, f"fused_delta {name}")
        if name == "identity":
            same(got[0][0], si[0].carry, "fused_delta span==0/dn==0 words")
            same(got[1][0], ji[0].rid_carry, "fused_delta dn==0 rids")
    torch.cuda.synchronize()


# ------------------------------------------------------ 4. the main path
def beat_profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def busy_ms(prof, top=6):
    """Milliseconds in which the card ran anything (the union of the
    trace's kernel, copy and fill intervals), the count of those, and the
    ``top`` names by device time as [name, ms, count]."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e3, len(spans), [[k[:90], ms, n]
                                    for k, (ms, n) in ranked]


def tickets_equal(a, b, what):
    import numpy as np
    for k, want in b.result.items():
        got = a.result[k]
        if k == "scores":
            if not np.allclose(got, want, rtol=1e-6):
                fail(f"{what} {a.template}.{k}: {got[:4]} vs {want[:4]}")
        elif not np.array_equal(got, want):
            fail(f"{what} {a.template}.{k}: {got[:4]} vs {want[:4]}")


def matches_baseline(t, want, what):
    import numpy as np
    if "rows" in want:
        got = set(int(x) for x in t.result["rows"] if x >= 0)
        exp = set(int(x) for x in want["rows"] if x >= 0)
        if got != exp:
            fail(f"{what} {t.template} {t.params}: query-at-a-time differs")
    elif not np.allclose(np.sort(t.result["scores"]), np.sort(want["scores"]),
                         rtol=1e-6):
        fail(f"{what} {t.template}: group scores differ from query-at-a-time")


def workload(scale_i, scale_c):
    """The reseed beat's queries and updates (TPC-W shopping mix, at most
    one beat's slot capacity per template) and the steady beats' customer
    updates, from SEED."""
    import numpy as np
    from repro_torch.workloads import tpcw
    gen = tpcw.WorkloadGenerator(np.random.default_rng(SEED), scale_i,
                                 scale_c)
    caps = tpcw.make_templates(0)[1]
    queries, updates, per = [], [], {}
    for it in gen.sample_mix("shopping", N_INTERACTIONS):
        updates += it.updates
        for name, params in it.queries:
            if per.get(name, 0) < caps[name]:
                per[name] = per.get(name, 0) + 1
                queries.append((name, params))
    steady = []
    for b in range(STEADY_BEATS + 1):
        steady.append([("customer", "update",
                        {"key": int(gen.rng.integers(0, scale_c)),
                         "col": "c_expiration",
                         "val": int(gen.rng.integers(12000, 15000))})
                       for _ in range(4)])
    return queries, updates, steady


def drive(dense, dev, scale_i, scale_c, kernels, check=True):
    """Build the engine under test (backend ``kernels``) for one catalog
    and run the beats; with ``check``, also the plain-backend engine and
    the query-at-a-time engine it is compared with.  Returns the per-beat
    log."""
    import numpy as np
    import torch
    from repro_torch.core.baseline import QueryAtATimeEngine
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.workloads import tpcw

    data = tpcw.generate_data(np.random.default_rng(SEED), scale_i, scale_c)
    plan = tpcw.build_tpcw_plan(scale_i, scale_c, dense_pk_index=dense)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels=kernels, device=dev)
    if not check:
        return _beats(eng, None, None, scale_i, scale_c, dense)
    plain = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels="torch", device=dev)
    base = QueryAtATimeEngine(plan, data, device=dev)
    return _beats(eng, plain, base, scale_i, scale_c, dense)


def _beats(eng, plain, base, scale_i, scale_c, dense):
    import torch
    queries, updates, steady = workload(scale_i, scale_c)
    catalog = "dense" if dense else "indexless"
    log = []
    # the beats after the reseed are steady; the last of them runs under
    # torch.profiler to read the card's busy time in a steady beat
    for beat in range(2 + STEADY_BEATS):
        profiled = beat == 1 + STEADY_BEATS
        ups = updates if beat == 0 else steady[beat - 1]
        qs = list(queries)
        if beat:
            # slot-stable admission: the same queries in the same slots,
            # one get_customer query re-parameterised per beat
            i = next(k for k, (n, _) in enumerate(qs) if n == "get_customer")
            c = (beat * 7919) % scale_c
            qs[i] = ("get_customer", {0: (c, c)})
        engines = [e for e in (eng, plain) if e is not None]
        tickets = []
        for e in engines:
            for u in ups:
                e.submit_update(*u)
            tickets.append([e.submit(n, p) for n, p in qs])
        if base is not None:
            for u in ups:
                base.apply_update(*u)
        torch.cuda.synchronize()
        prof = beat_profiler() if profiled else contextlib.nullcontext()
        with prof:
            t0 = time.perf_counter()
            # the engine under test must enqueue its beat without waiting
            # for the device: any host synchronisation in dispatch() raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.dispatch()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng.collect()
            wall = time.perf_counter() - t0
        s = eng.last_collect_stats
        entry = {"catalog": catalog, "beat": beat,
                 "scan_path": eng.last_scan_path,
                 "join_path": eng.last_join_path,
                 "admitted": s["admitted"], "dirty": s["dirty"],
                 "wall_ms": wall * 1e3,
                 "stage_ms": s["t_stage_s"] * 1e3,
                 "dispatch_ms": s["t_dispatch_s"] * 1e3,
                 "device_wait_ms": s["t_kernel_s"] * 1e3,
                 "collect_ms": s["t_collect_s"] * 1e3,
                 "backend_ops": s["backend_ops"], "profiled": profiled}
        if profiled:
            (entry["device_busy_ms"], entry["device_events"],
             entry["top_device_ops"]) = busy_ms(prof)
        log.append(entry)
        if any(t.result is None for t in tickets[0]):
            fail(f"{catalog} beat {beat}: a ticket was not answered")
        if beat and eng.last_scan_path != "delta":
            fail(f"{catalog} beat {beat}: scan path {eng.last_scan_path}")
        if beat and not dense and eng.last_join_path != "delta":
            fail(f"{catalog} beat {beat}: join path {eng.last_join_path}")
        if beat and s["backend_ops"] != {"fused_delta": 1, "groupby": 1}:
            fail(f"{catalog} beat {beat}: backend ops {s['backend_ops']}")
        if eng.last_delta_overflow or eng.last_overflow:
            fail(f"{catalog} beat {beat}: overflow "
                 f"{eng.last_delta_overflow}/{eng.last_overflow}")
        if plain is None:
            continue
        plain.run_until_drained()
        for a, b in zip(*tickets):
            tickets_equal(a, b, f"{catalog} beat {beat} hopper vs torch")
        picked = [t for t in tickets[0]
                  if dense or t.template != "best_sellers"]
        step = max(1, len(picked) // SAMPLE_PER_BEAT)
        for t in picked[::step][:SAMPLE_PER_BEAT]:
            matches_baseline(t, base.execute(t.template, t.params).result,
                             f"{catalog} beat {beat}")
    return log


# ------------------------------------------------- 5. kernels at main-path
def recording_backend(base, store):
    from repro_torch.core.backends import OperatorBackend
    fields = ("scan", "join_block", "join_partitioned", "groupby",
              "scan_delta", "join_delta", "fused_delta")

    def wrap(op, name):
        def rec(*args):
            store.setdefault(name, []).append(clone_tree(args))
            return op(*args)
        return rec
    return OperatorBackend(name="hopper-recording",
                           **{f: wrap(getattr(base, f), f) for f in fields})


def kernel_rows(calls, launches):
    """Compare and time each kernel on recorded main-path inputs."""
    import torch
    from repro_torch.core.dataquery import popcount
    from repro_torch.kernels import (clockscan, fused_delta,
                                     partitioned_join, ref, shared_groupby)
    rows = []

    def row(name, route_src, replaces, kern, plain, check, work,
            setup=None):
        """``setup`` restores what ``kern`` writes in place (fused_delta's
        scan-word carries) before every call: the plain version first,
        then the kernel, each on the recorded inputs."""
        if setup is not None:
            setup()
        want = plain()
        if setup is not None:
            setup()
        got = clone_tree(kern())     # fused_delta's words are the carries
        check(got, want)
        err = max_abs_err(got, want)
        b, by = bound_ms(*work)
        ms, kernel_ms, per_call = device_ms(kern, KERNEL_SYMBOLS[name],
                                            setup)
        plain_ms, _, _ = device_ms(plain, KERNEL_SYMBOLS[name], setup)
        if per_call == 0:
            fail(f"{name}: the profiler saw no launch of the kernel")
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{route_src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "kernel_ms": kernel_ms, "kernel_launches": per_call,
                     "wall_ms": wall_ms(kern, setup),
                     "plain_wall_ms": wall_ms(plain, setup)})

    # clockscan: the reseed beat's six scans, one set per timing
    scans = calls["scan"][:6]
    scan_bytes = sum(nbytes(*a[:3]) + a[3].numel()
                     + a[3].numel() * a[1].shape[1] // 8 for a in scans)
    scan_ops = sum(2 * a[0].shape[0] * a[0].shape[1] * a[1].shape[1]
                   for a in scans)
    row("clockscan", "clockscan.cu", "src/repro/kernels/clockscan.py:61",
        lambda: [clockscan.clockscan(*a) for a in scans],
        lambda: [ref.clockscan_ref(*a) for a in scans],
        lambda g, w: same(g, w, "clockscan (main path)"),
        (scan_bytes, scan_ops))

    # shared_groupby: the last steady beat's call
    codes, vals, mask, G = calls["groupby"][-1]
    set_bits = int(popcount(mask).sum())
    Q = mask.shape[1] * 32

    def gb_check(g, w):
        same(g[0], w[0], "shared_groupby counts (main path)")
        if not torch.allclose(g[1], w[1], rtol=1e-6):
            fail("shared_groupby sums (main path)")
    row("shared_groupby", "shared_groupby.cu",
        "src/repro/kernels/shared_groupby.py:66",
        lambda: shared_groupby.shared_groupby(codes, vals, mask, G),
        lambda: ref.shared_groupby_ref(codes, vals, mask, G), gb_check,
        (nbytes(codes, vals, mask) + 2 * G * Q * 4, 2 * set_bits))

    # partitioned_join: the reseed beat's four probes
    joins = calls["join_partitioned"][:4]
    pj_bytes = sum(nbytes(*a) + a[0].numel() * 4 + nbytes(a[1])
                   for a in joins)
    pj_ops = sum(a[0].numel() * (a[2].shape[1] + a[1].shape[1]
                                 + max(1, a[2].shape[0]).bit_length())
                 for a in joins)
    row("partitioned_join", "partitioned_join.cu",
        "src/repro/kernels/partitioned_join.py:74",
        lambda: [partitioned_join.partitioned_join(*a) for a in joins],
        lambda: [ref.partitioned_join_ref(*a) for a in joins],
        lambda g, w: same(g, w, "partitioned_join (main path)"),
        (pj_bytes, pj_ops))

    # fused_delta: the last steady beat's launch; the work that its data
    # needs — live panes, live dirty rows, live probes
    scan_in, join_in = calls["fused_delta"][-1]
    fb, fo = 0, 0
    for e in scan_in:
        C, T = e.cols.shape
        A, Q = e.lo_p.shape[1] // 32, e.lo.shape[1]
        if int(e.span) > 0:
            fb += C * T * 4 + T + T * A * 4 + nbytes(e.lo_p, e.hi_p)
            fo += 2 * C * T * 32 * A
        dn = int(e.dn)
        fb += e.rows.numel() * 4
        fb += dn * (C * 4 + 1 + Q // 8) + (nbytes(e.lo, e.hi) if dn else 0)
        fo += 2 * dn * C * Q
    for e in join_in:
        dn = int(e.dn)
        fb += e.rows.numel() * 4 + dn * (4 + e.bkeys.shape[1] * 8 + 4)
        fo += dn * e.bkeys.shape[1]
    fb += 16 * (sum(-(-e.cols.shape[1] // min(256, e.cols.shape[1]))
                    + e.rows.numel() for e in scan_in)
                + sum(e.rows.numel() for e in join_in))
    recorded = [e.carry.clone() for e in scan_in]

    def restore_carries():
        for e, c in zip(scan_in, recorded):
            e.carry.copy_(c)
    row("fused_delta", "fused_delta.cu", "src/repro/kernels/fused_delta.py:303",
        lambda: fused_delta.fused_delta(scan_in, join_in),
        lambda: ref.fused_delta_ref(scan_in, join_in),
        lambda g, w: same(g, w, "fused_delta (main path)"), (fb, fo),
        setup=restore_carries)
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.configs.shareddb_tpcw import CONFIG
    from repro_torch.core import backends as B

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    if B.resolve_backend("auto", dev).name != "hopper":
        fail("kernels='auto' does not resolve to the hopper backend")

    t0 = time.perf_counter()
    lib = K.build()
    K.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(ROOT)}")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())

    t0 = time.perf_counter()
    edge_cases(dev)
    print(f"edge cases: all four kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    si, sc = CONFIG.scale_items, CONFIG.scale_customers
    K.reset_launches()
    log = []
    for dense in (True, False):
        log += drive(dense, dev, si, sc, kernels="auto")
    launches = dict(K.LAUNCHES)
    for entry in log:
        print("beat:", json.dumps(entry))
    for catalog in ("dense", "indexless"):
        walls = [e["wall_ms"] for e in log if e["catalog"] == catalog
                 and e["beat"] and not e["profiled"]]
        busy = next(e["device_busy_ms"] for e in log
                    if e["catalog"] == catalog and e["profiled"])
        print(f"steady beat, {catalog}: card busy {busy:.3f} ms of a "
              f"median {statistics.median(walls):.3f} ms unprofiled wall "
              f"(idle share {1 - busy / statistics.median(walls):.3f})")
    print("launches on the main path:", json.dumps(launches))
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    calls = {}
    B.register_backend(recording_backend(B.get_backend("hopper"), calls))
    drive(False, dev, si, sc, kernels="hopper-recording", check=False)
    rows = kernel_rows(calls, launches)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
