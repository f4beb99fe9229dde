"""Fold differential leg of the PyTorch port, run under ``python -O``.

The port's counterpart of ``run_fold_differential.py``: the dynamic
plan-folding differential — mid-stream registration through
``QueryCycleServer``, carry migration, the forced full-rescan migration
beat, post-fold parity against a COLD engine compiled with the final
template set — with assert statements STRIPPED, unsharded and on a
2-shard row mesh.  The engine's carry/layout guard, the fold admission
rules and the hot-path guards (planlint rule ``no-bare-assert``) must be
real errors, not asserts, so every check here is an explicit raise.

    PYTHONPATH=src python -O tests/run_torch_fold_differential.py --device cpu

``--device`` defaults to the CUDA card, where the engines run on the
``hopper`` kernels and replay each beat as a CUDA graph (the default
``jit=True``); the 2-shard mesh puts both shards on that one device.  The
leg ends by printing the kernel launches it made (none on the CPU, where
the engines run the plain ``torch`` backend), one JSON object after
``FOLD_DIFFERENTIAL_LAUNCHES``.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.dataquery import mask_width
from repro_torch.core.device import resolve_device
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.plan import compile_plan
from repro_torch.core.sharding import make_row_mesh
from repro_torch.core.storage import bulk_load, build_key_partitions
from repro_torch.serving import QueryCycleServer
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 64, 128
N_BASE = 10
RULE = "[planlint:no-bare-assert]"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FOLD DIFFERENTIAL FAILED: {msg}")


def compare(a, b):
    ra, rb = a.result, b.result
    check(ra is not None and rb is not None, f"unserved {a.template}")
    if "rows" in ra:
        sa = set(int(x) for x in np.asarray(ra["rows"]) if x >= 0)
        sb = set(int(x) for x in np.asarray(rb["rows"]) if x >= 0)
        check(sa == sb, f"{a.template} rows {sorted(sa)[:5]} != "
                        f"{sorted(sb)[:5]}")
    else:
        sa = np.sort(np.asarray(ra["scores"]).ravel())
        sb = np.sort(np.asarray(rb["scores"]).ravel())
        check(np.allclose(sa, sb, rtol=1e-6), f"{a.template} scores")


def run(device, mesh, tag):
    catalog = tpcw.make_catalog(SCALE_I, SCALE_C)
    templates, caps = tpcw.make_templates(
        catalog.schemas["item"].capacity)
    base = compile_plan(catalog, templates[:N_BASE],
                        {t.name: caps[t.name]
                         for t in templates[:N_BASE]})
    full = compile_plan(catalog, list(templates), caps)

    def data():
        return tpcw.generate_data(np.random.default_rng(0),
                                  SCALE_I, SCALE_C)

    where = {"mesh": mesh} if mesh is not None else {"device": device}
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, data(), **where)
    server = QueryCycleServer(eng, background_folds=False)
    cold = SharedDBEngine(full, tpcw.DEFAULT_UPDATE_SLOTS, data(), **where)
    pairs = []

    def submit(name, params):
        pairs.append((server.submit(name, params),
                      cold.submit(name, params)))

    def update(u):
        server.submit_update(*u)
        cold.submit_update(*u)

    def heartbeat():
        server.heartbeat()
        cold.run_until_drained()
        while pairs:
            compare(*pairs.pop())

    submit("get_book", {0: (5, 5)})
    submit("search_subject", {0: (2, 2)})
    heartbeat()
    for i in range(2):
        update(("customer", "update", {"key": 3 + i,
                                       "col": "c_expiration",
                                       "val": 900 + i}))
        submit("get_customer", {0: (7 + i, 7 + i)})
        submit("get_book", {0: (5, 5)})
        heartbeat()
    check(eng.delta_cycles >= 1, f"{tag}: no delta beat engaged")

    # register the held-out templates mid-stream, one fold for the batch
    out = server.register_templates(
        [(t, caps[t.name]) for t in templates[N_BASE:]])
    check(all(r["status"] == "folding" for r in out), f"{tag}: {out}")
    submit("order_lines", {0: (10, 10)})
    submit("get_cart", {0: (12, 12)})
    submit("order_display", {0: (9, 9)})
    heartbeat()
    check(eng.folds_done == 1, f"{tag}: fold did not commit")
    check(eng.last_scan_path == "full",
          f"{tag}: migration beat was {eng.last_scan_path!r}")

    for i in range(3):          # post-fold steady state, slot-stable
        update(("customer", "update", {"key": 5 + i,
                                       "col": "c_expiration",
                                       "val": 40 + i}))
        submit("order_lines", {0: (20 + i, 20 + i)})
        submit("get_cart", {0: (12, 12)})
        submit("get_book", {0: (5, 5)})
        heartbeat()
    check(eng.last_scan_path == "delta",
          f"{tag}: post-fold steady state fell off the delta path")
    for table in ("item", "customer", "order_line"):
        got, want = eng.snapshot(table), cold.snapshot(table)
        for col in base.catalog.schemas[table].columns:
            check((got[col] == want[col]).all(),
                  f"{tag}: snapshot {table}.{col}")

    # the carry/layout guard must hold with asserts stripped: repeat
    # the last steady beat verbatim (delta-eligible) on a stale token
    eng.submit("order_lines", {0: (22, 22)})
    eng.submit("get_cart", {0: (12, 12)})
    eng.submit("get_book", {0: (5, 5)})
    eng._carry_token = ("stale-layout",)
    try:
        eng.dispatch()
    except RuntimeError:
        eng._carry_token = eng._layout_token
    else:
        raise SystemExit(f"{tag}: stale-carry dispatch did not raise")
    print(f"fold differential ok [{tag}]", flush=True)


def guard_messages(device):
    """The hot-path guards converted from bare asserts, each driven past
    its limit: ``{guard: its ValueError's message, or None if it did
    not raise}``."""
    schema = tpcw.make_catalog(SCALE_I, SCALE_C).schemas["country"]
    overflow = {c: np.zeros(schema.capacity + 1, np.int32)
                for c in schema.columns}
    keys = torch.zeros(9, dtype=torch.int32, device=device)
    probes = {"bulk_load": lambda: bulk_load(schema, overflow, device),
              "mask_width": lambda: mask_width(33),
              "build_key_partitions": lambda: build_key_partitions(
                  keys, keys == 0, 2, 4)}
    out = {}
    for what, probe in probes.items():
        try:
            probe()
        except ValueError as e:
            out[what] = str(e)
        else:
            out[what] = None
    return out


def check_stripped_guards(device):
    """The guards must still fire, with their rule id, when asserts are
    stripped."""
    for what, msg in guard_messages(device).items():
        check(msg is not None, f"{what} did not raise under -O")
        check(RULE in msg, f"{what} guard lost its rule id: {msg}")
    print("stripped-guard probes ok", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if __debug__:
        raise SystemExit("this leg must run under python -O "
                         "(assert statements stripped)")
    device = resolve_device(args.device)
    before = dict(kernels.LAUNCHES)
    check_stripped_guards(device)
    run(device, None, "unsharded")
    run(device, make_row_mesh(2, devices=[device, device]), "2-shard mesh")
    print("FOLD_DIFFERENTIAL_LAUNCHES " + json.dumps(
        {k: n - before[k] for k, n in kernels.LAUNCHES.items()}),
        flush=True)
    print("FOLD_DIFFERENTIAL_OK", flush=True)


if __name__ == "__main__":
    main()
