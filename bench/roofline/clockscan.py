"""ClockScan's least work in a full-rescan beat: one launch a table with
predicated columns, every row against every query of the table's
templates.

Bytes: each predicated column once (4 B a row), the valid flags (1 B a
row), each query's lo and hi a column, and the result words (a bit a row
and query). Operations: two int32 compares a row, query slot and
predicate the slot's template binds on this table.

``least_s(dep, flavour)``: (seconds, the rates that bound its
launches) of one beat of ``flavour``; ``dep`` holds the deployment's
``tables``, ``templates`` and ``dense_pk_index``.
"""
from bench.roofline import _stages, peaks

SYMBOL = "clockscan_kernel"


def least_s(dep, flavour: str):
    if flavour != "full":
        return 0.0, None
    total, bounds = 0.0, set()
    for table, ts in _stages.scans(dep.templates).items():
        cols = {c for t in ts for tb, c in t.preds if tb == table}
        if not cols:
            continue                 # no predicate: no clockscan launch
        T = dep.tables[table].capacity
        Q = sum(t.cap for t in ts)
        nbytes = 4 * T * len(cols) + T + 8 * len(cols) * Q \
            + 4 * T * _stages.words(Q)
        nops = 2 * T * sum(t.cap * sum(tb == table for tb, _ in t.preds)
                           for t in ts)
        s, bound = peaks.least_s(nbytes, nops)
        total += s
        bounds.add(bound)
    return total, " and ".join(sorted(bounds)) or None
