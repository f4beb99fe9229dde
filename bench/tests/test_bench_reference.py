"""The plain NumPy reference on hand-built cases: the update rule, the
query semantics (joins, sorts, limits, the group-by's top k) and the
read-back that must fail a dropped insert.

Run with ``pytest bench/tests``."""
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference.schema import Table, Template  # noqa: E402
from bench.reference.tpcw_ref import Reference  # noqa: E402

TABLES = {
    "item": Table("item", ("i_id", "i_a_id", "i_subject", "i_title"), 8,
                  "i_id"),
    "author": Table("author", ("a_id", "a_lname"), 4, "a_id"),
    "line": Table("line", ("l_i_id", "l_qty"), 8),
}
TEMPLATES = {
    "by_subject": Template("by_subject", "item", (("item", "i_subject"),),
                           sort="i_title", limit=3, cap=4),
    "by_id": Template("by_id", "item", (("item", "i_id"),), limit=1, cap=4),
    "by_author": Template("by_author", "item", (("author", "a_lname"),),
                          (("i_a_id", "author"),), sort="i_title",
                          desc=True, limit=5, cap=4),
    "top": Template("top", "line", (("item", "i_subject"),),
                    (("l_i_id", "item"),), group="l_i_id", agg="l_qty",
                    top_k=3, n_groups=6, cap=4),
}


def data():
    return {
        "item": {"i_id": np.array([0, 1, 2, 3]),
                 "i_a_id": np.array([0, 1, 0, 2]),
                 "i_subject": np.array([5, 5, 6, 5]),
                 "i_title": np.array([30, 10, 20, 10])},
        "author": {"a_id": np.array([0, 1, 2]),
                   "a_lname": np.array([7, 8, 7])},
        "line": {"l_i_id": np.array([0, 1, 1, 3, 2]),
                 "l_qty": np.array([4, 2, 2, 4, 9])},
    }


def ref():
    return Reference(TABLES, TEMPLATES, data(), max_results=4)


def rows(r):
    return [int(x) for x in r["rows"] if x >= 0]


def test_sort_ties_break_by_row_and_the_limit_cuts():
    r = ref()
    # titles 30, 10, 10 on rows 0, 1, 3: ties (10) by row id
    assert rows(r.answer("by_subject", {0: (5, 5)})) == [1, 3, 0]
    assert r.answer("by_subject", {0: (5, 5)})["rows"].shape == (4,)
    assert rows(r.answer("by_subject", {0: (4, 4)})) == []


def test_a_join_keeps_rows_whose_key_and_predicate_match():
    r = ref()
    # authors 0 and 2 have lname 7: items 0, 2 (author 0) and 3 (author 2)
    # by title descending: 30 (row 0), 20 (row 2), 10 (row 3)
    assert rows(r.answer("by_author", {0: (7, 7)})) == [0, 2, 3]
    r.apply_beat([("author", "delete", {"key": 2})])
    assert rows(r.answer("by_author", {0: (7, 7)})) == [0, 2]


def test_a_beat_sees_its_own_writes_in_the_rule_order():
    r = ref()
    r.apply_beat([
        ("item", "insert", {"i_id": 4, "i_a_id": 1, "i_subject": 5,
                            "i_title": 5}),
        # updates of the same row and column: the later one wins
        ("item", "update", {"key": 1, "col": "i_title", "val": 40}),
        ("item", "update", {"key": 1, "col": "i_title", "val": 50}),
        # an update of a key inserted in the same beat finds nothing:
        # updates are applied before inserts
        ("item", "update", {"key": 4, "col": "i_title", "val": 99}),
    ])
    assert rows(r.answer("by_subject", {0: (5, 5)})) == [4, 3, 0]
    assert rows(r.answer("by_id", {0: (4, 4)})) == [4]
    assert r.t["item"].col["i_title"][1] == 50
    assert r.t["item"].col["i_title"][4] == 5


def test_an_update_of_a_predicated_column_moves_the_row():
    r = ref()
    assert rows(r.answer("by_subject", {0: (6, 6)})) == [2]
    r.apply_beat([("item", "update", {"key": 0, "col": "i_subject",
                                      "val": 6})])
    assert rows(r.answer("by_subject", {0: (6, 6)})) == [2, 0]
    assert rows(r.answer("by_subject", {0: (5, 5)})) == [1, 3]


def test_group_by_top_k_ties_toward_the_lower_group():
    r = ref()
    out = r.answer("top", {0: (5, 5)})
    # subject-5 items 0, 1, 3: sums 4, 4, 4 (item 2 is subject 6)
    assert out["groups"].tolist() == [0, 1, 3]
    assert out["scores"].tolist() == [4.0, 4.0, 4.0]
    assert out["counts"].tolist() == [1.0, 2.0, 1.0]
    assert out["scores"].dtype == np.float32
    out = r.answer("top", {0: (7, 7)})       # no row: groups 0, 1, 2
    assert out["groups"].tolist() == [0, 1, 2]
    assert out["scores"].tolist() == [0.0, 0.0, 0.0]


def test_answers_follow_the_writes_they_read():
    r = ref()
    before = r.answer("top", {0: (5, 5)})
    r.apply_beat([("line", "insert", {"l_i_id": 3, "l_qty": 7})])
    after = r.answer("top", {0: (5, 5)})
    assert before["groups"].tolist() == [0, 1, 3]
    assert after["groups"].tolist() == [3, 0, 1]
    assert after["scores"].tolist() == [11.0, 4.0, 4.0]


def snapshot(r, name, capacity):
    """The program's read-back of a table of ``capacity`` rows holding
    exactly what the reference holds (inserts past it dropped)."""
    tb = r.t[name]
    n = min(tb.n, capacity)
    snap = {c: np.zeros(capacity, np.int32) for c in tb.schema.columns}
    for c in tb.schema.columns:
        snap[c][:n] = tb.col[c][:n]
    snap["_valid"] = np.zeros(capacity, bool)
    snap["_valid"][:n] = tb.valid[:n]
    snap["_n"] = tb.n
    return snap


def test_readback_finds_a_dropped_insert_and_a_lost_update():
    r = ref()
    r.apply_beat([("line", "insert", {"l_i_id": k % 4, "l_qty": 1})
                  for k in range(4)])
    assert r.t["line"].n == 9
    assert r.readback_mismatches("line", snapshot(r, "line", 16)) == 0
    # a table of 8 rows drops the ninth insert
    assert r.readback_mismatches("line", snapshot(r, "line", 8)) == 1
    snap = snapshot(r, "item", 8)
    r.apply_beat([("item", "update", {"key": 2, "col": "i_title",
                                      "val": 1})])
    assert r.readback_mismatches("item", snap) == 1
    snap["i_title"][2] = 1
    assert r.readback_mismatches("item", snap) == 0
    snap["_valid"][6] = True            # a row the reference never wrote
    assert r.readback_mismatches("item", snap) == 1
