"""Port parity, storage: the PyTorch package's update-apply, dirty sets and
key partitions are bit-identical to the JAX package's on the same seeded
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import storage as rs
from repro_torch.core import storage as ts

CAP, KEY_SPACE, DIRTY = 64, 160, 12

# the reference's update-apply, compiled once per (schema, commit bound)
ref_apply = jax.jit(rs.apply_updates, static_argnums=(0, 3))
SLOTS = (8, 8, 6)                          # insert, update, delete slots
COLS = ("k", "a", "b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schemas(indexed):
    kw = dict(name="t", columns=COLS, capacity=CAP, pk="k",
              key_space=KEY_SPACE if indexed else 0, dirty_cap=DIRTY)
    return rs.TableSchema(**kw), ts.TableSchema(**kw)


def _assert_tables_equal(got, want, tag):
    assert sorted(got) == sorted(want), tag
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=f"{tag}:{k}")


def _random_batch(rng, live_keys, next_key, protected, full):
    """One batch: deletes of live (and absent) keys, updates that may hit
    a key deleted in the same batch or repeat a (key, column) pair, and
    fresh-key inserts.  ``protected`` is never deleted (see
    test_delete_of_row_zero_takes_effect).  ``full`` fills every slot."""
    n_ins, n_upd, n_del = SLOTS
    b = rs.empty_update_batch(_schemas(True)[0], rs.UpdateSlots(*SLOTS),
                              xp=np)
    pool = [k for k in live_keys if k != protected] or [KEY_SPACE - 1]
    dels = rng.choice(pool, size=n_del)
    dels[-1] = KEY_SPACE - 2                       # an absent key
    b["del_key"][:] = dels
    b["del_mask"][:] = full | (rng.random(n_del) < 0.7)
    upd = rng.choice(pool, size=n_upd)
    upd[0] = dels[0]                               # delete-then-update
    upd[2] = upd[1]                                # same key twice ...
    b["upd_key"][:] = upd
    b["upd_col"][:] = rng.integers(1, len(COLS), n_upd)
    b["upd_col"][2] = b["upd_col"][1]              # ... same column
    b["upd_val"][:] = rng.integers(-50, 50, n_upd)
    b["upd_mask"][:] = full | (rng.random(n_upd) < 0.8)
    b["upd_mask"][:3] = True
    for i in range(n_ins):
        b["ins_rows"]["k"][i] = next_key + i
        b["ins_rows"]["a"][i] = rng.integers(0, 100)
        b["ins_rows"]["b"][i] = rng.integers(0, 100)
    b["ins_mask"][:] = full | (rng.random(n_ins) < 0.75)
    return b


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("commit_cap", [None, 50])
def test_apply_updates_bit_identical_on_random_batches(indexed, commit_cap):
    """A chain of random batches: deletes, updates (delete-then-update of
    one key, a repeated (key, column) pair), inserts running past the
    commit bound, and dirty sets that overflow (up to 22 touches against
    a 12-row set)."""
    rng = np.random.default_rng(17 + indexed)
    rschema, tschema = _schemas(indexed)
    n0 = 30
    keys = rng.permutation(100)[:n0]
    data = {"k": keys, "a": rng.integers(0, 100, n0),
            "b": rng.integers(0, 100, n0)}
    ref_t = rs.bulk_load(rschema, data)
    port_t = ts.bulk_load(tschema, data, "cpu")
    _assert_tables_equal(port_t, ref_t, "load")
    live, next_key = set(int(k) for k in keys), 100
    overflowed = dropped = False
    for rnd in range(5):
        b = _random_batch(rng, sorted(live), next_key, int(keys[0]),
                          full=rnd >= 2)
        ref_t = ref_apply(rschema, ref_t, jax.tree.map(jnp.asarray, b),
                          commit_cap)
        port_t = ts.apply_updates(tschema, port_t,
                                  ts.tree_to_torch(b, "cpu"), commit_cap)
        _assert_tables_equal(port_t, ref_t, f"round {rnd}")
        overflowed |= bool(ref_t["_dirty_overflow"])
        dropped |= int(ref_t["_n"]) > (commit_cap or CAP)
        live -= set(int(k) for k, m in zip(b["del_key"], b["del_mask"])
                    if m)
        live |= set(int(k) for k, m in zip(b["ins_rows"]["k"],
                                           b["ins_mask"]) if m)
        next_key += SLOTS[0]
    assert overflowed and dropped


@pytest.mark.parametrize("indexed", [True, False])
def test_delete_of_row_zero_takes_effect(indexed):
    """Deleting the key held in row 0 from a multi-slot batch invalidates
    row 0.  The port matches the reference applying the same operations
    one slot per batch (the arrival-order semantics); see ROADMAP.md's
    parity-fault log for the reference's multi-slot batch."""
    rschema, tschema = _schemas(indexed)
    data = {"k": np.arange(10), "a": np.arange(10), "b": np.arange(10)}
    b = rs.empty_update_batch(rschema, rs.UpdateSlots(*SLOTS), xp=np)
    b["del_key"][0], b["del_mask"][0] = 0, True
    port_t = ts.apply_updates(tschema, ts.bulk_load(tschema, data, "cpu"),
                              ts.tree_to_torch(b, "cpu"))
    one = rs.empty_update_batch(rschema, rs.UpdateSlots(1, 1, 1), xp=np)
    one["del_key"][0], one["del_mask"][0] = 0, True
    ref_t = rs.apply_updates(rschema, rs.bulk_load(rschema, data),
                             jax.tree.map(jnp.asarray, one))
    for k in COLS + ("_valid", "_n", "_dirty_n"):
        np.testing.assert_array_equal(port_t[k].numpy(),
                                      np.asarray(ref_t[k]), err_msg=k)
    assert not bool(port_t["_valid"][0])


@pytest.mark.parametrize("seed,T,P,B,valid_frac,dups", [
    (0, 160, 4, 48, 0.8, False),
    (1, 130, 22, 7, 0.2, True),     # sparse -> empty buckets, duplicates
    (2, 64, 5, 16, 0.0, False),     # all-invalid table
    (3, 257, 9, 32, 1.0, True),     # capacity-boundary padding
])
def test_build_and_refresh_key_partitions(seed, T, P, B, valid_frac, dups):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-5, T // 2 if dups else 4 * T, T).astype(np.int32)
    valid = rng.random(T) < valid_frac
    want = rs.build_key_partitions(jnp.asarray(keys), jnp.asarray(valid),
                                   P, B)
    got = ts.build_key_partitions(torch.as_tensor(keys),
                                  torch.as_tensor(valid), P, B)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # refresh: a clean table keeps the carried partitions, a dirty one
    # rebuilds; both flags equal the reference's
    prev = tuple(np.asarray(w) + 1 for w in want)
    for dn, over in ((0, False), (3, False), (0, True)):
        tbl = {"k": keys, "_valid": valid, "_dirty_n": np.int32(dn),
               "_dirty_overflow": np.bool_(over)}
        rp, rflag = rs.refresh_key_partitions(
            jax.tree.map(jnp.asarray, tbl), "k", P, B,
            tuple(jnp.asarray(p) for p in prev))
        tp, tflag = ts.refresh_key_partitions(
            ts.tree_to_torch(tbl, "cpu"), "k", P, B,
            ts.tree_to_torch(prev, "cpu"))
        assert bool(tflag) == bool(rflag)
        for g, w in zip(tp, rp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scatter_locate_and_nonzero_static():
    rng = np.random.default_rng(4)
    T, D = 50, 8
    rows = np.sort(rng.choice(T, 5, replace=False)).astype(np.int32)
    rows = np.concatenate([rows, np.full(D - 5, T, np.int32)])
    dst = rng.integers(-9, 9, (T, 3)).astype(np.int32)
    vals = rng.integers(-9, 9, (D, 3)).astype(np.int32)
    want = rs.scatter_dirty_rows(jnp.asarray(dst), jnp.asarray(rows),
                                 jnp.asarray(vals), T)
    got = ts.scatter_dirty_rows(torch.as_tensor(dst), torch.as_tensor(rows),
                                torch.as_tensor(vals), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    col = rng.integers(0, 20, T).astype(np.int32)
    valid = rng.random(T) < 0.7
    probe = rng.integers(-2, 22, 12).astype(np.int32)
    np.testing.assert_array_equal(
        ts.locate_rows_by_key(torch.as_tensor(col), torch.as_tensor(probe),
                              torch.as_tensor(valid)).numpy(),
        np.asarray(rs.locate_rows_by_key(jnp.asarray(col),
                                         jnp.asarray(probe),
                                         jnp.asarray(valid))))
    for size in (3, 40, 60):
        want = np.asarray(jnp.nonzero(jnp.asarray(valid), size=size,
                                      fill_value=T)[0])
        got = ts.nonzero_static(torch.as_tensor(valid), size, T)
        np.testing.assert_array_equal(got.numpy(), want)
