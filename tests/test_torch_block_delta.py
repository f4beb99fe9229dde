"""Port parity, the last three SharedDB kernels: the plain PyTorch
versions of ``bitmask_join``, ``delta_scan`` and ``delta_join``
(kernels/ref.py, and the hopper wrappers, which compute them for CPU
tensors) equal the JAX package's Pallas kernels in interpret mode and
its jnp references, on the same seeded numpy inputs.  Bit for bit: rids,
words and masks are integers.  The grids of the bitmask_join,
delta_scan and delta_join kernels are replayed in numpy and held to the
same references.  The CUDA kernels are held to these plain versions on
the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.storage import build_key_partitions as ref_partitions
from repro.kernels import ref as rref
from repro.kernels.bitmask_join import bitmask_join_pallas
from repro.kernels.fused_delta import delta_join_pallas, delta_scan_pallas
from repro_torch.core import backends as tb
from repro_torch.core.storage import INT_SENTINEL
from repro_torch.kernels import bitmask_join as tbj
from repro_torch.kernels import fused_delta as tfd
from repro_torch.kernels import partitioned_join as tpj
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    """numpy -> torch (uint32 words become int32 bit patterns)."""
    a = np.array(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def U(t):
    """torch -> numpy, int32 words read as uint32."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------ block join
def _block_world(seed, Tl, Tr, W, dup_invalid):
    """Unique keys among valid right rows; with ``dup_invalid`` some
    invalid right rows repeat a valid row's key (a delete followed by a
    re-insert leaves such rows), before and after the valid one."""
    rng = np.random.default_rng(seed)
    keys_r = rng.permutation(Tr * 3)[:Tr].astype(np.int32)
    valid_r = rng.random(Tr) > 0.25
    if dup_invalid and Tr > 4:
        valid_rows = np.flatnonzero(valid_r)
        invalid_rows = np.flatnonzero(~valid_r)
        n = min(len(valid_rows), len(invalid_rows))
        src = rng.choice(valid_rows, n, replace=False)
        keys_r[invalid_rows[:n]] = keys_r[src]
    keys_l = rng.choice(Tr * 4, Tl).astype(np.int32)
    if dup_invalid:     # every duplicated key is probed at least once
        dups = keys_r[~valid_r]
        keys_l[:min(Tl, dups.size)] = dups[:Tl]
    return (keys_l, _words(rng, (Tl, W)), keys_r, _words(rng, (Tr, W)),
            valid_r)


BLOCK_CASES = {
    # the reference's own shapes (tests/test_kernels.py)
    "256x256x1": (0, 256, 256, 1, False, True),
    "512x256x2": (1, 512, 256, 2, False, True),
    "1024x512x8": (2, 1024, 512, 8, False, True),
    "256x1024x4": (3, 256, 1024, 4, False, True),
    # ragged sides and invalid rows repeating valid keys
    "ragged_dup_invalid": (4, 300, 100, 3, True, True),
    "tpcw_country": (5, 777, 128, 14, True, True),
    "right_over_2048": (6, 200, 2500, 2, True, False),
    "single_rows": (7, 1, 1, 1, False, True),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_bitmask_join_plain_matches_pallas_and_jnp(case):
    seed, Tl, Tr, W, dup, pallas = BLOCK_CASES[case]
    world = _block_world(seed, Tl, Tr, W, dup)
    jargs = [jnp.asarray(x) for x in world]
    want_rid, want_mask = (np.asarray(x) for x in
                           rref.bitmask_join_ref(*jargs))
    if pallas:
        prid, pmask = bitmask_join_pallas(*jargs, interpret=True)
        np.testing.assert_array_equal(np.asarray(prid), want_rid)
        np.testing.assert_array_equal(np.asarray(pmask), want_mask)
    targs = [T(x) for x in world]
    for fn in (tref.bitmask_join_ref, tbj.bitmask_join,
               tb.get_backend("hopper").join_block):
        rid, mask = fn(*targs)
        np.testing.assert_array_equal(rid.numpy(), want_rid)
        np.testing.assert_array_equal(U(mask), want_mask)
    if dup:     # the invalid duplicates are probed and never win
        assert (~world[4][want_rid[want_rid >= 0]]).sum() == 0


# ----------------------------------------------------- chained delta ops
def _dirty_rows(rng, T, D, dn, last_row):
    """Sorted distinct dirty rows (``last_row`` adds row T-1), padded to
    D slots with the capacity sentinel T."""
    pool = [T - 1] if last_row and dn else []
    rest = [r for r in rng.permutation(T - 1)[:dn] if r not in pool]
    rows = np.sort(np.asarray(pool + rest[:dn - len(pool)], np.int32))
    return np.concatenate([rows, np.full(D - len(rows), T, np.int32)])


DELTA_CASES = {
    # (seed, T, C, Q, D, dn, last_row)
    "pads": (0, 300, 2, 64, 16, 5, False),
    "row_T_minus_1": (1, 257, 3, 96, 8, 4, True),
    "empty_all_pads": (2, 128, 1, 32, 8, 0, False),
    "full_no_pads": (3, 64, 2, 32, 8, 8, True),
    "tpcw_window": (4, 1000, 1, 416, 128, 4, True),
}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_scan_plain_matches_pallas_and_jnp(case):
    seed, Tn, C, Q, D, dn, last = DELTA_CASES[case]
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 50, (C, Tn)).astype(np.int32)
    lo = rng.integers(0, 30, (C, Q)).astype(np.int32)
    hi = lo + rng.integers(0, 30, (C, Q)).astype(np.int32)
    valid = rng.random(Tn) < 0.9
    valid[-1] = False if seed % 2 else True
    rows = _dirty_rows(rng, Tn, D, dn, last)
    jargs = [jnp.asarray(x) for x in (cols, lo, hi, valid, rows)]
    want = np.asarray(rref.delta_scan_ref(*jargs))
    if D <= 16:
        np.testing.assert_array_equal(
            np.asarray(delta_scan_pallas(*jargs, interpret=True)), want)
    targs = [T(x) for x in (cols, lo, hi, valid, rows)]
    # the scan_delta op takes a tuple of stages and returns one output each
    grouped = [fn((tb.DeltaScanIn(*targs),)) for fn in (
        tref.delta_scans_ref, tfd.delta_scan,
        tb.get_backend("hopper").scan_delta)]
    for got in [tref.delta_scan_ref(*targs)] + [g[0] for g in grouped]:
        assert got.shape == (D, Q // 32)
        np.testing.assert_array_equal(U(got), want)
    assert all(len(g) == 1 for g in grouped)
    # every pad slot is the clamped row T-1's words
    for k in range(dn, D):
        np.testing.assert_array_equal(want[k], want[-1])


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_join_plain_matches_pallas_and_jnp(case):
    seed, Tl, _, _, D, dn, last = DELTA_CASES[case]
    rng = np.random.default_rng(100 + seed)
    Tr = 160
    keys_r = (rng.permutation(Tr * 3)[:Tr] - 2).astype(np.int32)
    valid_r = rng.random(Tr) < 0.8
    keys_l = rng.integers(-3, Tr * 3, Tl).astype(np.int32)
    keys_l[-1] = keys_r[np.flatnonzero(valid_r)[0]]   # row T-1 matches
    rows = _dirty_rows(rng, Tl, D, dn, last)
    for P, B in ((-(-Tr // 48), 48), (1, Tr)):      # partitioned, block
        parts = [np.asarray(x) for x in ref_partitions(
            jnp.asarray(keys_r), jnp.asarray(valid_r), P, B)]
        jargs = [jnp.asarray(x) for x in (keys_l, rows, *parts)]
        want = np.asarray(rref.delta_join_ref(*jargs))
        if D <= 16:
            np.testing.assert_array_equal(
                np.asarray(delta_join_pallas(*jargs, interpret=True)), want)
        targs = [T(x) for x in (keys_l, rows, *parts)]
        # the join_delta op takes a tuple of joins and returns one rid
        # vector each
        grouped = [fn((tb.DeltaJoinIn(*targs),)) for fn in (
            tref.delta_joins_ref, tfd.delta_join,
            tb.get_backend("hopper").join_delta)]
        for got in [tref.delta_join_ref(*targs)] + [g[0] for g in grouped]:
            assert got.shape == (D,)
            np.testing.assert_array_equal(got.numpy(), want)
        assert all(len(g) == 1 for g in grouped)
        if last and dn:     # the dirty row T-1 finds its match
            assert want[int(np.flatnonzero(rows == Tl - 1)[0])] >= 0


# -------------------------------------------- the grouped delta_scan grid
POISON = np.uint32(0x5EADBEEF)


def _full_window_word(cols, row, valid, lo, hi, k):
    """csrc/fused_delta.cu full_window_words, word k of one row: the
    ballot of lanes q = 32k + lane over the full window."""
    q = np.arange(32 * k, 32 * k + 32)
    ok = np.full(32, bool(valid[row]))
    for c in range(cols.shape[0]):
        ok &= (lo[c, q] <= cols[c, row]) & (cols[c, row] <= hi[c, q])
    return np.uint32(sum(1 << b for b in range(32) if ok[b]))


def _delta_scan_walk(stages, sms):
    """delta_scan_kernel's launches: ``delta_scan_groups`` of at most
    DELTA_SCAN_STAGES stages; in each, a warp per slot of the group's flat
    slot range, a grid stride apart, its stage found in the prefix sums,
    the slot's row clamped into range.  Every output word is written
    exactly once.  Returns (outputs, launches)."""
    outs = [np.full((len(s[4]), s[1].shape[1] // 32), POISON)
            for s in stages]
    writes = [np.zeros(o.shape, np.int64) for o in outs]
    groups = tfd.delta_scan_groups([len(s[4]) for s in stages])
    for g0, start in groups:
        assert len(start) - 1 <= tfd.DELTA_SCAN_STAGES
        blocks = tfd.delta_scan_blocks(start[-1], sms)
        assert blocks <= sms * 4
        for blk in range(blocks):
            for warp in range(tfd.WARPS):
                for slot in range(blk * tfd.WARPS + warp, start[-1],
                                  blocks * tfd.WARPS):
                    i = 0
                    while start[i + 1] <= slot:
                        i += 1
                    cols, lo, hi, valid, rows = stages[g0 + i]
                    k = slot - start[i]
                    row = min(max(int(rows[k]), 0), cols.shape[1] - 1)
                    for w in range(lo.shape[1] // 32):
                        outs[g0 + i][k, w] = _full_window_word(
                            cols, row, valid, lo, hi, w)
                        writes[g0 + i][k, w] += 1
    for w in writes:
        assert (w == 1).all()
    return outs, len(groups)


def _stage(rng, Tn, C, Q, D, dn):
    cols = rng.integers(0, 50, (C, Tn)).astype(np.int32)
    lo = rng.integers(0, 30, (C, Q)).astype(np.int32)
    hi = lo + rng.integers(0, 30, (C, Q)).astype(np.int32)
    valid = rng.random(Tn) < 0.9
    return cols, lo, hi, valid, _dirty_rows(rng, Tn, D, dn, dn % 2 == 1)


# (T, C, Q, D, dn) a stage: one stage; the chained beat's seven stage
# kinds at a small T (customer, item, author, order_line, orders,
# shopping_cart_line, address: their C and Q, D cut to 4-16); and more
# stages than one launch's argument block holds, empty dirty sets and
# D 0 among them
GROUPED_CASES = {
    "one_stage": [(300, 2, 64, 16, 5)],
    "chained_beat": [(200, 2, 96, 16, 3), (150, 3, 352, 8, 2),
                     (60, 1, 224, 4, 0), (300, 1, 96, 16, 16),
                     (120, 2, 128, 8, 1), (200, 1, 32, 16, 4),
                     (90, 1, 32, 8, 8)],
    "over_one_launch": [(40 + 7 * s, 1 + s % 3, 32 * (1 + s % 4),
                         4 * (s % 4), min(s % 5, 4 * (s % 4)))
                        for s in range(tfd.DELTA_SCAN_STAGES + 8)],
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_delta_scan_walk_matches_pallas_and_jnp(case):
    """The one-launch delta_scan over every stage of a beat, replayed at
    one block and at the full card's grid: each stage's words equal
    ``delta_scan_ref``, the JAX jnp reference and (stages of D <= 16, the
    first eight) the Pallas kernel in interpret mode, pad slots included;
    the scan_delta op of both backends returns the same tuple on CPU."""
    rng = np.random.default_rng(len(case))
    stages = [_stage(rng, *shape) for shape in GROUPED_CASES[case]]
    dn = [shape[4] for shape in GROUPED_CASES[case]]
    want = []
    for i, s in enumerate(stages):
        jargs = [jnp.asarray(x) for x in s]
        w = np.asarray(rref.delta_scan_ref(*jargs))
        if len(s[4]) <= 16 and i < 8 and len(s[4]):
            np.testing.assert_array_equal(
                np.asarray(delta_scan_pallas(*jargs, interpret=True)), w)
        want.append(w)
    tin = tuple(tb.DeltaScanIn(*(T(x) for x in s)) for s in stages)
    for fn in (tref.delta_scans_ref, tfd.delta_scan,
               tb.get_backend("hopper").scan_delta):
        got = fn(tin)
        assert len(got) == len(stages)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(U(g), w)
    n_launch = -(-len(stages) // tfd.DELTA_SCAN_STAGES)
    for sms in (1, 132):
        outs, launches = _delta_scan_walk(stages, sms)
        assert launches == n_launch
        for o, w, d in zip(outs, want, dn):
            np.testing.assert_array_equal(o, w)
            if d < len(o):          # pads carry the clamped row T-1's words
                np.testing.assert_array_equal(o[d:], np.broadcast_to(
                    o[-1], o[d:].shape))


# -------------------------------------------- the grouped delta_join grid
def _route_bucket(bounds, key):
    """csrc/common.cuh route_bucket: the last bound <= key, clipped."""
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) >> 1
        if bounds[mid] <= key:
            lo = mid + 1
        else:
            hi = mid
    return min(max(lo - 1, 0), len(bounds) - 1)


def _search_bucket(bk, br, key):
    """csrc/common.cuh search_bucket: binary search for the last entry
    with row >= 0 and key <= ``key``; its row if its key is ``key``."""
    lo, hi = 0, len(bk)
    while lo < hi:
        mid = (lo + hi) >> 1
        if br[mid] >= 0 and bk[mid] <= key:
            lo = mid + 1
        else:
            hi = mid
    return int(br[lo - 1]) if lo and bk[lo - 1] == key else -1


def _delta_join_walk(joins, sms):
    """delta_join_kernel's launches: ``delta_join_groups`` of at most
    DELTA_JOINS joins; in each, a lane per slot of the group's flat slot
    range, a grid stride apart, its join found in the prefix sums; the
    lane clamps the slot's row, routes its key and binary-searches the
    bucket.  Every rid is written exactly once.  Returns (rids,
    launches)."""
    outs = [np.full(len(j[1]), POISON.view(np.int32)) for j in joins]
    writes = [np.zeros(len(j[1]), np.int64) for j in joins]
    groups = tfd.delta_join_groups([len(j[1]) for j in joins])
    for g0, start in groups:
        group = joins[g0:g0 + len(start) - 1]
        assert len(group) <= tfd.DELTA_JOINS
        blocks = tfd.delta_join_blocks(start[-1], sms)
        assert blocks <= sms * 4
        for thread in range(blocks * tfd.THREADS):
            for slot in range(thread, start[-1], blocks * tfd.THREADS):
                i = 0
                while start[i + 1] <= slot:
                    i += 1
                keys, rows, bk, br, bounds = group[i]
                k = slot - start[i]
                key = int(keys[min(max(int(rows[k]), 0), len(keys) - 1)])
                b = _route_bucket(bounds, key)
                outs[g0 + i][k] = _search_bucket(bk[b], br[b], key)
                writes[g0 + i][k] += 1
    for w in writes:
        assert (w == 1).all()
    return outs, len(groups)


def _probe_join(rng, Tl, Tr, D, dn, B, krange=None):
    """One join's (keys, rows, bkeys, brows, bounds), numpy: right keys
    distinct, or drawn from ``krange`` values (duplicate runs longer than
    a bucket); probe keys that hit, miss and fall past either end of the
    bounds; dn sorted dirty rows (row Tl-1 among them when dn is odd),
    sentinel-padded to D slots."""
    keys_r = (rng.permutation(Tr * 3)[:Tr] - 2 if krange is None
              else rng.integers(0, krange, Tr)).astype(np.int32)
    valid_r = rng.random(Tr) < 0.85
    keys_l = rng.choice(np.concatenate([keys_r, keys_r + 1]), Tl) \
        .astype(np.int32)
    edges = [int(keys_r.min()) - 5, -2 ** 31, INT_SENTINEL - 1,
             INT_SENTINEL, int(keys_r.max()) + 1]
    keys_l[-min(Tl, len(edges)):] = edges[:min(Tl, len(edges))]
    parts = [np.asarray(x) for x in ref_partitions(
        jnp.asarray(keys_r), jnp.asarray(valid_r), -(-Tr // B), B)]
    return (keys_l, _dirty_rows(rng, Tl, D, dn, dn % 2 == 1), *parts)


# (Tl, Tr, D, dn, B, right key range) a join: one join; the chained
# beat's four partitioned joins at a small scale (item x author,
# order_line x orders, order_line x item, shopping_cart_line x item:
# dirty rows live on the cart spine, duplicate-key runs across buckets
# on one); and more joins than one launch's argument block holds, with
# all-pad (dn 0), full (dn == D) and empty (D 0) slot sets among them
GROUPED_JOIN_CASES = {
    "one_join": [(300, 160, 16, 5, 48, None)],
    "chained_beat": [(120, 90, 16, 0, 16, None), (400, 300, 16, 3, 32, 40),
                     (400, 160, 16, 0, 32, None), (200, 160, 8, 8, 32, 20)],
    "over_one_launch": [(40 + 9 * (j % 4), 30 + 5 * (j % 4), 4 * (j % 4),
                         min(j % 5, 4 * (j % 4)), 8 + 8 * (j % 4),
                         12 if j % 7 == 0 else None)
                        for j in range(tfd.DELTA_JOINS + 8)],
    # one bucket a right row: 12 289 bounds, a 14-step route
    "many_buckets": [(300, 160, 16, 5, 48, None),
                     (200, 12289, 8, 7, 1, None)],
}


@pytest.mark.parametrize("case", sorted(GROUPED_JOIN_CASES))
def test_grouped_delta_join_walk_matches_pallas_and_jnp(case):
    """The one-launch delta_join over every partitioned join of a beat,
    lanes as slots, replayed at one block and at the full card's grid:
    each join's rids equal ``delta_join_ref``, the JAX jnp reference and
    (joins of D <= 16, the first six) the Pallas kernel in interpret
    mode, pad slots included; the join_delta op of both backends returns
    the same tuple on CPU; every bucket set is in the layout the binary
    search needs."""
    rng = np.random.default_rng(17 + len(case))
    shapes = GROUPED_JOIN_CASES[case]
    joins = [_probe_join(rng, *shape) for shape in shapes]
    want = []
    for i, j in enumerate(joins):
        jargs = [jnp.asarray(x) for x in j]
        w = np.asarray(rref.delta_join_ref(*jargs))
        if 0 < len(j[1]) <= 16 and i < 6:
            np.testing.assert_array_equal(
                np.asarray(delta_join_pallas(*jargs, interpret=True)), w)
        want.append(w)
    tin = tuple(tb.DeltaJoinIn(*(T(x) for x in j)) for j in joins)
    assert all(tpj.buckets_ordered(e.bkeys, e.brows) for e in tin)
    for fn in (tref.delta_joins_ref, tfd.delta_join,
               tb.get_backend("hopper").join_delta):
        got = fn(tin)
        assert len(got) == len(joins)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    n_launch = len(tfd.delta_join_groups([len(j[1]) for j in joins]))
    assert n_launch == -(-len(joins) // tfd.DELTA_JOINS)
    for sms in (1, 132):
        outs, launches = _delta_join_walk(joins, sms)
        assert launches == n_launch
        for o, w, (_, _, D, dn, _, _) in zip(outs, want, shapes):
            np.testing.assert_array_equal(o, w)
            if dn < D:          # pads carry the clamped row Tl-1's rid
                assert (o[dn:] == o[-1]).all()
    if case == "chained_beat":  # a duplicate run crosses a bucket edge
        _, _, bk, br, _ = joins[1]
        assert any(bk[b, -1] == bk[b + 1, 0] and br[b + 1, 0] >= 0
                   for b in range(len(bk) - 1))
        assert any((w >= 0).any() for w in want)


# ------------------------------------------------ the bitmask_join grid
def _composite(key, valid, row):
    """csrc/bitmask_join.cu composite: (invalid, key ^ sign, row)."""
    return (int(not valid) << 63) | (((int(key) & 0xFFFFFFFF) ^ 0x80000000)
                                     << 31) | int(row)


def _search_sorted(c, key):
    """csrc/bitmask_join.cu search_sorted: the last composite below
    ``lim`` (live, key <= ``key``); its row if its key is ``key``."""
    k = (int(key) & 0xFFFFFFFF) ^ 0x80000000
    lim = (k + 1) << 31
    lo, hi = 0, len(c)
    while lo < hi:
        mid = (lo + hi) >> 1
        if c[mid] < lim:
            lo = mid + 1
        else:
            hi = mid
    if lo == 0:
        return -1
    return c[lo - 1] & 0x7FFFFFFF if c[lo - 1] >> 31 == k else -1


def _staged_in_order(keys_r, valid_r):
    """The staged path's composites, and whether their staged order is
    already ascending (the block vote): only then does a lane binary-
    search them."""
    comp = [_composite(keys_r[j], valid_r[j], j) for j in range(len(keys_r))]
    return comp, all(comp[j] < comp[j + 1] for j in range(len(comp) - 1))


def _bitmask_join_walk(keys_l, mask_l, keys_r, mask_r, valid_r, sms,
                       offset=0):
    """bitmask_join_kernel's grid: chunks of 32 left rows dealt warp-major
    over ``grid_blocks`` blocks; each lane finds its row's rid (the
    staged path binary-searches the block's composites when their staged
    order is sorted, else the right keys are scanned 32 at a time, as on
    the chunked path); the lanes then
    stream the chunk's contiguous rows x W words in 16-byte pieces, BATCH
    a lane at a time, each word's row from the launch's reciprocal and
    then walked, its rid from the owning lane (the shuffle) and
    mask_r[rid] from the staged copy or global memory.  ``offset``:
    mask_l's first word sits ``offset`` words past a 16-byte boundary
    (the kernel then reads word by word).  Every rid and output word is
    written exactly once.  Returns (rid, out, staged, searched)."""
    Tl, W = mask_l.shape
    Tr = keys_r.shape[0]
    blocks = tbj.grid_blocks(Tl, sms)
    assert blocks <= sms * 4
    staged = tbj.stage_bytes(Tr, W) > 0
    searched = None
    if staged:
        comp, searched = _staged_in_order(keys_r, valid_r)
        memo = {}

        def search(k):
            if k not in memo:
                memo[k] = _search_sorted(comp, k)
            return memo[k]
    recip = np.uint64(tbj.reciprocal(W))
    vec = offset % 4 == 0
    pair_key = keys_r.astype(np.int64)
    pair_row = np.where(valid_r, np.arange(Tr), -1)
    flat_l, flat_r = mask_l.reshape(-1), mask_r.reshape(-1)
    rid = np.full(Tl, POISON.view(np.int32))
    out = np.full(Tl * W, POISON, np.uint32)
    rid_writes = np.zeros(Tl, np.int64)
    out_writes = np.zeros(Tl * W, np.int64)
    lane = np.arange(tbj.CHUNK)
    chunks = -(-Tl // tbj.CHUNK)
    for blk in range(blocks):
        for warp in range(tbj.WARPS):
            for c in range(blk + warp * blocks, chunks,
                           blocks * tbj.WARPS):
                r0 = c * tbj.CHUNK
                n = min(tbj.CHUNK, Tl - r0)
                key = np.where(lane < n, keys_l[np.minimum(r0 + lane,
                                                           Tl - 1)], 0)
                if searched:                    # search the staged copy
                    lane_rid = np.array([search(int(k)) for k in key])
                else:                           # 32 right keys at a time
                    lane_rid = np.full(tbj.CHUNK, -1)
                    for j0 in range(0, Tr, tbj.CHUNK):
                        m = min(tbj.CHUNK, Tr - j0)
                        hit = pair_key[None, j0:j0 + m] == key[:, None]
                        lane_rid = np.maximum(lane_rid, np.where(
                            hit, pair_row[None, j0:j0 + m], -1).max(axis=1))
                rid[r0:r0 + n] = lane_rid[:n]
                rid_writes[r0:r0 + n] += 1
                base, nw = r0 * W, n * W
                for p0 in range(0, -(-nw // 4), tbj.BATCH * tbj.CHUNK):
                    for u in range(tbj.BATCH):
                        e = 4 * (p0 + u * tbj.CHUNK + lane)
                        if vec:     # a 16-byte piece starts on a boundary
                            assert ((offset + base + e) % 4 == 0).all()
                        lr = ((e.astype(np.uint64) * recip)
                              >> np.uint64(32)).astype(np.int64)
                        live = e < nw
                        assert (lr[live] == e[live] // W).all()
                        w = e - lr * W
                        for i in range(4):
                            src = lane_rid[np.minimum(lr, n - 1)]
                            on = e + i < nw
                            r = np.clip(src, 0, Tr - 1)
                            words = flat_l[base + e[on] + i] & flat_r[
                                r[on] * W + w[on]]
                            out[base + e[on] + i] = np.where(src[on] >= 0,
                                                             words, 0)
                            out_writes[base + e[on] + i] += 1
                            w = w + 1
                            lr = np.where(w == W, lr + 1, lr)
                            w = np.where(w == W, 0, w)
    assert (rid_writes == 1).all() and (out_writes == 1).all()
    return rid, out.reshape(Tl, W), staged, searched


def _in_order_world(seed, Tl, Tr, W, live):
    """A PK table holding its ``live`` rows in key order ahead of its free
    rows (as TPC-W's country: keys 0..91 in rows 0..91 of 128), so the
    staged order is the sorted one; left keys hit, miss and run past
    either end."""
    rng = np.random.default_rng(seed)
    keys_r = np.zeros(Tr, np.int32)
    keys_r[:live] = np.arange(live)
    valid_r = np.arange(Tr) < live
    keys_l = rng.integers(-3, live + 5, Tl).astype(np.int32)
    keys_l[:2] = [-2 ** 31, 2 ** 31 - 1]
    return (keys_l, _words(rng, (Tl, W)), keys_r, _words(rng, (Tr, W)),
            valid_r)


# (seed, Tl, Tr, W, right side (True: invalid rows repeating valid keys,
# False: distinct keys, "in order": live rows in key order ahead of free
# rows), mask_l offset in words): W 1, 3 and 14;
# ragged Tl (1, 33, 777) and a ragged last piece (33 x 3 words); the
# staged path, its rids binary-searched (the staged order sorted) or
# scanned (any other order), and the chunked one (a right side past
# STAGE_BYTES: 10 000 rows of 1 word, 500 rows of 60); unaligned mask_l;
# the fold path's migration shape (address x country, Tl 51 392, W 14,
# Tr 128 of which 92 live, in key order)
BLOCK_WALK_CASES = {
    "w1_ragged": (0, 33, 100, 1, True, 0),
    "w3_ragged_unaligned": (1, 33, 100, 3, True, 1),
    "w14_tpcw_country": (2, 777, 128, 14, True, 0),
    "w14_in_order_unaligned": (3, 300, 128, 14, "in order", 3),
    "one_row": (4, 1, 1, 1, False, 0),
    "chunked_over_rows": (5, 200, 10000, 1, True, 0),
    "chunked_over_bytes": (6, 70, 500, 60, True, 2),
    "fold_migration": (7, 51392, 128, 14, "in order", 0),
}


@pytest.mark.parametrize("case", sorted(BLOCK_WALK_CASES))
def test_bitmask_join_walk_matches_pallas_and_jnp(case):
    """The redesigned bitmask join (a warp a chunk of 32 left rows on a
    persistent grid, 16-byte pieces, the right side staged in shared
    memory or read in chunks) replayed at one block an SM and at the full
    card's grid equals the plain version, the JAX jnp reference and the
    Pallas kernel in interpret mode."""
    seed, Tl, Tr, W, right, offset = BLOCK_WALK_CASES[case]
    world = (_in_order_world(seed, Tl, Tr, W, 92 * Tr // 128)
             if right == "in order" else _block_world(seed, Tl, Tr, W, right))
    keys_l, mask_l, keys_r, mask_r, valid_r = world
    jargs = [jnp.asarray(x) for x in world]
    want_rid, want_mask = (np.asarray(x) for x in
                           rref.bitmask_join_ref(*jargs))
    prid, pmask = bitmask_join_pallas(*jargs, interpret=True)
    np.testing.assert_array_equal(np.asarray(prid), want_rid)
    np.testing.assert_array_equal(np.asarray(pmask), want_mask)
    rid, mask = tref.bitmask_join_ref(*(T(x) for x in world))
    np.testing.assert_array_equal(rid.numpy(), want_rid)
    np.testing.assert_array_equal(U(mask), want_mask)
    for sms in (1, 132):
        wrid, wmask, staged, searched = _bitmask_join_walk(
            keys_l, mask_l, keys_r, mask_r, valid_r, sms, offset)
        np.testing.assert_array_equal(wrid, want_rid)
        np.testing.assert_array_equal(wmask, want_mask)
    assert staged == (not case.startswith("chunked"))
    assert searched == (None if not staged
                        else right == "in order" or Tr == 1)
    if case == "fold_migration":    # one block's share of the card, even
        assert tbj.grid_blocks(Tl, 132) == 2 * 132
    if Tl > 1:                      # the walk reaches matched rows
        assert (want_rid >= 0).any()
