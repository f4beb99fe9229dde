"""Port parity, the last three SharedDB kernels: the plain PyTorch
versions of ``bitmask_join``, ``delta_scan`` and ``delta_join``
(kernels/ref.py, and the hopper wrappers, which compute them for CPU
tensors) equal the JAX package's Pallas kernels in interpret mode and
its jnp references, on the same seeded numpy inputs.  Bit for bit: rids,
words and masks are integers.  The CUDA kernels are held to these plain
versions on the card by tests/test_torch_cuda.py.
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
from repro_torch.kernels import bitmask_join as tbj
from repro_torch.kernels import fused_delta as tfd
from repro_torch.kernels import ref as tref


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
        for fn in (tref.delta_join_ref, tfd.delta_join,
                   tb.get_backend("hopper").join_delta):
            got = fn(*targs)
            assert got.shape == (D,)
            np.testing.assert_array_equal(got.numpy(), want)
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
