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
    for fn in (tref.delta_scan_ref, tfd.delta_scan,
               tb.get_backend("hopper").scan_delta):
        got = fn(*targs)
        assert got.shape == (D, Q // 32)
        np.testing.assert_array_equal(U(got), want)
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
