"""Port parity, kernels: the plain PyTorch version of clockscan,
shared_groupby, partitioned_join and fused_delta (kernels/ref.py, and the
hopper wrappers, which compute it for CPU tensors) equals the JAX
package's Pallas kernel in interpret mode and its jnp reference, on the
shapes of the reference's own kernel tests; the fused kernel's
descriptor equals the reference's; every hopper op is a kernel wrapper.
The other three kernels are in tests/test_torch_block_delta.py; the CUDA
kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as rb
from repro.core import dataquery as rdq
from repro.core.storage import build_key_partitions as ref_partitions
from repro.kernels import fused_delta as rfd
from repro.kernels import ref as rref
from repro.kernels.clockscan import clockscan_pallas
from repro.kernels.partitioned_join import partitioned_join_pallas
from repro.kernels.shared_groupby import shared_groupby_pallas
from repro_torch.core import backends as tb
from repro_torch.core import dataquery as tdq
from repro_torch.core.storage import INT_SENTINEL, build_key_partitions
from repro_torch.kernels import clockscan as tcs
from repro_torch.kernels import fused_delta as tfd
from repro_torch.kernels import partitioned_join as tpj
from repro_torch.kernels import ref as tref
from repro_torch.kernels import shared_groupby as tgb


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


# ------------------------------------------------------------ dataquery
def test_dataquery_pack_unpack_popcount_query_bit():
    rng = np.random.default_rng(1)
    bits = rng.random((5, 96)) < 0.4
    np.testing.assert_array_equal(U(tdq.pack(torch.as_tensor(bits))),
                                  np.asarray(rdq.pack(jnp.asarray(bits))))
    words = _words(rng, (7, 3))
    np.testing.assert_array_equal(tdq.unpack(T(words)).numpy(),
                                  np.asarray(rdq.unpack(jnp.asarray(words))))
    np.testing.assert_array_equal(tdq.popcount(T(words)).numpy(),
                                  np.asarray(rdq.popcount(jnp.asarray(words))))
    for q in (0, 31, 32, 95):
        np.testing.assert_array_equal(U(tdq.query_bit(q, 96)),
                                      np.asarray(rdq.query_bit(q, 96)))
    a, b = T(words[:3]), T(words[3:6])
    np.testing.assert_array_equal(U(tdq.union(a, b)), U(a) | U(b))
    np.testing.assert_array_equal(U(tdq.intersect(a, b)), U(a) & U(b))


@pytest.mark.parametrize("qcap", [32, 64, 256])
def test_dataquery_empty_and_full_mask_match_reference(qcap):
    for n_rows in (0, 5):
        for mine, theirs in ((tdq.empty_mask, rdq.empty_mask),
                             (tdq.full_mask, rdq.full_mask)):
            got = mine(n_rows, qcap, device="cpu")
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(
                U(got), np.asarray(theirs(n_rows, qcap)))


SELECT_CASES = [(qcap, qid) for qcap in (32, 64, 256)
                for qid in sorted({0, 31, 32, qcap - 1}) if qid < qcap]


@pytest.mark.parametrize("qid_kind", ["int", "tensor"])
@pytest.mark.parametrize("qcap,qid", SELECT_CASES)
def test_dataquery_select_query_matches_reference(qcap, qid, qid_kind):
    """Rows subscribed to one query, for an int id and for a 0-d tensor
    id (the reference's traced-id ``jnp.take`` path), equal the
    reference's and the unpacked bits."""
    words = _words(np.random.default_rng(qcap + qid), (37, qcap // 32))
    words[3] = 0xFFFFFFFF
    words[4] = 0
    if qid_kind == "int":
        got = tdq.select_query(T(words), qid)
        want = rdq.select_query(jnp.asarray(words), qid)
    else:
        got = tdq.select_query(T(words), torch.tensor(qid))
        want = rdq.select_query(jnp.asarray(words), jnp.int32(qid))
    assert got.dtype == torch.bool and got.shape == (37,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rdq.unpack(jnp.asarray(words)))[:, qid])


# ------------------------------------------- operators left to XLA / torch
def test_plain_operators_match_reference():
    """core/operators.py: the gather join, union compression, shared sort,
    per-query top-n and result routing, on one seeded world."""
    from repro.core import operators as rops
    from repro_torch.core import operators as tops
    def eq(got, want):
        for g, w_ in zip(got, want):
            w_ = np.asarray(w_)
            g = U(g) if w_.dtype == np.uint32 else g.numpy()
            np.testing.assert_array_equal(g, w_)

    rng = np.random.default_rng(2)
    T_, W = 40, 2
    mask = _words(rng, (T_, W))
    mask[rng.random(T_) < 0.3] = 0                      # unwanted rows
    tm, jm = T(mask), jnp.asarray(mask)
    fk = rng.integers(-2, 30, T_).astype(np.int32)
    pk_index = rng.integers(-1, 20, 25).astype(np.int32)
    right = _words(rng, (20, W))
    got = tops.shared_join_fk(torch.as_tensor(fk), tm,
                              torch.as_tensor(pk_index), T(right))
    want = rops.shared_join_fk(jnp.asarray(fk), jm, jnp.asarray(pk_index),
                               jnp.asarray(right))
    eq(got, want)
    for cap in (8, 64):
        got = tops.compress_union(tm, cap)
        eq(got, rops.compress_union(jm, cap))
    key = rng.integers(0, 6, T_).astype(np.int32)       # ties
    for desc in (False, True):
        got = tops.shared_sort(torch.as_tensor(key), tm, desc)
        eq(got, rops.shared_sort(jnp.asarray(key), jm, desc))
    n = rng.integers(0, 5, W * 32).astype(np.int32)
    np.testing.assert_array_equal(
        U(tops.shared_topn(tm, torch.as_tensor(n))),
        np.asarray(rops.shared_topn(jm, jnp.asarray(n))))
    rows = np.where(rng.random(T_) < 0.2, -1, np.arange(T_)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.route_topn(tm, torch.as_tensor(n), 3,
                        rows=torch.as_tensor(rows)).numpy(),
        np.asarray(rops.route_topn(jm, jnp.asarray(n), 3,
                                   rows=jnp.asarray(rows))))
    perm = rng.permutation(T_).astype(np.int32)
    np.testing.assert_array_equal(
        tops.route_results(tm, 4, perm=torch.as_tensor(perm)).numpy(),
        np.asarray(rops.route_results(jm, 4, perm=jnp.asarray(perm))))
    score = rng.integers(0, 4, (3, 30)).astype(np.float32)   # ties
    import jax
    tv, ti = tops.topk_stable(torch.as_tensor(score), 7)
    jv, ji = jax.lax.top_k(jnp.asarray(score), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------ clockscan
@pytest.mark.parametrize("C,Tn,Q", [(1, 256, 32), (3, 512, 64),
                                    (2, 300, 128)])
def test_clockscan_plain_matches_pallas_and_jnp(C, Tn, Q):
    rng = np.random.default_rng(C * Tn)
    cols = rng.integers(-50, 100, (C, Tn)).astype(np.int32)
    lo = rng.integers(-60, 50, (C, Q)).astype(np.int32)
    hi = lo + rng.integers(0, 80, (C, Q)).astype(np.int32)
    valid = rng.random(Tn) > 0.15
    args = [jnp.asarray(x) for x in (cols, lo, hi, valid)]
    want = np.asarray(clockscan_pallas(*args))
    np.testing.assert_array_equal(want, np.asarray(rref.clockscan_ref(*args)))
    targs = [torch.as_tensor(x) for x in (cols, lo, hi, valid)]
    np.testing.assert_array_equal(U(tref.clockscan_ref(*targs)), want)
    np.testing.assert_array_equal(U(tcs.clockscan(*targs)), want)


# ------------------------------------------------------- shared group-by
@pytest.mark.parametrize("Tn,W,G,out", [(512, 1, 50, 0), (700, 2, 100, 0),
                                        (1024, 8, 300, 0),
                                        (300, 1, 1, 0),     # one group
                                        (600, 2, 40, 3)])   # codes outside
def test_shared_groupby_plain_matches_pallas_and_jnp(Tn, W, G, out):
    """``out``: codes drawn from [-out, G + out), so some fall outside
    [0, G) and contribute nothing."""
    rng = np.random.default_rng(Tn + G)
    gc = rng.integers(-out, G + out, Tn).astype(np.int32)
    vals = rng.integers(-20, 50, Tn).astype(np.int32)
    mask = _words(rng, (Tn, W))
    args = (jnp.asarray(gc), jnp.asarray(vals), jnp.asarray(mask))
    pc, ps = shared_groupby_pallas(*args, G)
    jc, js = rref.shared_groupby_ref(*args, G)
    for fn in (tref.shared_groupby_ref, tgb.shared_groupby):
        c, s = fn(torch.as_tensor(gc), torch.as_tensor(vals), T(mask), G)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(c.numpy(), np.asarray(pc))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=1e-6)


# (T, W, G, SMs, co-resident blocks a SM) -> the grid launch_geometry
# picks: TPC-W's steady-beat call on an H100 (one block a SM; the
# zeroing's 16-byte units size it); no rows; one group; a buffer smaller
# than the grid (late blocks zero nothing); a ragged last stripe; a card
# that holds one block a SM; a card of 8 SMs; W = 0 (no outputs)
GROUPBY_GEOMETRY = [
    ((16384, 3, 12048, 132, 4), 132),
    ((0, 3, 12048, 132, 4), 132),
    ((0, 2, 1, 132, 4), 1),
    ((300, 1, 1, 132, 4), 1),
    ((2000, 1, 1, 132, 4), 4),
    ((40000, 1, 3, 132, 4), 79),
    ((5000, 3, 4097, 132, 4), 132),
    ((16384, 3, 12048, 132, 1), 132),
    ((16384, 3, 12048, 8, 4), 8),
    ((100, 0, 7, 132, 4), 1),
]


@pytest.mark.parametrize("args,blocks", GROUPBY_GEOMETRY)
def test_shared_groupby_geometry_zeroes_every_unit_once(args, blocks):
    """The grid and stripes of the cooperative launch: the kernel's first
    phase replayed (block b's threads zero the 16-byte units [b * stripe,
    min((b + 1) * stripe, units)), a thread every THREADS units) covers
    the 2 G Q floats exactly once; the stripes are whole 128-byte lines
    but the last; the grid is at most GRID_BLOCKS_PER_SM and the
    co-resident blocks a SM."""
    T, W, G, sms, per_sm = args
    got, stripe = tgb.launch_geometry(*args)
    assert got == blocks
    assert 1 <= got <= sms * min(tgb.GRID_BLOCKS_PER_SM, per_sm)
    floats = 2 * G * W * 32
    units = floats // tgb.UNIT
    assert units * tgb.UNIT == floats        # no tail below 16 bytes
    assert stripe % tgb.LINE == 0
    seen = np.zeros(units, np.int64)
    live = 0
    for b in range(got):
        begin, end = b * stripe, min((b + 1) * stripe, units)
        for t in range(tgb.THREADS):
            seen[begin + t:end:tgb.THREADS] += 1
        live += end > begin
    assert (seen == 1).all()
    assert live == (-(-units // stripe) if units else 0)


# ------------------------------------------------------ partitioned join
# (the Pallas kernel runs in interpret mode on the cases marked True; the
# reference's own suite holds it to its jnp reference on every case)
@pytest.mark.parametrize("seed,Tr,Tl,W,valid_frac,bucket_cap,extra,pallas", [
    (0, 160, 120, 2, 0.8, 48, 0, True),    # plain
    (1, 130, 300, 1, 0.2, 7, 3, False),    # sparse -> empty buckets
    (2, 64, 64, 3, 0.0, 16, 1, False),     # all-invalid table
    (3, 257, 129, 2, 1.0, 32, 0, True),    # capacity-boundary padding
    (4, 1, 1, 1, 1.0, 1, 2, False),        # degenerate single row
    (5, 300, 260, 2, 0.9, 256, 0, False),  # tile-sized bucket + remainder
])
def test_partitioned_join_plain_matches_pallas_and_jnp(seed, Tr, Tl, W,
                                                       valid_frac,
                                                       bucket_cap, extra,
                                                       pallas):
    rng = np.random.default_rng(seed)
    keys_r = (rng.permutation(Tr * 3)[:Tr] - 2).astype(np.int32)
    valid_r = rng.random(Tr) < valid_frac
    keys_l = rng.integers(-3, Tr * 3, Tl).astype(np.int32)
    mask_l, mask_r = _words(rng, (Tl, W)), _words(rng, (Tr, W))
    P = -(-Tr // bucket_cap) + extra
    parts = ref_partitions(jnp.asarray(keys_r), jnp.asarray(valid_r), P,
                           bucket_cap)
    jargs = (jnp.asarray(keys_l), jnp.asarray(mask_l), *parts,
             jnp.asarray(mask_r))
    want_rid, want_mask = rref.partitioned_join_ref(*jargs)
    if pallas:
        prid, pmask = partitioned_join_pallas(*jargs)
        np.testing.assert_array_equal(np.asarray(prid), np.asarray(want_rid))
        np.testing.assert_array_equal(np.asarray(pmask),
                                      np.asarray(want_mask))
    tparts = build_key_partitions(torch.as_tensor(keys_r),
                                  torch.as_tensor(valid_r), P, bucket_cap)
    targs = (torch.as_tensor(keys_l), T(mask_l), *tparts, T(mask_r))
    for fn in (tref.partitioned_join_ref, tpj.partitioned_join):
        rid, mask = fn(*targs)
        np.testing.assert_array_equal(rid.numpy(), np.asarray(want_rid))
        np.testing.assert_array_equal(U(mask), np.asarray(want_mask))
    # the block join's plain version agrees on the same world
    brid, bmask = tref.bitmask_join_ref(torch.as_tensor(keys_l), T(mask_l),
                                        torch.as_tensor(keys_r), T(mask_r),
                                        torch.as_tensor(valid_r))
    np.testing.assert_array_equal(brid.numpy(), np.asarray(want_rid))
    np.testing.assert_array_equal(U(bmask), np.asarray(want_mask))


# ----------------------------------------------------------- fused delta
def mk_scan(Tn, C, Q, A, D, dn, span, seed, boundary_rows=()):
    """numpy inputs of one FusedScanIn, as tests/test_fused_delta.py makes
    them."""
    r = np.random.default_rng(seed)
    cols = r.integers(0, 50, (C, Tn)).astype(np.int32)
    lo = r.integers(0, 30, (C, Q)).astype(np.int32)
    hi = lo + r.integers(0, 30, (C, Q)).astype(np.int32)
    w = Q // 32
    w0 = int(r.integers(0, max(1, w - A + 1)))
    lo_p = lo[:, w0 * 32:(w0 + A) * 32].copy()
    hi_p = hi[:, w0 * 32:(w0 + A) * 32].copy()
    valid = r.random(Tn) < 0.9
    carry = _words(r, (Tn, w))
    pool = [b for b in boundary_rows if b < Tn]
    extra = [x for x in r.choice(Tn, size=D, replace=False)
             if x not in pool][:max(dn - len(pool), 0)]
    rows = np.sort(np.asarray(pool + extra, np.int32)[:dn])
    rows = np.concatenate([rows, np.full(D - len(rows), Tn, np.int32)])
    return (cols, lo, hi, lo_p, hi_p, valid, carry, np.int32(w0),
            np.int32(span), rows, np.int32(min(dn, D)))


def mk_join(Tl, Tr, D, dn, seed, pseudo=False):
    """numpy inputs of one FusedJoinIn, as tests/test_fused_delta.py makes
    them."""
    r = np.random.default_rng(seed)
    keys = r.integers(0, Tr, Tl).astype(np.int32)
    kr = r.permutation(Tr).astype(np.int32)
    vr = r.random(Tr) < 0.9
    if pseudo:
        bkeys = np.where(vr, kr, INT_SENTINEL)[None, :].astype(np.int32)
        brows = np.where(vr, np.arange(Tr), -1)[None, :].astype(np.int32)
        bounds = np.full((1,), np.iinfo(np.int32).min, np.int32)
    else:
        bkeys, brows, bounds = (np.asarray(x) for x in ref_partitions(
            jnp.asarray(kr), jnp.asarray(vr), 2, Tr // 2 + 8))
    rows = np.sort(r.choice(Tl, size=dn, replace=False)).astype(np.int32)
    rows = np.concatenate([rows, np.full(D - dn, Tl, np.int32)])
    rid_carry = r.integers(-1, Tr, Tl).astype(np.int32)
    return (keys, rows, np.int32(dn), bkeys, brows, bounds, rid_carry)


def _both(scans, joins):
    """The same numpy inputs as the reference's and the port's tuples."""
    rs = tuple(rb.FusedScanIn(*(jnp.asarray(x) for x in s)) for s in scans)
    rj = tuple(rb.FusedJoinIn(*(jnp.asarray(x) for x in j)) for j in joins)
    ts = tuple(tb.FusedScanIn(*(T(x) for x in s)) for s in scans)
    tj = tuple(tb.FusedJoinIn(*(T(x) for x in j)) for j in joins)
    return rs, rj, ts, tj


def with_route_edges(j):
    """A mk_join whose first four dirty rows' keys lie below the first
    bound, at the int32 extremes and above the last bound."""
    keys, rows, dn, bkeys, brows, bounds, rid_carry = j
    i32 = np.iinfo(np.int32)
    keys = keys.copy()
    keys[rows[:4]] = (max(int(bounds[0]), i32.min + 1) - 1, i32.min, i32.max,
                      min(int(bounds[-1]), i32.max - 1) + 1)
    return (keys, rows, dn, bkeys, brows, bounds, rid_carry)


def with_dn(entry, dn):
    """A mk_scan / mk_join tuple whose live count says ``dn``."""
    at = 10 if len(entry) == 11 else 2
    return entry[:at] + (np.int32(dn),) + entry[at + 1:]


FUSED_CASES = {
    # three stages (padded tail at T=300, exact tile, two-tile tail) + a
    # partitioned and a pseudo-partitioned probe in one launch
    "mixed": ((mk_scan(300, 2, 64, 1, 8, 5, 1, 1),
               mk_scan(256, 3, 96, 2, 16, 0, 0, 2),
               mk_scan(700, 1, 32, 1, 4, 4, 1, 3)),
              (mk_join(300, 128, 8, 3, 4),
               mk_join(256, 64, 8, 8, 5, pseudo=True))),
    # dirty rows on the pane-tile seams and the last real row
    "boundary": ((mk_scan(300, 2, 64, 1, 8, 5, 1, 11,
                          boundary_rows=(0, 255, 256, 299)),
                  mk_scan(512, 1, 64, 2, 8, 4, 1, 12,
                          boundary_rows=(255, 256, 511))),
                 (mk_join(300, 64, 4, 2, 13),)),
    # dn == 0 and span == 0 everywhere: an exact identity
    "empty_dirty_zero_span": ((mk_scan(128, 2, 64, 2, 8, 0, 0, 9),),
                              (mk_join(128, 32, 4, 0, 10),)),
    "scan_only": ((mk_scan(64, 1, 32, 1, 4, 2, 1, 7),), ()),
    # a block join's single-bucket pseudo-partition (P = 1, B = 100: no
    # multiple of 32), with live dirty rows
    "block": ((mk_scan(200, 1, 32, 1, 8, 3, 1, 14),),
              (mk_join(200, 100, 8, 6, 15, pseudo=True),)),
    "join_only": ((), (mk_join(100, 50, 4, 4, 8),)),
    # probe keys past either end of the bounds (the kernel routes them)
    "route_edges": ((), (with_route_edges(mk_join(300, 120, 8, 6, 16)),
                         with_route_edges(mk_join(300, 120, 8, 6, 17,
                                                  pseudo=True)))),
    # the first pad at every slot position; all-pad sets whose live count
    # says 1
    "pads": (tuple(mk_scan(100, 1, 32, 1, 8, n, 1, 20 + n) for n in range(9))
             + (with_dn(mk_scan(100, 2, 64, 1, 8, 0, 1, 29), 1),),
             tuple(mk_join(100, 40, 8, n, 30 + n, pseudo=n % 2 == 1)
                   for n in range(9))
             + (with_dn(mk_join(100, 40, 8, 0, 39), 1),)),
}


# cases whose Pallas kernel also runs here, in interpret mode
FUSED_PALLAS = ("mixed", "empty_dirty_zero_span", "join_only", "block")


@pytest.fixture(scope="module")
def fused_reference():
    """Per FUSED_CASES case, computed once for the module and shared by
    the plain and the walk tests: the JAX package's jnp reference and
    (FUSED_PALLAS cases) its Pallas kernel in interpret mode, each as
    numpy (words, rids)."""
    cache = {}

    def get(case):
        if case not in cache:
            rs, rj = _both(*FUSED_CASES[case])[:2]
            want = [rref.fused_delta_ref(rs, rj)]
            if case in FUSED_PALLAS:
                want.append(rfd.fused_delta_pallas(rs, rj, interpret=True))
            cache[case] = [tuple(tuple(np.asarray(x) for x in part)
                                 for part in w) for w in want]
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_delta_plain_matches_pallas_and_jnp(case, fused_reference):
    scans, joins = FUSED_CASES[case]
    ts, tj = _both(scans, joins)[2:]
    want = fused_reference(case)
    for fn in (tref.fused_delta_ref, tfd.fused_delta):
        wt, rt = fn(ts, tj)
        for wr, rr in want:
            assert len(wt) == len(wr) and len(rt) == len(rr)
            for a, b in zip(wt, wr):
                np.testing.assert_array_equal(U(a), np.asarray(b))
            for a, b in zip(rt, rr):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "empty_dirty_zero_span":
        np.testing.assert_array_equal(U(wt[0]), scans[0][6])
        np.testing.assert_array_equal(rt[0].numpy(), joins[0][6])


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_schedule_and_descriptor_equal_reference(case):
    """The port's schedule is the reference's; the kernel's static launch
    descriptor is that schedule reordered (block items first) plus the
    COPY tiles; and the gathers the kernel makes itself (each DIRTY
    slot's row, each PROBE slot's routed bucket), replayed in torch,
    equal the reference's runtime gather column."""
    scans, joins = FUSED_CASES[case]
    rs, rj, ts, tj = _both(scans, joins)
    rsg = [rfd.scan_geometry(e) for e in rs]
    rjg = [rfd.join_geometry(e) for e in rj]
    tsg = tuple(tfd.scan_geometry(e) for e in ts)
    tjg = tuple(tfd.join_geometry(e) for e in tj)
    assert [tuple(g) for g in tsg] == [tuple(g) for g in rsg]
    assert [tuple(g) for g in tjg] == [tuple(g) for g in rjg]
    rsched = rfd.build_schedule(rsg, rjg)
    tsched = tfd.build_schedule(tsg, tjg, "cpu")
    np.testing.assert_array_equal(tsched.numpy(), rsched)
    ncopy = tfd.copy_tiles(tj)
    assert ncopy == tuple(-(-e.keys.shape[0] // tfd.COPY_TILE) for e in tj)
    desc, n_block = tfd.launch_schedule(tsg, tjg, ncopy, "cpu")
    d = desc.numpy()
    assert n_block == sum(g.nt for g in tsg)
    assert (d[:n_block, 0] == _PANE).all() and (d[n_block:, 0] != _PANE).all()
    kept = d[d[:, 0] != _COPY]
    assert sorted(map(tuple, kept)) == sorted(map(tuple, rsched))
    copies = d[d[:, 0] == _COPY]
    for j, n in enumerate(ncopy):
        np.testing.assert_array_equal(copies[copies[:, 1] == j, 2],
                                      np.arange(n))
    if not scans and not joins:
        return
    rbuckets = []
    for g, e in zip(rjg, rj):
        kd = e.keys[jnp.clip(e.rows, 0, e.keys.shape[0] - 1)]
        b = jnp.searchsorted(e.bounds, kd, side="right").astype(jnp.int32)
        rbuckets.append(jnp.clip(b - 1, 0, g.P - 1))
    rdesc = np.asarray(rfd.build_sdesc(rsched, rsg, rjg,
                                       [e.rows for e in rs], rbuckets))
    gather = {}                     # (kind, owner, idx) -> reference gather
    for (kind, owner, idx), g in zip(rdesc[:, :3], rdesc[:, 3]):
        gather[(kind, owner, idx)] = g
    for s, (g, e) in enumerate(zip(tsg, ts)):
        T_ = e.cols.shape[1]
        for idx in range(g.D):
            row = int(e.rows[idx])              # the kernel's rows[idx]
            want = gather[(_DIRTY, s, idx)]
            if 0 <= row < T_:
                assert row == want
            else:                               # a pad: the kernel skips,
                assert want >= T_ - 1           # the reference's drops
    for j, (g, e) in enumerate(zip(tjg, tj)):
        for idx in range(g.D):
            row = min(max(int(e.rows[idx]), 0), e.keys.shape[0] - 1)
            key = int(e.keys[row])
            assert _route_bucket(e.bounds, key) == \
                gather[(_PROBE, j, idx)]


# ------------------------------------------------ the kernels' walks, replayed
# What each CUDA kernel's grid does, in numpy: the wrappers' own geometry
# (tile_geometry / grid_blocks / launch_schedule), every block and warp of
# the grid and the items each takes, and exactly-once coverage of the
# outputs.  The card tests hold the kernels themselves to the plain versions.
POISON = np.uint32(0x5EADBEEF)
_PANE, _DIRTY, _PROBE, _COPY = 0, 1, 2, 3


def _route_bucket(bounds, key):
    """csrc/common.cuh route_bucket: the last bound <= key, clipped."""
    b = [int(x) for x in bounds]
    lo, hi = 0, len(b)
    while lo < hi:
        mid = (lo + hi) >> 1
        if b[mid] <= key:
            lo = mid + 1
        else:
            hi = mid
    return min(max(lo - 1, 0), len(b) - 1)


def _row_words(cols, rows, live, lo, hi, q0):
    """csrc/common.cuh row_word, one lane per entry of ``rows``: the word
    of queries [q0, q0 + 32) of each row (0 where not ``live``)."""
    bad = np.zeros(len(rows), np.uint32)
    for c in range(cols.shape[0]):
        x = cols[c, rows]
        for b in range(32):
            miss = (x < lo[c, q0 + b]) | (x > hi[c, q0 + b])
            bad |= np.where(miss, np.uint32(1 << b), np.uint32(0))
    return np.where(live, ~bad, np.uint32(0))


def _clockscan_walk(cols, lo, hi, valid, sms):
    """clockscan_kernel's grid: blocks a grid stride apart over tiles of
    32 * rt rows, warp (sub, phase) on rows of subtile ``sub`` and every
    g-th word from ``phase``, the tile's words staged and stored in
    16-byte pieces; every word written exactly once."""
    C, T_ = cols.shape
    W = lo.shape[1] // 32
    rt, g = tcs.tile_geometry(W)
    assert rt * g <= tcs.WARPS
    blocks = tcs.grid_blocks(T_, W, sms)
    tile_rows = 32 * rt
    n_tiles = -(-T_ // tile_rows)
    out = np.full(T_ * W, POISON, np.uint32)
    writes = np.zeros(T_ * W, np.int64)
    lane = np.arange(32)
    for blk in range(blocks):
        for tile in range(blk, n_tiles, blocks):
            r0 = tile * tile_rows
            nrows = min(tile_rows, T_ - r0)
            buf = np.full(tile_rows * W, POISON, np.uint32)
            for warp in range(tcs.WARPS):
                sub, phase = warp % rt, warp // rt
                if phase >= g or sub * 32 >= nrows:
                    continue
                rows = r0 + sub * 32 + lane
                inr = rows < T_
                safe = np.minimum(rows, T_ - 1)
                live = inr & valid[safe]
                for k in range(phase, W, g):
                    words = _row_words(cols, safe, live, lo, hi, k * 32)
                    buf[(sub * 32 + lane[inr]) * W + k] = words[inr]
            n, base = nrows * W, r0 * W
            assert base * 4 % 16 == 0                  # int4-aligned
            out[base:base + n] = buf[:n]
            writes[base:base + n] += 1
    assert (writes == 1).all()
    return out.reshape(T_, W)


# the reseed beat's six scans (C, Q, T at full scale: customer, item,
# author, order_line, orders, shopping_cart_line), T cut to <= 600
CLOCKSCAN_TPCW = [(2, 96, 600), (3, 352, 448), (1, 224, 524), (1, 96, 577),
                  (2, 128, 389), (1, 32, 600)]


@pytest.mark.parametrize("C,Q,Tn", CLOCKSCAN_TPCW)
def test_clockscan_walk_matches_plain(C, Q, Tn):
    """The persistent tile walk at 4 blocks (several tiles a block) and
    at one block per tile, ragged tails and invalid rows included."""
    rng = np.random.default_rng(C * Q + Tn)
    cols = rng.integers(-50, 100, (C, Tn)).astype(np.int32)
    lo = rng.integers(-60, 50, (C, Q)).astype(np.int32)
    hi = lo + rng.integers(0, 80, (C, Q)).astype(np.int32)
    valid = rng.random(Tn) > 0.15
    want = U(tref.clockscan_ref(*(torch.as_tensor(x)
                                  for x in (cols, lo, hi, valid))))
    np.testing.assert_array_equal(
        want, np.asarray(rref.clockscan_ref(
            *(jnp.asarray(x) for x in (cols, lo, hi, valid)))))
    for sms in (1, 132):
        np.testing.assert_array_equal(
            _clockscan_walk(cols, lo, hi, valid, sms), want)


def _fused_walk(ts, tj, sms):
    """fused_delta_kernel's grid: the block items (PANE tiles) a grid
    stride apart, then the warp items warp-major; every item taken once,
    every rid written exactly once.  Returns (words, rids) as numpy."""
    sgeom = tuple(tfd.scan_geometry(e) for e in ts)
    jgeom = tuple(tfd.join_geometry(e) for e in tj)
    desc, n_block = tfd.launch_schedule(sgeom, jgeom, tfd.copy_tiles(tj),
                                        "cpu")
    d = desc.numpy()
    N = d.shape[0]
    blocks = tfd.grid_blocks(n_block, N - n_block, sms)
    sn = [{k: v.numpy() for k, v in e._asdict().items()} for e in ts]
    jn = [{k: v.numpy() for k, v in e._asdict().items()} for e in tj]
    words = [U(e.carry).copy() for e in ts]
    rids = [np.full(e.keys.shape[0], POISON.view(np.int32)) for e in tj]
    writes = [np.zeros(e.keys.shape[0], np.int64) for e in tj]
    # what each block reads into shared memory first
    w0 = [min(max(int(e["w0"]), 0), g.Q // 32 - g.A)
          for e, g in zip(sn, sgeom)]
    seen = np.zeros(N, np.int64)
    for blk in range(blocks):
        for it in range(blk, n_block, blocks):
            seen[it] += 1
            kind, s, tile = d[it]
            assert kind == _PANE
            e, g = sn[s], sgeom[s]
            if int(e["span"]) <= 0:
                continue
            rows = tile * tfd.PANE_TILE + np.arange(tfd.PANE_TILE)
            rows = rows[rows < e["cols"].shape[1]]    # threads past T
            for a in range(g.A):
                words[s][rows, w0[s] + a] = _row_words(
                    e["cols"], rows, e["valid"][rows], e["lo_p"], e["hi_p"],
                    a * 32)
    for blk in range(blocks):
        for warp in range(tfd.WARPS):
            for it in range(n_block + warp * blocks + blk, N,
                            blocks * tfd.WARPS):
                seen[it] += 1
                kind, o, idx = d[it]
                if kind == _DIRTY and int(sn[o]["dn"]) > 0:
                    e = sn[o]
                    row = int(e["rows"][idx])
                    if 0 <= row < e["cols"].shape[1]:
                        for k in range(sgeom[o].Q // 32):  # lanes: queries
                            words[o][row, k] = _row_words(
                                e["cols"], [row], e["valid"][[row]], e["lo"],
                                e["hi"], k * 32)[0]
                elif kind == _PROBE and int(jn[o]["dn"]) > 0:
                    e = jn[o]
                    row = int(e["rows"][idx])
                    if 0 <= row < e["keys"].shape[0]:
                        key = int(e["keys"][row])
                        b = _route_bucket(e["bounds"], key)
                        hit = (e["bkeys"][b] == key) & (e["brows"][b] >= 0)
                        rids[o][row] = e["brows"][b][hit].max() \
                            if hit.any() else -1
                        writes[o][row] += 1
                elif kind == _COPY:
                    e = jn[o]
                    a = idx * tfd.COPY_TILE
                    b = min(a + tfd.COPY_TILE, e["keys"].shape[0])
                    i = np.arange(a, b)
                    skip = np.zeros(len(i), bool)
                    s0, s1 = np.searchsorted(e["rows"], [a, b])
                    if int(e["dn"]) > 0 and s1 > s0:
                        near = e["rows"][s0:s1]
                        at = np.searchsorted(near, i)
                        skip = (at < len(near)) & \
                            (near[np.minimum(at, len(near) - 1)] == i)
                    rids[o][i[~skip]] = e["rid_carry"][i[~skip]]
                    writes[o][i[~skip]] += 1
    assert (seen == 1).all()
    for w in writes:
        assert (w == 1).all()
    return words, rids


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_walk_matches_pallas_and_jnp(case, fused_reference):
    """The fused kernel's walk (PANE blocks, DIRTY / PROBE / COPY warps)
    at 4 blocks and at the full card's grid equals the reference."""
    ts, tj = _both(*FUSED_CASES[case])[2:]
    want = fused_reference(case)
    for sms in (1, 132):
        wt, rt = _fused_walk(ts, tj, sms)
        for wr, rr in want:
            assert len(wt) == len(wr) and len(rt) == len(rr)
            for a, b in zip(wt, wr):
                np.testing.assert_array_equal(a, np.asarray(b))
            for a, b in zip(rt, rr):
                np.testing.assert_array_equal(a, np.asarray(b))


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


def _partitioned_join_walk(keys_l, mask_l, bkeys, brows, bounds, mask_r,
                           sms):
    """partitioned_join_kernel's grid: warps a grid stride apart over
    chunks of 32 left rows; each lane routes and binary-searches its own
    row, then the lanes walk the chunk's flat [rows x W] range together,
    BATCH words a lane at a time, each word taking its row's rid from the
    owning lane (the shuffle).  Every rid and output word is written
    exactly once."""
    Tl, W = mask_l.shape
    Tr = mask_r.shape[0]
    blocks = tpj.grid_blocks(Tl, sms)
    assert blocks <= sms * 4
    rid = np.full(Tl, POISON.view(np.int32))
    out = np.full(Tl * W, POISON, np.uint32)
    rid_writes = np.zeros(Tl, np.int64)
    out_writes = np.zeros(Tl * W, np.int64)
    flat_l, flat_r = mask_l.reshape(-1), mask_r.reshape(-1)
    chunks = -(-Tl // tpj.CHUNK)
    lane = np.arange(tpj.CHUNK)
    for blk in range(blocks):
        for warp in range(tpj.WARPS):
            for c in range(blk * tpj.WARPS + warp, chunks,
                           blocks * tpj.WARPS):
                r0 = c * tpj.CHUNK
                n = min(tpj.CHUNK, Tl - r0)
                lane_rid = np.full(tpj.CHUNK, -1)
                for ln in range(n):
                    key = int(keys_l[r0 + ln])
                    b = _route_bucket(bounds, key)
                    lane_rid[ln] = _search_bucket(bkeys[b], brows[b], key)
                    rid[r0 + ln] = lane_rid[ln]
                    rid_writes[r0 + ln] += 1
                base, nw = r0 * W, n * W
                for e0 in range(0, nw, tpj.CHUNK * tpj.BATCH):  # uniform
                    for u in range(tpj.BATCH):
                        e = e0 + u * tpj.CHUNK + lane
                        lr = np.minimum(e // W, n - 1)
                        src = lane_rid[lr]              # __shfl_sync
                        on = e < nw
                        r = np.clip(src, 0, Tr - 1)
                        words = flat_l[base + e[on]] & flat_r[
                            r[on] * W + (e - lr * W)[on]]
                        out[base + e[on]] = np.where(src[on] >= 0, words, 0)
                        out_writes[base + e[on]] += 1
    assert (rid_writes == 1).all() and (out_writes == 1).all()
    return rid, out.reshape(Tl, W)


# (seed, Tr, Tl, W, valid_frac, B, extra buckets, right key range (None:
# distinct keys), Pallas in interpret mode); every case also probes keys
# below the first bound, past the last one and at INT_SENTINEL - 1
PJ_WALK_CASES = {
    "dup_runs_span_buckets": (0, 200, 129, 13, 0.9, 8, 0, 12, True),
    "empty_buckets": (1, 130, 33, 1, 0.2, 7, 3, None, False),
    "all_invalid_right": (2, 64, 31, 40, 0.0, 16, 1, None, True),
    "w40_sentinel_minus_one": (3, 100, 129, 40, 0.8, 16, 2, 30, False),
    "one_left_row": (4, 5, 1, 13, 1.0, 2, 2, None, True),
    "tpcw_bucket_256": (5, 300, 33, 13, 0.9, 256, 1, None, False),
    "tl31_w1": (6, 90, 31, 1, 0.7, 4, 0, 20, False),
}


@pytest.mark.parametrize("case", sorted(PJ_WALK_CASES))
def test_partitioned_join_walk_matches_pallas_and_jnp(case):
    """The redesigned partitioned join (lanes as rows, route and binary
    search per lane, warp-chunk intersect) replayed at one block and at
    the full card's grid equals the plain version, the JAX jnp reference
    and, on the marked cases, the Pallas kernel in interpret mode; its
    bucket layout is the one ``buckets_ordered`` accepts."""
    seed, Tr, Tl, W, frac, B, extra, krange, pallas = PJ_WALK_CASES[case]
    rng = np.random.default_rng(seed)
    if krange is None:
        keys_r = (rng.permutation(Tr * 3)[:Tr] - 2).astype(np.int32)
    else:                   # duplicate runs, longer than a bucket
        keys_r = rng.integers(0, krange, Tr).astype(np.int32)
    valid_r = rng.random(Tr) < frac
    keys_r[:min(2, Tr)] = INT_SENTINEL - 1
    keys_l = rng.choice(np.concatenate([keys_r, keys_r + 1]), Tl) \
        .astype(np.int32)
    edges = [INT_SENTINEL - 1, int(keys_r.min()) - 5, -2 ** 31,
             INT_SENTINEL, int(keys_r[valid_r].max()) + 1
             if valid_r.any() else 7]
    keys_l[:min(Tl, len(edges))] = edges[:Tl]
    mask_l, mask_r = _words(rng, (Tl, W)), _words(rng, (Tr, W))
    P = -(-Tr // B) + extra
    parts = ref_partitions(jnp.asarray(keys_r), jnp.asarray(valid_r), P, B)
    jargs = (jnp.asarray(keys_l), jnp.asarray(mask_l), *parts,
             jnp.asarray(mask_r))
    want_rid, want_mask = (np.asarray(x)
                           for x in rref.partitioned_join_ref(*jargs))
    if pallas:
        prid, pmask = partitioned_join_pallas(*jargs)
        np.testing.assert_array_equal(np.asarray(prid), want_rid)
        np.testing.assert_array_equal(np.asarray(pmask), want_mask)
    tparts = build_key_partitions(torch.as_tensor(keys_r),
                                  torch.as_tensor(valid_r), P, B)
    assert tpj.buckets_ordered(tparts[0], tparts[1])
    rid, mask = tref.partitioned_join_ref(torch.as_tensor(keys_l),
                                          T(mask_l), *tparts, T(mask_r))
    np.testing.assert_array_equal(rid.numpy(), want_rid)
    np.testing.assert_array_equal(U(mask), want_mask)
    bk, br, bounds = (x.numpy() for x in tparts)
    for sms in (1, 132):
        wrid, wmask = _partitioned_join_walk(keys_l, mask_l, bk, br, bounds,
                                             mask_r, sms)
        np.testing.assert_array_equal(wrid, want_rid)
        np.testing.assert_array_equal(wmask, want_mask)
    if case == "dup_runs_span_buckets":       # a run crosses a bucket edge
        assert any(bk[b, -1] == bk[b + 1, 0] and br[b + 1, 0] >= 0
                   for b in range(P - 1))


def test_buckets_ordered_rejects_what_the_binary_search_cannot_read():
    """``buckets_ordered`` accepts build_key_partitions' layout and
    refuses a bucket whose live rows are out of key order, whose equal
    keys have descending rows, or with a live row after a pad."""
    keys = torch.tensor([3, 1, 3, 2, 9, 3], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False, True])
    bk, br, _ = build_key_partitions(keys, valid, 2, 4)
    assert tpj.buckets_ordered(bk, br)
    for b, (i, j) in ((bk, (0, 1)), (br, (1, 2))):
        bad_k, bad_r = bk.clone(), br.clone()
        x = bad_k if b is bk else bad_r
        x[0, i], x[0, j] = x[0, j].clone(), x[0, i].clone()
        assert not tpj.buckets_ordered(bad_k, bad_r)
    gap = br.clone()
    gap[1, 0], gap[1, 1] = -1, gap[1, 0].clone()
    assert not tpj.buckets_ordered(bk, gap)


def test_partitions_reaching_the_join_are_ordered_for_its_search():
    """Every bucket set that reaches ``join_partitioned`` on an index-less
    engine — the reseed, beats after inserts, deletes and key updates on
    the join targets (partition refreshes), a fold's migration beat and
    the beats after it — is laid out as the kernel's binary search needs."""
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.plan import compile_plan
    from repro_torch.serving import QueryCycleServer
    from repro_torch.workloads import tpcw

    base_be = tb.get_backend("torch")
    seen = []

    def recorded(kl, ml, bkeys, brows, bounds, mr):
        seen.append(tpj.buckets_ordered(bkeys, brows))
        return base_be.join_partitioned(kl, ml, bkeys, brows, bounds, mr)
    tb.register_backend(dataclasses.replace(
        base_be, name="torch-partition-order-test",
        join_partitioned=recorded))
    si, sc = 64, 128
    catalog = tpcw.make_catalog(si, sc, dense_pk_index=False)
    templates, caps = tpcw.make_templates(catalog.schemas["item"].capacity)
    base = compile_plan(catalog, templates[:10],
                        {t.name: caps[t.name] for t in templates[:10]})
    data = tpcw.generate_data(np.random.default_rng(0), si, sc)
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="torch-partition-order-test", device="cpu",
                         delta_joins=False)
    server = QueryCycleServer(eng, background_folds=False)
    rng = np.random.default_rng(3)
    rebuilt = set()
    for beat in range(6):
        if beat == 3:
            out = server.register_template(templates[10], caps["order_lines"])
            assert out["status"] == "folding"
        if beat:
            # inserts (a duplicate item key among them), deletes and key
            # updates on the partitioned joins' PK tables
            server.submit_update("item", "insert", {
                "i_id": si + beat, "i_a_id": beat, "i_subject": 1,
                "i_title": 2, "i_pub_date": 11500, "i_cost": 10,
                "i_srp": 20, "i_stock": 5, "i_related1": 0})
            server.submit_update("item", "insert", {
                "i_id": beat, "i_a_id": 1, "i_subject": 1, "i_title": 2,
                "i_pub_date": 11500, "i_cost": 10, "i_srp": 20,
                "i_stock": 5, "i_related1": 0})
            server.submit_update("item", "delete",
                                 {"key": int(rng.integers(0, si))})
            server.submit_update("author", "update", {
                "key": int(rng.integers(0, si // 4)), "col": "a_id",
                "val": int(rng.integers(0, si // 4))})
            server.submit_update("orders", "delete",
                                 {"key": int(rng.integers(0, sc))})
        server.submit("best_sellers", {0: (0, 2 ** 30), 1: (0, 100)})
        server.submit("get_book", {0: (beat, beat + 3)})
        if beat > 3:
            server.submit("order_lines", {0: (beat, beat)})
        server.heartbeat()
        rebuilt |= {t for t, v in eng.last_parts_rebuilt.items() if v}
    assert eng.folds_done == 1
    assert {"item", "author", "orders"} <= rebuilt
    assert len(seen) >= 6 * 3 and all(seen)


def test_partitions_reaching_the_chained_delta_join_are_ordered():
    """Every bucket set that reaches ``join_delta`` on a chained
    index-less engine (``delta_joins=True``, a backend without
    ``fused_delta``) is laid out as the delta_join kernel's binary search
    needs: the key partitions carried from the reseed, and those rebuilt
    by inserts (a duplicate item key among them), deletes and key updates
    on the partitioned joins' PK tables, probed by the next beats' dirty
    spine rows (order_line inserts, cart updates).  Each delta-join beat
    probes every partitioned join in ONE join_delta call."""
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.lowering import lower_plan
    from repro_torch.workloads import tpcw

    base_be = tb.get_backend("torch")
    seen, live = [], []

    def recorded(join_in):
        seen.append([tpj.buckets_ordered(e.bkeys, e.brows)
                     for e in join_in])
        live.append(sum(int((e.rows < e.keys.shape[0]).sum())
                        for e in join_in))
        return base_be.join_delta(join_in)
    tb.register_backend(dataclasses.replace(
        base_be, name="torch-chained-order-test", fused_delta=None,
        join_delta=recorded))
    si, sc = 64, 128
    plan = tpcw.build_tpcw_plan(si, sc, dense_pk_index=False)
    n_part = sum(j.kind == "partitioned" for j in lower_plan(plan).joins)
    data = tpcw.generate_data(np.random.default_rng(0), si, sc)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="torch-chained-order-test", device="cpu")
    rng = np.random.default_rng(5)
    rebuilt, delta_beats = set(), 0
    for beat in range(9):
        if beat % 2 == 1:
            # the PK side: inserts (a duplicate item key), a delete and a
            # key update (partition refreshes; these beats probe in full)
            eng.submit_update("item", "insert", {
                "i_id": si + beat, "i_a_id": beat, "i_subject": 1,
                "i_title": 2, "i_pub_date": 11500, "i_cost": 10,
                "i_srp": 20, "i_stock": 5, "i_related1": 0})
            eng.submit_update("item", "insert", {
                "i_id": beat, "i_a_id": 1, "i_subject": 1, "i_title": 2,
                "i_pub_date": 11500, "i_cost": 10, "i_srp": 20,
                "i_stock": 5, "i_related1": 0})
            eng.submit_update("item", "delete",
                              {"key": int(rng.integers(0, si))})
            eng.submit_update("author", "update", {
                "key": int(rng.integers(0, si // 4)), "col": "a_id",
                "val": int(rng.integers(0, si // 4))})
            eng.submit_update("orders", "delete",
                              {"key": int(rng.integers(0, sc))})
        elif beat:
            # the spines: live dirty rows for the delta probes
            for _ in range(3):
                eng.submit_update("order_line", "insert", {
                    "ol_o_id": int(rng.integers(0, sc)),
                    "ol_i_id": int(rng.integers(0, si + 8)),
                    "ol_qty": 1, "ol_discount": 0})
            eng.submit_update("shopping_cart_line", "update", {
                "key": int(rng.integers(0, 64)), "col": "scl_i_id",
                "val": int(rng.integers(0, si + 8))})
        eng.submit("order_lines", {0: (beat, beat)})
        eng.submit("get_cart", {0: (12, 12)})
        eng.submit("get_book", {0: (5, 5)})
        eng.run_until_drained()
        rebuilt |= {t for t, v in eng.last_parts_rebuilt.items() if v}
        if eng.last_join_path == "delta":
            delta_beats += 1
            ops = eng.last_collect_stats["backend_ops"]
            assert ops["join_delta"] == 1 and ops["scan_delta"] == 1, ops
    assert {"item", "author", "orders"} <= rebuilt
    assert delta_beats >= 4 and len(seen) == delta_beats
    assert all(len(s) == n_part and all(s) for s in seen)
    assert all(n > 0 for n in live)     # each probed live dirty rows


def test_delta_join_inputs_are_the_partitioned_joins_key_partitions():
    """The lowering hands ``join_delta`` one DeltaJoinIn per PARTITIONED
    join, in the plan's join order, and nothing else: each is the spine's
    fk column and dirty rows and ``partitions[pk_table]``, which equals
    ``build_key_partitions`` of the PK table as the beat left it (the
    layout the delta_join kernel's binary search needs).  The plan's block
    join (TPC-W Buy Request's address lookup: ``address`` joined to the
    index-less 92-row ``country``), its spine dirtied by address moves,
    reaches no ``join_delta`` call."""
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.plan import (Join, Pred, QueryTemplate,
                                       compile_plan)
    from repro_torch.core.storage import build_key_partitions
    from repro_torch.workloads import tpcw

    base_be = tb.get_backend("torch")
    calls = []

    def recorded(join_in):
        calls.append(join_in)
        return base_be.join_delta(join_in)
    tb.register_backend(dataclasses.replace(
        base_be, name="torch-delta-join-inputs-test", fused_delta=None,
        join_delta=recorded))
    si, sc = 64, 128
    catalog = tpcw.make_catalog(si, sc, dense_pk_index=False)
    templates, caps = tpcw.make_templates(catalog.schemas["item"].capacity)
    templates.append(QueryTemplate(
        "buy_request_address", "address",
        preds=(Pred("address", "addr_id"),),
        joins=(Join("addr_co_id", "country"),), limit=1))
    plan = compile_plan(catalog, templates,
                        dict(caps, buy_request_address=16))
    data = tpcw.generate_data(np.random.default_rng(0), si, sc)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="torch-delta-join-inputs-test", device="cpu")
    joins = eng._lowered.joins
    probed = [j for j in joins if j.kind == "partitioned"]
    assert probed and [j.pk_table for j in joins
                       if j.kind == "block"] == ["country"]
    rng = np.random.default_rng(7)
    checked = 0
    for beat in range(5):
        if beat == 2:       # a PK-side write: partitions rebuilt
            eng.submit_update("item", "insert", {
                "i_id": si + beat, "i_a_id": 1, "i_subject": 1,
                "i_title": 2, "i_pub_date": 11500, "i_cost": 10,
                "i_srp": 20, "i_stock": 5, "i_related1": 0})
        elif beat:
            eng.submit_update("order_line", "insert", {
                "ol_o_id": int(rng.integers(0, sc)),
                "ol_i_id": int(rng.integers(0, si + 4)),
                "ol_qty": 1, "ol_discount": 0})
            eng.submit_update("address", "update", {
                "key": beat, "col": "addr_co_id",
                "val": int(rng.integers(0, 92))})
        eng.submit("order_lines", {0: (beat, beat)})
        eng.submit("get_book", {0: (5, 5)})
        eng.submit("buy_request_address", {0: (beat, beat)})
        n = len(calls)
        assert len(eng.run_until_drained()) == 1
        if eng.last_join_path != "delta":
            assert len(calls) == n
            continue
        join_in, = calls[n:]
        assert len(join_in) == len(probed)
        for e, st in zip(join_in, probed):
            spine, pk = eng.state[st.spine], eng.state[st.pk_table]
            assert torch.equal(e.keys, spine[st.fk_col])
            assert torch.equal(e.rows, spine["_dirty_rows"])
            want = build_key_partitions(pk[st.pk_col], pk["_valid"],
                                        st.n_partitions, st.bucket_cap)
            for got, w in zip((e.bkeys, e.brows, e.bounds), want):
                assert torch.equal(got, w)
        checked += 1
    assert checked >= 3


def test_hopper_ops_are_kernel_wrappers_with_plain_cpu_results():
    """Every op of the ``hopper`` backend is a kernel wrapper of
    ``repro_torch.kernels`` that returns its plain version's result on CPU
    tensors (no stub is left), and ``auto`` on the CPU is ``torch``."""
    hopper, plain = tb.get_backend("hopper"), tb.get_backend("torch")
    rng = np.random.default_rng(20)
    cols = torch.as_tensor(rng.integers(0, 40, (2, 96)).astype(np.int32))
    lo = torch.as_tensor(rng.integers(0, 20, (2, 64)).astype(np.int32))
    hi = lo + 15
    valid = torch.as_tensor(rng.random(96) < 0.9)
    rows = torch.as_tensor(np.array([3, 50, 95, 96, 96], np.int32))
    keys_r = torch.as_tensor(rng.permutation(90)[:40].astype(np.int32))
    valid_r = torch.as_tensor(rng.random(40) < 0.8)
    keys_l = torch.as_tensor(rng.integers(0, 90, 96).astype(np.int32))
    mask_l, mask_r = T(_words(rng, (96, 2))), T(_words(rng, (40, 2)))
    parts = build_key_partitions(keys_r, valid_r, 2, 32)
    codes = torch.as_tensor(rng.integers(-1, 12, 96).astype(np.int32))
    scan_in, join_in = _both(FUSED_CASES["block"][0],
                             FUSED_CASES["block"][1])[2:]
    args = {"scan": (cols, lo, hi, valid),
            "scan_delta": ((tb.DeltaScanIn(cols, lo, hi, valid, rows),
                            tb.DeltaScanIn(cols[:1], lo[:1], hi[:1], valid,
                                           rows[:3])),),
            "join_block": (keys_l, mask_l, keys_r, mask_r, valid_r),
            "join_partitioned": (keys_l, mask_l, *parts, mask_r),
            "join_delta": ((tb.DeltaJoinIn(keys_l, rows, *parts),
                            tb.DeltaJoinIn(keys_l[:60], rows[:3], *parts)),),
            "groupby": (codes, cols[0], mask_l, 12),
            "fused_delta": (scan_in, join_in)}
    assert sorted(args) == sorted(f.name for f in
                                  dataclasses.fields(tb.OperatorBackend)
                                  if f.name != "name")
    for op, a in args.items():
        fn = getattr(hopper, op)
        assert fn.__module__.startswith("repro_torch.kernels."), op
        assert fn.__module__ != "repro_torch.kernels.ref", op
        got, want = fn(*a), getattr(plain, op)(*a)
        for g, w in zip(_leaves(got), _leaves(want)):
            assert torch.equal(g, w), op
    assert tb.resolve_backend("auto", "cpu").name == "torch"


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)]
