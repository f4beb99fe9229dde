"""Port parity, kernels: the plain PyTorch version of each of the four
kernels on the main path (kernels/ref.py, and the hopper wrappers, which
compute it for CPU tensors) equals the JAX package's Pallas kernel in
interpret mode and its jnp reference, on the shapes of the reference's
own kernel tests; the fused kernel's descriptor equals the reference's.
The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py.
"""
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
@pytest.mark.parametrize("Tn,W,G", [(512, 1, 50), (700, 2, 100),
                                    (1024, 8, 300)])
def test_shared_groupby_plain_matches_pallas_and_jnp(Tn, W, G):
    rng = np.random.default_rng(Tn + G)
    gc = rng.integers(0, G, Tn).astype(np.int32)
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
    "join_only": ((), (mk_join(100, 50, 4, 4, 8),)),
}


# cases whose Pallas kernel also runs here, in interpret mode
FUSED_PALLAS = ("mixed", "empty_dirty_zero_span", "join_only")


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_delta_plain_matches_pallas_and_jnp(case):
    scans, joins = FUSED_CASES[case]
    rs, rj, ts, tj = _both(scans, joins)
    want = [rref.fused_delta_ref(rs, rj)]
    if case in FUSED_PALLAS:
        want.append(rfd.fused_delta_pallas(rs, rj, interpret=True))
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
    if not scans and not joins:
        return
    rbuckets = []
    for g, e in zip(rjg, rj):
        kd = e.keys[jnp.clip(e.rows, 0, e.keys.shape[0] - 1)]
        b = jnp.searchsorted(e.bounds, kd, side="right").astype(jnp.int32)
        rbuckets.append(jnp.clip(b - 1, 0, g.P - 1))
    rdesc = rfd.build_sdesc(rsched, rsg, rjg, [e.rows for e in rs],
                            rbuckets)
    tdesc = tfd.build_sdesc(tsched, tsg, tjg, [e.rows for e in ts],
                            tfd.route_probes(tj))
    np.testing.assert_array_equal(tdesc.numpy(), np.asarray(rdesc))


def test_hopper_off_path_ops_raise_and_name_the_roadmap():
    hopper = tb.get_backend("hopper")
    for op in ("join_block", "scan_delta", "join_delta"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(hopper, op)()
    assert tb.resolve_backend("auto", "cpu").name == "torch"

