"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU interpret mode, so every test here carries the
``cuda`` marker and skips where there is no card of compute capability
9.0+ or no nvcc.  The file imports torch, numpy and ``repro_torch`` only,
so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: words and rids bit-equal, group counts exact, group sums
within rtol 1e-6 (float atomics add in a varying order); flash attention
within rtol = atol / 5 = 1e-5 in float32 and 2e-2 in bfloat16 (the
reference's own test), and a bfloat16 LM prefill through the kernel
within 2e-2 of each tensor's largest magnitude of the plain version's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import smoke_config
from repro_torch.core.backends import (DeltaJoinIn, DeltaScanIn, FusedJoinIn,
                                       FusedScanIn)
from repro_torch.core.storage import INT_SENTINEL, build_key_partitions
from repro_torch.kernels import bitmask_join as tbj
from repro_torch.kernels import clockscan as tcs
from repro_torch.kernels import flash_attention as tfa
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


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    from torch.utils.cpp_extension import CUDA_HOME
    if not torch.cuda.is_available() or CUDA_HOME is None:
        pytest.skip("needs a CUDA device and nvcc (CUDA kernels have no "
                    "CPU interpret mode)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _t(a, dev, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _words(rng, shape, dev):
    return _t(rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
              .astype(np.uint32).view(np.int32), dev)


def _scan(rng, dev, T, C, Q, A, D, dn, span, seam=()):
    """One FusedScanIn: dirty rows include the ``seam`` rows (pane-tile
    edges), sentinel-padded to D slots."""
    cols = _t(rng.integers(0, 50, (C, T)), dev)
    lo = _t(rng.integers(0, 30, (C, Q)), dev)
    hi = lo + _t(rng.integers(0, 30, (C, Q)), dev)
    w0 = int(rng.integers(0, Q // 32 - A + 1))
    pool = [r for r in seam if r < T]
    rest = [r for r in rng.permutation(T) if r not in pool]
    rows = np.sort(np.asarray(pool + rest, np.int64)[:dn])
    rows = np.concatenate([rows, np.full(D - dn, T)])
    return FusedScanIn(
        cols, lo, hi, lo[:, w0 * 32:(w0 + A) * 32].contiguous(),
        hi[:, w0 * 32:(w0 + A) * 32].contiguous(),
        _t(rng.random(T) < 0.9, dev, torch.bool),
        _words(rng, (T, Q // 32), dev), _t(w0, dev), _t(span, dev),
        _t(rows, dev), _t(dn, dev))


def _join(rng, dev, Tl, Tr, D, dn, pseudo=False, seam=()):
    """One FusedJoinIn over key partitions, or over the block join's
    single-bucket pseudo-partitions; dirty rows include the ``seam``
    rows, ascending, sentinel-padded to D slots."""
    kr = _t(rng.permutation(Tr), dev)
    vr = _t(rng.random(Tr) < 0.9, dev, torch.bool)
    if pseudo:
        rows_r = torch.arange(Tr, dtype=torch.int32, device=dev)
        parts = (torch.where(vr, kr, INT_SENTINEL)[None],
                 torch.where(vr, rows_r, -1)[None],
                 _t([np.iinfo(np.int32).min], dev))
    else:
        parts = build_key_partitions(kr, vr, 2, Tr // 2 + 8)
    pool = [r for r in seam if r < Tl]
    rest = [r for r in rng.choice(Tl, min(Tl, dn + len(pool)), replace=False)
            if r not in pool]
    rows = np.sort(np.asarray(pool + rest, np.int64)[:dn])
    rows = np.concatenate([rows, np.full(D - dn, Tl)])
    return FusedJoinIn(_t(rng.integers(0, Tr, Tl), dev), _t(rows, dev),
                       _t(dn, dev), *parts, _t(rng.integers(-1, Tr, Tl), dev))


def _fused_case(case, rng, dev):
    """(scan_in, join_in) of one fused_delta card case."""
    i32 = np.iinfo(np.int32)
    if case == "mixed":
        return ((_scan(rng, dev, 300, 2, 64, 1, 8, 5, 1),
                 _scan(rng, dev, 256, 3, 96, 2, 16, 0, 0),
                 _scan(rng, dev, 700, 1, 32, 1, 4, 4, 1)),
                (_join(rng, dev, 300, 128, 8, 3),
                 _join(rng, dev, 256, 64, 8, 8, pseudo=True)))
    if case == "seams":
        return ((_scan(rng, dev, 300, 2, 64, 1, 8, 5, 1,
                       seam=(0, 255, 256, 299)),),
                (_join(rng, dev, 300, 64, 4, 2),))
    if case == "block":   # P = 1, B = the PK capacity, live probes
        return ((_scan(rng, dev, 500, 1, 32, 1, 16, 3, 1),),
                (_join(rng, dev, 500, 128, 16, 7, pseudo=True),
                 _join(rng, dev, 500, 100, 16, 2, pseudo=True)))
    if case == "identity":
        return ((_scan(rng, dev, 128, 2, 64, 2, 8, 0, 0),),
                (_join(rng, dev, 128, 32, 4, 0),))
    if case == "idle_stages_live_probes":   # span 0 and dn 0 everywhere
        return ((_scan(rng, dev, 300, 2, 64, 1, 8, 0, 0),
                 _scan(rng, dev, 700, 1, 32, 1, 4, 0, 0)),
                (_join(rng, dev, 300, 128, 8, 5),
                 _join(rng, dev, 256, 64, 8, 8, pseudo=True)))
    if case == "route_edges":   # probe keys below the first bound, above
        ji = []                 # the last, and at the int32 extremes
        for pseudo in (False, True):
            e = _join(rng, dev, 400, 160, 8, 6, pseudo=pseudo)
            keys, rows = e.keys.clone(), e.rows.long()
            lo_b, hi_b = int(e.bounds[0]), int(e.bounds[-1])
            for r, k in zip(rows[:4], (max(lo_b, i32.min + 1) - 1, i32.min,
                                       i32.max, min(hi_b, i32.max - 1) + 1)):
                keys[r] = k
            ji.append(e._replace(keys=keys))
        return (), tuple(ji)
    if case == "pads":   # the first pad at every slot position, and an
        # all-pad set whose live count says 1
        si = [_scan(rng, dev, 200, 1, 32, 1, 8, n, 1) for n in range(9)]
        ji = [_join(rng, dev, 200, 64, 8, n, pseudo=n % 2 == 1)
              for n in range(9)]
        si.append(_scan(rng, dev, 200, 2, 64, 1, 8, 0, 1)._replace(
            dn=_t(1, dev)))
        ji.append(_join(rng, dev, 200, 64, 8, 0)._replace(dn=_t(1, dev)))
        return tuple(si), tuple(ji)
    if case == "max_stages_joins":   # MAX_STAGES and MAX_JOINS
        return (tuple(_scan(rng, dev, 100 + 37 * s, 1 + s % 3,
                            32 * (1 + s % 4), 1, 8, s % 6, s % 2)
                      for s in range(tfd.MAX_STAGES)),
                tuple(_join(rng, dev, 100 + 53 * j, 64 + j, 8, j % 6,
                            pseudo=j % 2 == 1)
                      for j in range(tfd.MAX_JOINS)))
    if case == "order_line":   # a 116 640-row spine, dirty rows on the
        # pane-tile and copy-tile seams
        T = 116640
        return ((_scan(rng, dev, T, 1, 96, 1, 128, 6, 1,
                       seam=(0, 255, 256, 1023, 1024, T - 1)),),
                (_join(rng, dev, T, 12048, 128, 8,
                       seam=(0, 1023, 1024, 2047, 2048, T - 1)),))
    raise KeyError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,Q", [
    (1, 256, 32), (3, 515, 64), (2, 300, 416),
    # the reseed beat's six scans at full scale (customer, item, author,
    # order_line, orders, shopping_cart_line)
    (2, 43200, 96), (3, 12048, 352), (1, 3524, 224), (1, 116640, 96),
    (2, 38880, 128), (1, 43200, 32),
    (2, 1, 64), (1, 33, 32), (3, 8191, 416)])
def test_clockscan_matches_plain(cuda_device, C, T, Q):
    """Ragged tails, invalid rows, one row, one row past a warp's tile,
    and the main path's shapes."""
    rng = np.random.default_rng(C * T)
    dev = cuda_device
    cols = _t(rng.integers(-50, 100, (C, T)), dev)
    lo = _t(rng.integers(-60, 50, (C, Q)), dev)
    hi = lo + _t(rng.integers(0, 80, (C, Q)), dev)
    valid = _t(rng.random(T) > 0.15, dev, torch.bool)
    assert torch.equal(tcs.clockscan(cols, lo, hi, valid),
                       tref.clockscan_ref(cols, lo, hi, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("T,W,G", [(512, 1, 50), (700, 2, 100)])
def test_shared_groupby_matches_plain(cuda_device, T, W, G):
    rng = np.random.default_rng(T + G)
    dev = cuda_device
    codes = _t(rng.integers(-2, G + 2, T), dev)     # some out of range
    vals = _t(rng.integers(1, 10, T), dev)
    mask = _words(rng, (T, W), dev)
    c1, s1 = tgb.shared_groupby(codes, vals, mask, G)
    c2, s2 = tref.shared_groupby_ref(codes, vals, mask, G)
    assert torch.equal(c1, c2)
    assert torch.allclose(s1, s2, rtol=1e-6)


def _gb_inputs(rng, dev, T, W, G, codes=None, full=False):
    """(codes, values, mask, G): codes drawn from [-2, G + 2) unless
    given, values 1..9 (TPC-W's ol_qty), random words or (``full``) every
    bit set."""
    if codes is None:
        codes = rng.integers(-2, G + 2, T)
    mask = (_t(np.full((T, W), -1), dev) if full
            else _words(rng, (T, W), dev))
    return _t(codes, dev), _t(rng.integers(1, 10, T), dev), mask, G


def _gb_equal(got, want):
    """Counts bit for bit, sums within rtol 1e-6 (atomic order)."""
    assert torch.equal(got[0], want[0])
    assert torch.allclose(got[1], want[1], rtol=1e-6)


# (T, W, G, case): no rows (the kernel still zeroes the outputs); one
# group; every code out of range; every bit of every word set; all rows
# in one group (every add of a word on the same 32 lines); a grid whose
# last stripe is ragged; a buffer smaller than the grid (late blocks get
# no stripe); the steady beat's shape at full scale
GB_EDGE = [(0, 2, 50, "random"), (900, 2, 1, "random"),
           (900, 2, 60, "out_of_range"), (700, 3, 40, "all_bits"),
           (5000, 2, 300, "one_group"), (5000, 3, 4097, "random"),
           (40000, 1, 3, "random"), (16384, 3, 12048, "random")]


def _gb_case(rng, dev, T, W, G, case):
    codes = {"out_of_range": lambda: np.where(rng.random(T) < 0.5, -1 - (
                 rng.integers(0, 5, T)), G + rng.integers(0, 5, T)),
             "one_group": lambda: np.full(T, G // 2)}.get(case, lambda: None)
    return _gb_inputs(rng, dev, T, W, G, codes(), full=case == "all_bits")


@pytest.mark.cuda
@pytest.mark.parametrize("T,W,G,case", GB_EDGE)
def test_shared_groupby_zeroes_a_poisoned_output(cuda_device, T, W, G, case):
    """The C launcher on a packed [2, G, Q] buffer first filled with NaN:
    a 16-byte unit that the first phase misses stays NaN."""
    rng = np.random.default_rng(T + W + G)
    codes, vals, mask, G = _gb_case(rng, cuda_device, T, W, G, case)
    out = torch.full((2, G, W * 32), float("nan"), device=cuda_device)
    blocks, stripe = tgb.launch_geometry(T, W, G, K.sm_count(cuda_device),
                                         tgb.blocks_per_sm())
    K.check_launch(K.library().shareddb_groupby(
        codes.data_ptr(), vals.data_ptr(), mask.data_ptr(), out.data_ptr(),
        T, W, G, blocks, stripe, K.stream_of(mask)), "shared_groupby")
    torch.cuda.synchronize()
    assert not out.isnan().any()
    _gb_equal((out[0], out[1]),
              tref.shared_groupby_ref(codes, vals, mask, G))


@pytest.mark.cuda
@pytest.mark.parametrize("T,W,G,case", GB_EDGE)
def test_shared_groupby_edge_shapes(cuda_device, T, W, G, case):
    """The wrapper: one launch a call, both outputs views of one packed
    buffer, equal to the plain version."""
    rng = np.random.default_rng(T * W + G)
    args = _gb_case(rng, cuda_device, T, W, G, case)
    K.reset_launches()
    count, ssum = tgb.shared_groupby(*args)
    assert K.LAUNCHES["shared_groupby"] == 1
    assert count.is_contiguous() and ssum.is_contiguous()
    assert ssum.data_ptr() == count.data_ptr() + count.numel() * 4
    _gb_equal((count, ssum), tref.shared_groupby_ref(*args))
    if case == "out_of_range":
        assert not count.any() and not ssum.any()


@pytest.mark.cuda
def test_shared_groupby_replays_in_a_cuda_graph(cuda_device):
    """One call captured in a CUDA graph, replayed on two inputs copied
    into its static buffers: each replay zeroes and accumulates anew."""
    rng = np.random.default_rng(27)
    dev = cuda_device
    T, W, G = 16384, 3, 12048
    static = [t.clone() for t in _gb_inputs(rng, dev, T, W, G)[:3]]
    tgb.shared_groupby(*static, G)          # build, load and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tgb.shared_groupby(*static, G)
    for _ in range(2):
        new = _gb_inputs(rng, dev, T, W, G)[:3]
        for s, n in zip(static, new):
            s.copy_(n)
        graph.replay()
        torch.cuda.synchronize()
        _gb_equal(out, tref.shared_groupby_ref(*new, G))


@pytest.mark.cuda
def test_shared_groupby_two_streams_at_once(cuda_device):
    """Two launches in flight on two streams (a beat beside a fold's
    warm-up): each barrier is its own launch's, each result its plain
    version's."""
    rng = np.random.default_rng(28)
    dev = cuda_device
    worlds = [_gb_inputs(rng, dev, 16384, 3, 12048),
              _gb_inputs(rng, dev, 43200, 2, 4097)]
    tgb.shared_groupby(*worlds[0])
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in worlds]
    gate = torch.cuda.Event()
    torch.cuda.current_stream(dev).record_event(gate)
    outs = []
    for _ in range(8):
        for stream, world in zip(streams, worlds):
            stream.wait_event(gate)
            with torch.cuda.stream(stream):
                outs.append((world, tgb.shared_groupby(*world)))
    torch.cuda.synchronize()
    for world, got in outs:
        _gb_equal(got, tref.shared_groupby_ref(*world))


@pytest.mark.cuda
@pytest.mark.parametrize("Tr,Tl,W,frac,B,extra", [
    (160, 120, 2, 0.8, 48, 0), (130, 300, 1, 0.2, 7, 3),
    (64, 64, 3, 0.0, 16, 1), (257, 129, 13, 1.0, 32, 0)])
def test_partitioned_join_matches_plain(cuda_device, Tr, Tl, W, frac, B,
                                        extra):
    """Duplicate right keys, empty buckets and all-invalid right sides."""
    rng = np.random.default_rng(Tr * Tl)
    dev = cuda_device
    keys_r = _t(rng.integers(-2, Tr, Tr), dev)
    valid_r = _t(rng.random(Tr) < frac, dev, torch.bool)
    parts = build_key_partitions(keys_r, valid_r, -(-Tr // B) + extra, B)
    kl = _t(rng.integers(-3, Tr + 3, Tl), dev)
    ml, mr = _words(rng, (Tl, W), dev), _words(rng, (Tr, W), dev)
    for a, b in zip(tpj.partitioned_join(kl, ml, *parts, mr),
                    tref.partitioned_join_ref(kl, ml, *parts, mr)):
        assert torch.equal(a, b)


def _pj_world(rng, dev, Tr, Tl, W, frac, B, extra, krange=None):
    """Key partitions of Tr right rows (distinct keys, or keys drawn from
    ``krange`` values: duplicate runs across buckets) and Tl left rows
    whose keys hit, miss, fall below the first bound, past the last and
    at INT_SENTINEL - 1."""
    keys_r = (rng.permutation(Tr * 3)[:Tr] - 2 if krange is None
              else rng.integers(0, krange, Tr)).astype(np.int64)
    keys_r[:min(2, Tr)] = INT_SENTINEL - 1
    valid_r = rng.random(Tr) < frac
    keys_l = rng.choice(np.concatenate([keys_r, keys_r + 1]), Tl)
    edges = [INT_SENTINEL - 1, int(keys_r.min()) - 5, -2 ** 31, INT_SENTINEL,
             int(keys_r[valid_r].max()) + 1 if valid_r.any() else 7]
    keys_l[:min(Tl, len(edges))] = edges[:Tl]
    parts = build_key_partitions(_t(keys_r, dev), _t(valid_r, dev, torch.bool),
                                 -(-Tr // B) + extra, B)
    return (_t(keys_l, dev), _words(rng, (Tl, W), dev), *parts,
            _words(rng, (Tr, W), dev))


# the reseed beat's four partitioned joins at full scale (TPC-W, 10 000
# items / 28 800 customers): (Tl, Tr, P) of item x author, order_line x
# orders, order_line x item, shopping_cart_line x item; B 256, W 13
PJ_TPCW = ((12048, 3524, 14), (116640, 38880, 152), (116640, 12048, 48),
           (43200, 12048, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("Tl,Tr,P", PJ_TPCW)
def test_partitioned_join_matches_plain_at_tpcw_shapes(cuda_device, Tl, Tr,
                                                      P):
    rng = np.random.default_rng(Tl + P)
    args = _pj_world(rng, cuda_device, Tr, Tl, 13, 0.9, 256,
                     P - -(-Tr // 256))
    assert args[2].shape == (P, 256)
    for a, b in zip(tpj.partitioned_join(*args),
                    tref.partitioned_join_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Tr,Tl,W,frac,B,extra,krange", [
    (200, 129, 13, 0.9, 8, 0, 12),      # duplicate runs across buckets
    (130, 33, 1, 0.2, 7, 3, None),      # empty buckets
    (64, 31, 40, 0.0, 16, 1, None),     # all-invalid right side
    (5, 1, 13, 1.0, 2, 2, None),        # one left row
    (100, 129, 40, 0.8, 16, 2, 30),
    (70000, 4097, 2, 0.9, 1, 3, None),  # P 70 003: bounds of 280 KB
])
def test_partitioned_join_edge_cases(cuda_device, Tr, Tl, W, frac, B, extra,
                                     krange):
    """Tl of 1, 31, 33, 129 and past a block's chunks; W 1, 13, 40; a P
    whose bounds would not fit in a block's shared memory."""
    rng = np.random.default_rng(Tr + Tl + W)
    args = _pj_world(rng, cuda_device, Tr, Tl, W, frac, B, extra, krange)
    assert tpj.buckets_ordered(args[2], args[3])
    before = K.LAUNCHES["partitioned_join"]
    for a, b in zip(tpj.partitioned_join(*args),
                    tref.partitioned_join_ref(*args)):
        assert torch.equal(a, b)
    assert K.LAUNCHES["partitioned_join"] == before + 1


def _delta_stage(rng, dev, T, C, Q, D, dn):
    """One DeltaScanIn: dn sorted dirty rows (row T-1 among them when dn
    is odd), sentinel-padded to D slots."""
    cols = _t(rng.integers(0, 50, (C, T)), dev)
    lo = _t(rng.integers(0, 30, (C, Q)), dev)
    hi = lo + _t(rng.integers(0, 30, (C, Q)), dev)
    pool = [T - 1] if dn % 2 else []
    rows = np.sort(np.concatenate([pool, rng.permutation(T - 1)])[:dn])
    return DeltaScanIn(cols, lo, hi, _t(rng.random(T) < 0.9, dev, torch.bool),
                       _t(np.concatenate([rows, np.full(D - dn, T)]), dev))


# (T, C, Q, D) of a chained steady beat's seven predicated stages at full
# scale: customer, item, author, order_line, orders, shopping_cart_line,
# address (14 templates, the index-less catalog)
DELTA_TPCW = ((43200, 2, 96, 128), (12048, 3, 352, 128), (3524, 1, 224, 128),
              (116640, 1, 96, 128), (38880, 2, 128, 128),
              (43200, 1, 32, 128), (51392, 1, 64, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chained_beat", "over_one_launch"])
def test_grouped_delta_scan_matches_plain(cuda_device, case):
    """One launch over the chained beat's seven stages (live dirty rows
    and pads); more stages than one argument block holds, D 0 among
    them, in ceil(n / DELTA_SCAN_STAGES) launches."""
    rng = np.random.default_rng(len(case))
    if case == "chained_beat":
        shapes = [(T, C, Q, D, 3 + 2 * i) for i, (T, C, Q, D)
                  in enumerate(DELTA_TPCW)]
    else:
        shapes = [(40 + 7 * s, 1 + s % 3, 32 * (1 + s % 4), 4 * (s % 4),
                   min(s % 5, 4 * (s % 4)))
                  for s in range(tfd.DELTA_SCAN_STAGES + 8)]
    stages = tuple(_delta_stage(rng, cuda_device, *x) for x in shapes)
    before = K.LAUNCHES["delta_scan"]
    got = tfd.delta_scan(stages)
    torch.cuda.synchronize()
    assert K.LAUNCHES["delta_scan"] == before + -(-len(stages)
                                                  // tfd.DELTA_SCAN_STAGES)
    want = tref.delta_scans_ref(stages)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_partitioned_join_and_delta_scan_never_synchronise(cuda_device):
    """Both wrappers enqueue their launch without a host sync (the
    heartbeat's dispatch runs under sync-debug "error")."""
    rng = np.random.default_rng(16)
    pj = _pj_world(rng, cuda_device, 38880, 116640, 13, 0.9, 256, 0)
    ds = tuple(_delta_stage(rng, cuda_device, T, C, Q, D, 5)
               for T, C, Q, D in DELTA_TPCW)
    tpj.partitioned_join(*pj)                   # build and load first
    tfd.delta_scan(ds)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_pj = tpj.partitioned_join(*pj)
        got_ds = tfd.delta_scan(ds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got_pj, tref.partitioned_join_ref(*pj)):
        assert torch.equal(a, b)
    for a, b in zip(got_ds, tref.delta_scans_ref(ds)):
        assert torch.equal(a, b)


FUSED_CARD_CASES = ["mixed", "seams", "identity", "block",
                    "idle_stages_live_probes", "route_edges", "pads",
                    "max_stages_joins", "order_line"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CARD_CASES)
def test_fused_delta_matches_plain(cuda_device, case):
    """Mixed stages and joins in one launch, dirty rows on pane-tile and
    copy-tile seams, the span == 0 / dn == 0 identity, idle stages with
    live probes, probe keys past either end of the bounds, pads at every
    slot position, 16 stages and 16 joins, and an order_line-sized
    spine; one launch each."""
    rng = np.random.default_rng(len(case))
    si, ji = _fused_case(case, rng, cuda_device)
    carries = [e.carry.clone() for e in si]
    want_w, want_r = tref.fused_delta_ref(si, ji)   # out of place
    before = K.LAUNCHES["fused_delta"]
    got_w, got_r = tfd.fused_delta(si, ji)          # words merge in place
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_delta"] == before + 1
    for a, b in zip(got_w + got_r, want_w + want_r):
        assert torch.equal(a, b)
    if case in ("identity", "idle_stages_live_probes"):
        for a, c in zip(got_w, carries):
            assert torch.equal(a, c)
    if case == "identity":
        assert torch.equal(got_r[0], ji[0].rid_carry)


@pytest.mark.cuda
@pytest.mark.parametrize("Tl,Tr,W,dup", [
    (256, 256, 1, False), (1024, 512, 8, False), (300, 100, 3, True),
    (51392 // 8, 128, 14, True), (200, 2500, 2, True), (1, 1, 1, False),
    (51392, 128, 14, True), (300, 500, 24, True), (777, 1500, 14, True),
    (2100, 500, 60, True), (300, 12000, 1, True)])
def test_bitmask_join_matches_plain(cuda_device, Tl, Tr, W, dup):
    """Ragged sides, invalid right rows that repeat a valid key (staged
    rows out of key order: rids by the scan); the fold path's migration
    shape (51 392 x 14 words against 128 rows) and that shape cut by 8;
    right sides staged in more than 48 KB of shared memory (500 x 24,
    1500 x 14), and right sides past STAGE_BYTES that take the chunked
    path (500 x 60 words, 12 000 x 1)."""
    rng = np.random.default_rng(Tl + Tr)
    dev = cuda_device
    keys_r = rng.permutation(Tr * 3)[:Tr]
    valid_r = rng.random(Tr) > 0.25
    if dup and Tr > 4:
        inv, val = np.flatnonzero(~valid_r), np.flatnonzero(valid_r)
        n = min(inv.size, val.size)
        keys_r[inv[:n]] = keys_r[rng.choice(val, n, replace=False)]
    kl = _t(rng.choice(Tr * 4, Tl), dev)
    args = (kl, _words(rng, (Tl, W), dev), _t(keys_r, dev),
            _words(rng, (Tr, W), dev), _t(valid_r, dev, torch.bool))
    assert (tbj.stage_bytes(Tr, W) > 48 * 1024) == (
        (Tr, W) in ((500, 24), (1500, 14)))
    assert (tbj.stage_bytes(Tr, W) == 0) == (W == 60 or Tr == 12000)
    before = K.LAUNCHES["bitmask_join"]
    for a, b in zip(tbj.bitmask_join(*args), tref.bitmask_join_ref(*args)):
        assert torch.equal(a, b)
    assert K.LAUNCHES["bitmask_join"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("Tl,Tr,W,live", [
    (51392, 128, 14, 92), (1000, 512, 3, 512), (33, 64, 1, 0),
    (700, 300, 14, 250)])
def test_bitmask_join_in_order_right_side(cuda_device, Tl, Tr, W, live):
    """A PK side that holds its live rows in key order ahead of its free
    rows (the fold path's country: 92 of 128), which the staged path
    searches as staged, without a sort; all rows live; none live."""
    rng = np.random.default_rng(Tl + live)
    dev = cuda_device
    keys_r = np.zeros(Tr, np.int64)
    keys_r[:live] = np.sort(rng.choice(4 * Tr, live, replace=False))
    kl = rng.choice(np.concatenate([keys_r, keys_r + 1, [-2 ** 31]]), Tl)
    args = (_t(kl, dev), _words(rng, (Tl, W), dev), _t(keys_r, dev),
            _words(rng, (Tr, W), dev), _t(np.arange(Tr) < live, dev,
                                           torch.bool))
    assert tbj.stage_bytes(Tr, W) > 0
    for a, b in zip(tbj.bitmask_join(*args), tref.bitmask_join_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("Tr", [128, 2048])
def test_bitmask_join_unaligned_left_mask(cuda_device, offset, Tr):
    """A mask_l whose first word is not on a 16-byte boundary (a view
    into a larger buffer): the kernel reads and writes word by word, on
    the staged and on the chunked path."""
    rng = np.random.default_rng(offset + Tr)
    dev = cuda_device
    Tl, W = 1000, 14
    keys_r = rng.permutation(Tr * 3)[:Tr]
    valid_r = rng.random(Tr) > 0.25
    buf = _words(rng, (Tl * W + offset,), dev)
    mask_l = buf[offset:].view(Tl, W)
    assert mask_l.data_ptr() % 16 != 0 and mask_l.is_contiguous()
    args = (_t(rng.choice(Tr * 4, Tl), dev), mask_l, _t(keys_r, dev),
            _words(rng, (Tr, W), dev), _t(valid_r, dev, torch.bool))
    for a, b in zip(tbj.bitmask_join(*args), tref.bitmask_join_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,Q,D,dn", [
    (300, 2, 64, 16, 5), (257, 3, 96, 8, 0), (1000, 1, 416, 128, 4),
    (64, 2, 32, 8, 8)])
def test_delta_scan_matches_plain(cuda_device, T, C, Q, D, dn):
    """Pad slots (clamped to row T-1), an all-pad set and a full one."""
    rng = np.random.default_rng(T + D)
    dev = cuda_device
    cols = _t(rng.integers(0, 50, (C, T)), dev)
    lo = _t(rng.integers(0, 30, (C, Q)), dev)
    hi = lo + _t(rng.integers(0, 30, (C, Q)), dev)
    valid = _t(rng.random(T) < 0.9, dev, torch.bool)
    rows = np.sort(np.concatenate([[T - 1], rng.permutation(T - 1)])[:dn])
    rows = _t(np.concatenate([rows, np.full(D - dn, T)]), dev)
    got, = tfd.delta_scan((DeltaScanIn(cols, lo, hi, valid, rows),))
    assert torch.equal(got, tref.delta_scan_ref(cols, lo, hi, valid, rows))


def _delta_join_in(rng, dev, Tl, Tr, D, dn, P, B, krange=None):
    """One DeltaJoinIn over build_key_partitions' layout (P buckets of B;
    right keys distinct, or drawn from ``krange`` values: duplicate runs
    across buckets): dn sorted dirty rows (row Tl-1 among them when dn is
    odd), sentinel-padded to D slots; probe keys that hit, miss and fall
    past either end of the bounds."""
    keys_r = (rng.permutation(Tr * 3)[:Tr] - 2 if krange is None
              else rng.integers(0, krange, Tr))
    valid_r = rng.random(Tr) < 0.9
    keys_l = rng.choice(np.concatenate([keys_r, keys_r + 1]), Tl)
    keys_l[-3:] = [int(keys_r.min()) - 5, -2 ** 31, INT_SENTINEL - 1]
    pool = [Tl - 1] if dn % 2 else []
    rows = np.sort(np.concatenate([pool, rng.permutation(Tl - 1)])[:dn])
    parts = build_key_partitions(_t(keys_r, dev), _t(valid_r, dev, torch.bool),
                                 P, B)
    return DeltaJoinIn(_t(keys_l, dev),
                       _t(np.concatenate([rows, np.full(D - dn, Tl)]), dev),
                       *parts)


@pytest.mark.cuda
@pytest.mark.parametrize("Tl,Tr,D,dn,pseudo", [
    (300, 160, 16, 5, False), (128, 64, 8, 0, False),
    (5000, 128, 128, 6, True), (64, 100, 8, 8, True)])
def test_delta_join_matches_plain(cuda_device, Tl, Tr, D, dn, pseudo):
    """Partitioned and single-bucket (block) probes, pad slots clamped to
    row Tl-1, an all-pad set.  The kernel's binary search reads
    build_key_partitions' layout only, so a single-bucket case's
    row-order pseudo-partition reaches it re-laid by build_key_partitions
    at P = 1 (the same keys and live rows), and the kernel's rids are held
    to the plain version on the row-order bucket."""
    rng = np.random.default_rng(Tl + D)
    e = _join(rng, cuda_device, Tl, Tr, D, dn, pseudo=pseudo)
    parts = (e.bkeys, e.brows, e.bounds)
    if pseudo:
        parts = build_key_partitions(e.bkeys[0], e.brows[0] >= 0, 1, Tr)
    assert tpj.buckets_ordered(*parts[:2])
    got, = tfd.delta_join((DeltaJoinIn(e.keys, e.rows, *parts),))
    assert torch.equal(got, tref.delta_join_ref(e.keys, e.rows, e.bkeys,
                                                e.brows, e.bounds))


# (Tl, Tr, P) of a chained steady beat's four partitioned joins at full
# scale (item x author, order_line x orders, order_line x item,
# shopping_cart_line x item), B 256, 128 dirty-row slots each
DELTA_JOIN_TPCW = PJ_TPCW


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chained_beat", "over_one_launch",
                                  "many_buckets"])
def test_grouped_delta_join_matches_plain(cuda_device, case):
    """One launch over the chained beat's four probes (live dirty rows,
    pads, keys past either end of the bounds); more joins than one
    argument block holds, duplicate-key runs across buckets, all-pad,
    full and empty slot sets among them, in ceil(n / DELTA_JOINS)
    launches; one bucket a right row (70 003 bounds, a 17-step
    route)."""
    rng = np.random.default_rng(len(case) + 1)
    if case == "chained_beat":
        joins = [_delta_join_in(rng, cuda_device, Tl, Tr, 128, 3 + 2 * i, P,
                                256)
                 for i, (Tl, Tr, P) in enumerate(DELTA_JOIN_TPCW)]
    elif case == "many_buckets":
        joins = [_delta_join_in(rng, cuda_device, 300, 160, 16, 5, 4, 48),
                 _delta_join_in(rng, cuda_device, 4097, 70000, 128, 9,
                                70003, 1)]
    else:
        joins = [_delta_join_in(rng, cuda_device, 40 + 9 * j, 30 + 5 * j,
                                4 * (j % 4), min(j % 5, 4 * (j % 4)),
                                -(-(30 + 5 * j) // (8 + 8 * (j % 3))),
                                8 + 8 * (j % 3), 12 if j % 7 == 0 else None)
                 for j in range(tfd.DELTA_JOINS + 8)]
    assert all(tpj.buckets_ordered(e.bkeys, e.brows) for e in joins)
    before = K.LAUNCHES["delta_join"]
    got = tfd.delta_join(joins)
    torch.cuda.synchronize()
    assert K.LAUNCHES["delta_join"] == before + -(-len(joins)
                                                  // tfd.DELTA_JOINS)
    want = tref.delta_joins_ref(joins)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bitmask_join_and_delta_join_never_synchronise(cuda_device):
    """Both wrappers enqueue their launch without a host sync."""
    rng = np.random.default_rng(17)
    dev = cuda_device
    Tl, Tr, W = 51392, 128, 14
    bj = (_t(rng.choice(Tr * 4, Tl), dev), _words(rng, (Tl, W), dev),
          _t(rng.permutation(Tr * 3)[:Tr], dev), _words(rng, (Tr, W), dev),
          _t(rng.random(Tr) > 0.25, dev, torch.bool))
    dj = [_delta_join_in(rng, dev, Tl, Tr, 128, 5, P, 256)
          for Tl, Tr, P in DELTA_JOIN_TPCW]
    tbj.bitmask_join(*bj)                       # build and load first
    tfd.delta_join(dj)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_bj = tbj.bitmask_join(*bj)
        got_dj = tfd.delta_join(dj)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got_bj, tref.bitmask_join_ref(*bj)):
        assert torch.equal(a, b)
    for a, b in zip(got_dj, tref.delta_joins_ref(dj)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_chained_beat_launches_one_delta_join(cuda_device):
    """A chained index-less engine on the card (the hopper kernels without
    fused_delta) launches ONE delta_join and ONE delta_scan a steady
    beat, probing live dirty rows, and answers as its twin on the plain
    ``torch`` backend."""
    from repro_torch.core import backends as B
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.workloads import tpcw

    B.register_backend(dataclasses.replace(
        B.get_backend("hopper"), name="hopper-chained-test",
        fused_delta=None))
    si, sc = 64, 128
    plan = tpcw.build_tpcw_plan(si, sc, dense_pk_index=False)
    data = tpcw.generate_data(np.random.default_rng(0), si, sc)
    engs = [SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels=k, device=cuda_device)
            for k in ("hopper-chained-test", "torch")]
    rng = np.random.default_rng(3)
    for beat in range(4):
        ups = [("order_line", "insert", {
            "ol_o_id": int(rng.integers(0, sc)),
            "ol_i_id": int(rng.integers(0, si)), "ol_qty": 1,
            "ol_discount": 0}) for _ in range(3 if beat else 0)]
        qs = [("order_lines", {0: (beat, beat)}), ("get_cart", {0: (12, 12)}),
              ("get_book", {0: (5, 5)})]
        tickets = []
        before = dict(K.LAUNCHES)
        for e in engs:
            for u in ups:
                e.submit_update(*u)
            tickets.append([e.submit(n, p) for n, p in qs])
            e.run_until_drained()
        got = {k: n - before[k] for k, n in K.LAUNCHES.items()}
        if beat:
            assert engs[0].last_join_path == "delta"
            assert engs[0].last_collect_stats["backend_ops"]["join_delta"] \
                == 1
            assert got["delta_join"] == 1 and got["delta_scan"] == 1, got
        for a, b in zip(*tickets):
            for k, want in b.result.items():
                assert np.array_equal(np.asarray(a.result[k]),
                                      np.asarray(want)), (beat, a.template, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", [
    (1, 128, 128, 4, 4, 64, True, 0), (2, 256, 256, 8, 2, 64, True, 0),
    (2, 256, 256, 8, 4, 32, True, 64), (1, 128, 256, 4, 1, 128, False, 0),
    (2, 128, 128, 4, 4, 64, True, 32),          # tests/test_kernels.py's
    (1, 24, 24, 4, 2, 16, True, 0), (1, 200, 200, 8, 2, 128, True, 0),
    (2, 100, 300, 4, 2, 64, True, 0), (1, 300, 100, 4, 4, 128, True, 0),
    (1, 200, 70, 2, 1, 16, True, 16), (1, 77, 130, 4, 4, 32, False, 20),
    (1, 512, 512, 32, 4, 128, True, 0),         # yi-6b's prefill
    (1, 2048, 2048, 32, 16, 128, True, 1024),   # gemma3-27b's local layer
    (1, 2048, 2048, 32, 16, 128, True, 0),      # and its global layer
    (1, 512, 512, 16, 16, 128, True, 0),        # qwen2-moe-a2.7b's (MHA)
    (1, 512, 512, 10, 1, 256, True, 2048),      # recurrentgemma-2b's
    (1, 1536, 1536, 12, 12, 64, False, 0),      # whisper-small's encoder
    (1, 512, 6404, 64, 8, 128, False, 0),       # llama-vision's cross
    (1, 192, 1536, 12, 12, 64, False, 0),       # whisper-small's cross
    (1, 100, 300, 4, 2, 256, False, 0)])        # D 256, ragged, Sq != Sk
def test_flash_attention_matches_plain(cuda_device, dtype, B, Sq, Sk, H, KV,
                                       D, causal, window):
    """Ragged S, Sq < Sk, D 16 and 128, causal Sq > Sk (its first rows
    see no key and average v, finite), non-causal Sq = Sk and Sq != Sk,
    D 256, and the LM paths' prefill shapes on standard-normal inputs (a
    soft softmax).  bfloat16 at D 64 / 128 / 256 runs the tensor-core
    kernel, the rest the CUDA-core kernel: the per-route launch count
    shows which ran."""
    rng = np.random.default_rng(Sq * Sk + D)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=dt,
                               device=cuda_device)
               for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    kind = tfa.route(dt, D)
    assert kind == ("wgmma" if dtype == "bfloat16" and D in (64, 128, 256)
                    else "simt")
    before = K.LAUNCHES["flash_attention"]
    by_route = dict(K.FLASH_ROUTE_LAUNCHES)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == before + 1
    assert {r: n - by_route[r] for r, n in K.FLASH_ROUTE_LAUNCHES.items()} \
        == {r: int(r == kind) for r in by_route}
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == dt and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=5 * tol)


def _admission_kernel_matches_plain(dev, cfg, route):
    """One admission of ``cfg`` (bfloat16, a right-padded prompt) on
    kernels="hopper" against kernels="torch" on the same weights: the
    prefill logits and the inserted slot cache (every field: K / V, conv
    and recurrent states), within 2e-2 of each tensor's largest magnitude,
    positions equal; every attending prefill layer (attention, cross, an
    encoder's) ran ``route``."""
    from repro_torch.models import transformer
    from repro_torch.serving import CycleServer
    progs = (transformer.build_program(cfg),) + (
        (transformer.build_encoder_program(cfg),) if cfg.enc_dec else ())
    attending = sum(sp.kind in ("attn", "cross") for p in progs
                    for sp in p.group * p.n_groups + p.leftover)
    kw = dict(capacity=2, max_seq=128, prefill_len=96, device=dev)
    srv = CycleServer(cfg, kernels="hopper", seed=0, **kw)
    twin = CycleServer(cfg, kernels="torch", params=srv.params, **kw)
    outs = []
    for s in (srv, twin):
        prefill = s._prefill

        def rec(*a, _prefill=prefill):
            out = _prefill(*a)
            outs.append(out)
            return out
        s._prefill = rec
        s.submit(list(range(1, 71)), max_new_tokens=2)
        before = K.LAUNCHES["flash_attention"]
        routed = K.FLASH_ROUTE_LAUNCHES[route]
        s.run_cycle()
        torch.cuda.synchronize()
        n = attending if s is srv else 0
        assert K.LAUNCHES["flash_attention"] - before == n
        assert K.FLASH_ROUTE_LAUNCHES[route] - routed == n
    (lg, c1), (tlg, tc1) = outs

    def close(a, b):
        scale = b.float().abs().max()
        assert (a.float() - b.float()).abs().max() <= 2e-2 * scale
    close(lg, tlg)
    for key in c1:
        for f, t in c1[key].items():
            if t.dtype == torch.int32:
                assert torch.equal(t, tc1[key][f])
            else:
                close(t, tc1[key][f])
        if "pos" in c1[key]:
            # the slot cache holds the prompt's K (the decode step then
            # wrote position 70, after its own token)
            close(srv.cache[key]["k"][:, 0, :70],
                  twin.cache[key]["k"][:, 0, :70])


@pytest.mark.cuda
def test_cycle_server_admission_kernel_matches_plain(cuda_device):
    """One admission of a bfloat16 smoke LM (GQA 4:2, D 16: the CUDA-core
    kernel, a right-padded prompt) on kernels="hopper" against
    kernels="torch" on the same weights: the prefill logits and the
    inserted slot cache."""
    cfg = dataclasses.replace(smoke_config("yi-6b"), n_kv=2)
    _admission_kernel_matches_plain(cuda_device, cfg, "simt")


@pytest.mark.cuda
def test_cycle_server_admission_d128_kernel_matches_plain(cuda_device):
    """The same admission at head dim 128 (GQA 4:2): the tensor-core
    kernel."""
    cfg = dataclasses.replace(smoke_config("yi-6b"), n_kv=2, head_dim=128)
    _admission_kernel_matches_plain(cuda_device, cfg, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [
    ("recurrentgemma-2b", 256), ("mamba2-370m", 16),
    ("llama-3.2-vision-90b", 128), ("whisper-small", 64)])
def test_cycle_server_admission_new_programs_match_plain(cuda_device, arch,
                                                         head_dim):
    """The same admission through the recurrent (at head dim 256, one KV
    head), SSD, cross-attention (zero vision tokens) and encoder-decoder
    (768 zero frames) programs: the tensor-core kernel on every attending
    layer, the recurrent and SSD states within the tolerance."""
    cfg = dataclasses.replace(smoke_config(arch), head_dim=head_dim)
    if arch == "recurrentgemma-2b":
        cfg = dataclasses.replace(cfg, n_kv=1)
    _admission_kernel_matches_plain(cuda_device, cfg, "wgmma")


# ------------------------------------------------- the compiled beat (graphs)
def _twin_engines(dev, kind, **kw):
    """A graphed engine (``jit=True``) and its ``jit=False`` twin on the
    same plan and data: ``dense`` / ``indexless`` on hopper, ``chained``
    on hopper without fused_delta."""
    from repro_torch.core import backends as B
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.workloads import tpcw

    B.register_backend(dataclasses.replace(
        B.get_backend("hopper"), name="hopper-chained-graph-test",
        fused_delta=None))
    si, sc = 64, 128
    plan = tpcw.build_tpcw_plan(si, sc, dense_pk_index=kind == "dense")
    data = tpcw.generate_data(np.random.default_rng(0), si, sc)
    kernels = "hopper-chained-graph-test" if kind == "chained" else "hopper"
    return [SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels=kernels, device=dev, jit=jit, **kw)
            for jit in (True, False)]


def _fold_template():
    from repro_torch.core.plan import Join, Pred, QueryTemplate
    return QueryTemplate("buy_request_address", "address",
                         preds=(Pred("address", "addr_id"),),
                         joins=(Join("addr_co_id", "country"),), limit=1)


# (updates, fold before the beat): a reseed, an item update (delta scans
# with full join probes), a customer update (delta scans and joins), the
# fold's migration beat, steady beats after it
GRAPH_STREAM = (
    ([], False),
    ([("item", "update", {"key": 7, "col": "i_cost", "val": 1234})], False),
    ([("customer", "update", {"key": 3, "col": "c_expiration",
                              "val": 900})], False),
    ([("customer", "update", {"key": 4, "col": "c_expiration",
                              "val": 901})], True),
    ([("customer", "update", {"key": 5, "col": "c_expiration",
                              "val": 902}),
      ("address", "update", {"key": 7, "col": "addr_co_id", "val": 3})],
     False),
    ([("customer", "update", {"key": 6, "col": "c_expiration",
                              "val": 903})], False))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "indexless", "chained"])
def test_graphed_engine_equals_eager(cuda_device, kind):
    """Every flavour and a background fold (captured on the fold thread):
    the graphed engine's tickets equal its ``jit=False`` twin's bit for
    bit, with the same paths, backend ops and kernel launches a beat;
    ``dispatch()`` raises no sync except in the migration beat."""
    import time

    eng, eager = _twin_engines(cuda_device, kind)
    assert eng.graphed and not eager.graphed
    assert len(eng._gen.graphs) == 6 and not eager._gen.graphs
    paths = []
    for beat, (ups, fold) in enumerate(GRAPH_STREAM):
        if fold:
            eng.begin_fold([_fold_template()], {"buy_request_address": 16})
            eager.begin_fold([_fold_template()], {"buy_request_address": 16},
                             background=False)
            deadline = time.monotonic() + 120
            while not eng.fold_ready():
                assert time.monotonic() < deadline, "fold build hangs"
                time.sleep(0.01)
        tickets, launched = [], []
        for e in (eng, eager):
            for u in ups:
                e.submit_update(*u)
            tickets.append([e.submit(n, {0: p}) for n, p in (
                ("get_book", (5, 5)), ("get_cart", (12, 12)),
                ("order_lines", (26, 26)), ("get_customer", (8, 8)))])
            if e.folds_done or fold:
                tickets[-1] += [e.submit("buy_request_address", {0: (a, a)})
                                for a in (5, 7, 9, 11)]
            torch.cuda.synchronize()
            before = dict(K.LAUNCHES)
            if not fold:
                torch.cuda.set_sync_debug_mode("error")
            try:
                e.dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            e.collect()
            launched.append({k: n - before[k] for k, n in K.LAUNCHES.items()
                             if n != before[k]})
        paths.append((eng.last_scan_path, eng.last_join_path))
        assert paths[-1] == (eager.last_scan_path, eager.last_join_path)
        assert eng.last_collect_stats["backend_ops"] == \
            eager.last_collect_stats["backend_ops"], beat
        assert launched[0] == launched[1] and launched[0], (beat, launched)
        for a, b in zip(*tickets):
            for k, want in b.result.items():
                assert np.array_equal(a.result[k], want), (beat, a.template, k)
    assert eng.folds_done == eager.folds_done == 1
    assert len(eng.capture_stats) == 2
    assert all(st["graphs"] == 6 and st["pool_bytes"] > 0
               for st in eng.capture_stats)
    assert ("delta", "delta" if kind != "dense" else "") in paths
    if kind != "dense":
        assert ("delta", "full") in paths
    assert paths[3][0] == "full"                  # the migration beat


@pytest.mark.cuda
def test_graphed_steady_beat_counts_one_fused_delta(cuda_device):
    """Steady index-less beats, graphed, two in flight: each replay
    counts the captured launches (one fused_delta, one shared_groupby)
    and ``{"fused_delta": 1, "groupby": 1}`` backend ops, and beat N's
    results are unchanged after beat N+1 is dispatched."""
    from repro_torch.core import graphs as cg

    eng, _ = _twin_engines(cuda_device, "indexless")
    kept = None
    for beat in range(4):
        eng.submit_update("customer", "update", {
            "key": 3 + beat, "col": "c_expiration", "val": 900 + beat})
        eng.submit("get_book", {0: (5, 5)})
        eng.submit("get_cart", {0: (12, 12)})
        before = dict(K.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = {k: n - before[k] for k, n in K.LAUNCHES.items()
               if n != before[k]}
        if beat:
            assert got == {"fused_delta": 1, "shared_groupby": 1}, got
            older = eng._inflight[0].results
            assert all(torch.equal(a, b)
                       for a, b in zip(cg.leaves(older), kept)), beat
            eng.collect()
        if beat > 1:
            assert eng.last_collect_stats["backend_ops"] == \
                {"fused_delta": 1, "groupby": 1}
        kept = [t.clone() for t in cg.leaves(eng._inflight[-1].results)]
    eng.collect()


@pytest.mark.cuda
def test_collect_returns_behind_its_own_beat(cuda_device):
    """Graphed, beats n and n+1 in flight and a long sleep queued on the
    serving stream behind them: collect() of n returns while an event
    recorded after the sleep has not completed (n's results reached
    pinned host memory right behind its own graph, in one copy issued at
    dispatch), and n's answers equal the eager twin's."""
    eng, eager = _twin_engines(cuda_device, "indexless")
    queries = (("get_book", (5, 5)), ("get_cart", (12, 12)),
               ("order_lines", (26, 26)), ("get_customer", (8, 8)))
    tickets = []
    for e in (eng, eager):
        e.submit("get_book", {0: (3, 3)})
        e.run_cycle()                       # the reseed beat
        e.submit_update("customer", "update", {
            "key": 3, "col": "c_expiration", "val": 900})
        tickets.append([e.submit(n, {0: p}) for n, p in queries])
        e.dispatch()
        e.submit("get_book", {0: (9, 9)})
        e.dispatch()
        if e is eng:
            torch.cuda._sleep(2_000_000_000)    # ~1 s at 1.98 GHz
            after = torch.cuda.Event()
            after.record()
        e.collect()
        if e is eng:
            assert not after.query(), "collect waited behind a later beat"
            s = e.last_collect_stats
            assert s["d2h_copies"] == s["copies_at_dispatch"] == 1
            assert len(s["beats"]) == 1
            after.synchronize()
        e.collect()
    assert all(t.result is not None for t in tickets[0])
    for a, b in zip(*tickets):
        for k, want in b.result.items():
            assert np.array_equal(a.result[k], want), (a.template, k)


@pytest.mark.cuda
def test_planlint_on_the_card(cuda_device):
    """planlint's sweep on the card over both backends exits 0; a graphed
    index-less engine was gated once, its fixed buffers are disjoint, and
    after a steady beat the descriptor its fused_delta launch cached
    passes the kernel passes at the card's SM count."""
    from repro_torch.analysis_static import (errors_in, kernel_passes, lint,
                                             trace_passes)
    assert lint.main(["--backends", "torch,hopper"]) == 0
    eng, _ = _twin_engines(cuda_device, "indexless")
    assert len(eng.gate_s) == 1
    assert errors_in(trace_passes.lint_buffer_aliasing(
        eng._gen, eng.state)) == []
    for beat in range(2):
        eng.submit_update("customer", "update", {
            "key": 3 + beat, "col": "c_expiration", "val": 900 + beat})
        eng.submit("get_book", {0: (5, 5)})
        eng.run_cycle()
    assert eng.last_join_path == "delta"
    geom = kernel_passes.geometry_from_lowered(eng._lowered)
    dev = eng.state["item"]["_valid"].device
    hits = tfd.launch_schedule.cache_info().hits
    desc, n_block = kernel_passes.launch_descriptor(geom, dev)
    assert tfd.launch_schedule.cache_info().hits == hits + 1
    assert errors_in(kernel_passes.run_kernel_passes(
        geom, desc, n_block, sms=K.sm_count(dev))) == []


# ------------------------------------------------- the traced beat
def _traced_pair(dev, scale=(1000, 2880)):
    """Graphed index-less engines on one plan and data, tracing off and
    on, at a scale whose beats take milliseconds."""
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.workloads import tpcw
    si, sc = scale
    plan = tpcw.build_tpcw_plan(si, sc, dense_pk_index=False)
    data = tpcw.generate_data(np.random.default_rng(0), si, sc)
    return [SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels="hopper", device=dev, trace=trace)
            for trace in (False, True)]


def _traced_beat(e, beat):
    """The same admission every beat (so beats after the first may take
    the delta path) and a customer update, with an item update every
    third beat."""
    e.submit_update("customer", "update", {
        "key": 3 + beat, "col": "c_expiration", "val": 900 + beat})
    if beat % 3 == 2:
        e.submit_update("item", "update", {"key": 7 + beat, "col": "i_cost",
                                           "val": 1234 + beat})
    e.submit("get_book", {0: (5, 5)})
    e.submit("get_cart", {0: (12, 12)})
    e.submit("best_sellers", {0: (0, 400), 1: (1, 3)})


@pytest.mark.cuda
def test_traced_graph_stages_sum_to_the_replay(cuda_device):
    """Every graph of a ``trace=True`` engine holds its stage marks from
    ``start`` to ``commit`` and a ``trace=False`` one holds none; the
    launches a replay counts are the same either way; and each traced
    beat's stages sum to within 10 % of a CUDA event pair around its
    replay (never above it), with full and delta beats both seen."""
    off, on = _traced_pair(cuda_device)
    assert off.graphed and on.graphed
    assert all(not g.marks for g in off._gen.graphs.values())
    for g in on._gen.graphs.values():
        names = [n for n, _ in g.marks]
        assert names[0] == "start" and names[-1] == "commit"
        assert "apply" in names and len(names) == len(set(names))
    pairs = []
    real = on._run_beat

    def timed(flavour, slot):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        marks = real(flavour, slot)
        ev1.record()
        pairs.append((ev0, ev1))
        return marks
    on._run_beat = timed
    paths = set()
    for beat in range(8):
        launched = []
        for e in (off, on):
            _traced_beat(e, beat)
            before = dict(K.LAUNCHES)
            e.dispatch()
            launched.append({k: n - before.get(k, 0)
                             for k, n in K.LAUNCHES.items()})
            e.collect()
        assert launched[0] == launched[1], (beat, launched)
        assert off.last_collect_stats["stage_s"] == {}
        stage_ms = sum(on.last_collect_stats["stage_s"].values()) * 1e3
        ev0, ev1 = pairs[-1]
        ev1.synchronize()
        pair_ms = ev0.elapsed_time(ev1)
        assert 0.9 * pair_ms <= stage_ms <= pair_ms * 1.001, \
            (beat, stage_ms, pair_ms)
        assert all(v >= 0 for v in on.last_collect_stats["stage_s"].values())
        paths.add(on.last_scan_path)
    assert paths == {"full", "delta"}


@pytest.mark.cuda
def test_traced_eager_beat_names_the_graphed_stages(cuda_device):
    """On the card an eager traced beat records ordinary timing events at
    the same marks as the captured ones: the same stage names, in order,
    beat for beat."""
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.workloads import tpcw
    plan = tpcw.build_tpcw_plan(64, 128, dense_pk_index=False)
    data = tpcw.generate_data(np.random.default_rng(0), 64, 128)
    engs = [SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels="hopper", device=cuda_device, jit=jit,
                           trace=True) for jit in (True, False)]
    for beat in range(4):
        for e in engs:
            _traced_beat(e, beat)
            e.run_cycle()
        a, b = (list(e.last_collect_stats["stage_s"]) for e in engs)
        assert a == b and a[-1] == "commit", (beat, a, b)


# ------------------------------------------------- the sharded heartbeat
# (updates) of each beat: a reseed, an item update (delta scans, full
# join probes), then customer and cart updates (delta scans and joins)
SHARDED_STREAM = (
    [],
    [("item", "update", {"key": 7, "col": "i_cost", "val": 1234})],
    [("customer", "update", {"key": 3, "col": "c_expiration", "val": 900})],
    [("customer", "update", {"key": 4, "col": "c_expiration", "val": 901}),
     ("shopping_cart_line", "update", {"key": 2, "col": "scl_qty",
                                       "val": 3})],
    [("customer", "update", {"key": 5, "col": "c_expiration", "val": 902})])


def _sharded_beats(engines):
    """Drive every engine through SHARDED_STREAM; per beat and engine:
    (tickets, paths, backend ops, kernel launches, collectives)."""
    out = []
    for ups in SHARDED_STREAM:
        row = []
        for e in engines:
            for u in ups:
                e.submit_update(*u)
            tickets = [e.submit(n, {0: p}) for n, p in (
                ("get_book", (5, 5)), ("get_cart", (12, 12)),
                ("order_lines", (26, 26)), ("get_customer", (8, 8)))]
            tickets.append(e.submit("best_sellers",
                                    {0: (0, 2 ** 31 - 1), 1: (4, 4)}))
            torch.cuda.synchronize()
            before = dict(K.LAUNCHES)
            gathers = K.COLLECTIVES["all_gather_rows"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                e.dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            e.collect()
            row.append((tickets, (e.last_scan_path, e.last_join_path),
                        e.last_collect_stats["backend_ops"],
                        {k: n - before[k] for k, n in K.LAUNCHES.items()
                         if n != before[k]},
                        K.COLLECTIVES["all_gather_rows"] - gathers))
        out.append(row)
    return out


def _sharded_engines(dev, meshes):
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.sharding import make_row_mesh
    from repro_torch.workloads import tpcw
    plan = tpcw.build_tpcw_plan(64, 128, dense_pk_index=False)
    data = tpcw.generate_data(np.random.default_rng(0), 64, 128)
    return [SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                           kernels="hopper", jit=jit,
                           **({"device": dev} if n is None else
                              {"mesh": make_row_mesh(n, [dev] * n)}))
            for n, jit in meshes]


@pytest.mark.cuda
def test_sharded_mesh1_is_the_unsharded_engine_on_the_card(cuda_device):
    """Graphed, one shard on the card: tickets bit for bit, paths,
    backend ops, kernel launches and snapshots of the unsharded graphed
    engine, every beat."""
    base, s1 = _sharded_engines(cuda_device, [(None, True), (1, True)])
    assert base.graphed and s1.graphed
    for beat, (want, got) in enumerate(_sharded_beats([base, s1])):
        assert got[1:4] == want[1:4], (beat, got[1:4], want[1:4])
        for a, b in zip(got[0], want[0]):
            for k, w in b.result.items():
                assert a.result[k].dtype == w.dtype
                assert np.array_equal(a.result[k], w), (beat, a.template, k)
        for table in base.plan.catalog.schemas:
            sa, sb = s1.snapshot(table), base.snapshot(table)
            for k in sb:
                assert np.array_equal(sa[k], sb[k]), (beat, table, k)


@pytest.mark.cuda
def test_sharded_graphed_equals_eager_and_unsharded(cuda_device):
    """Two shards on the one card, graphed (one graph a flavour and slot:
    both shard bodies, the all_gathers and the merge) against the
    ``jit=False`` twin: tickets bit for bit, the same paths, backend ops,
    launches and collectives (one all_gather per mirrored predicated
    stage in the reseed, none in a delta beat); against the unsharded
    engine: the same row sets and group scores.  The twin's recorded
    bodies pass planlint's collective and locality rules on the card; a
    graphed mesh over distinct devices raises."""
    from repro_torch.analysis_static import errors_in, trace_passes
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.sharding import RowMesh

    s2, eager, base = _sharded_engines(
        cuda_device, [(2, True), (2, False), (None, True)])
    assert s2.graphed and len(s2._gen.graphs) == 6 and not eager.graphed
    spec = s2._gen.spec
    n_mi = sum(1 for st in s2._lowered.scans
               if spec.is_mirrored(st.table) and st.cols)
    for beat, (g, e, u) in enumerate(_sharded_beats([s2, eager, base])):
        assert g[1:] == e[1:], (beat, g[1:], e[1:])
        assert g[1] == u[1], beat
        assert g[4] == (n_mi if beat == 0 else 0), (beat, g[4])
        for a, b in zip(g[0], e[0]):
            for k, w in b.result.items():
                assert np.array_equal(a.result[k], w), (beat, a.template, k)
        for a, b in zip(g[0], u[0]):
            if "rows" in b.result:
                x, y = a.result["rows"], b.result["rows"]
                assert set(x[x >= 0].tolist()) == \
                    set(y[y >= 0].tolist()), beat
            else:
                assert np.allclose(np.sort(a.result["scores"], axis=-1),
                                   np.sort(b.result["scores"], axis=-1),
                                   rtol=1e-6)
    assert errors_in(trace_passes.run_trace_passes(eager)) == []
    two = RowMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(NotImplementedError, match="unverified"):
        SharedDBEngine(s2.plan, s2.update_slots, {}, kernels="hopper",
                       mesh=two)


@pytest.mark.cuda
def test_graphed_decode_equals_eager(cuda_device):
    """A bfloat16 smoke LM's CycleServer with the decode step captured
    against the same server run eagerly: the same greedy tokens."""
    from repro_torch.serving import CycleServer
    cfg = dataclasses.replace(smoke_config("yi-6b"), n_kv=2, head_dim=128)
    kw = dict(capacity=4, max_seq=64, prefill_len=16, prefill_budget=2,
              device=cuda_device)
    srv = CycleServer(cfg, seed=0, **kw)
    twin = CycleServer(cfg, params=srv.params, jit=False, **kw)
    assert srv.graphed and not twin.graphed
    assert srv.capture_stats["pool_bytes"] > 0
    reqs = []
    for s in (srv, twin):
        r = np.random.default_rng(0)
        reqs.append([s.submit(r.integers(1, cfg.vocab, n).tolist(), 12)
                     for n in (5, 16, 9, 3, 12)])
    srv.run_until_drained()
    twin.run_until_drained()
    for a, b in zip(*reqs):
        assert a.output == b.output and len(a.output) == 12


# ------------------------------------------------------------------- MoE
@pytest.mark.cuda
def test_moe_block_on_the_card_never_syncs_and_reruns_bit_equal(cuda_device):
    """The sort-dispatch MoE block on bfloat16 CUDA tensors, at a size
    with drops: no host synchronisation (sync-debug mode "error"), a
    re-run bit-equal (no atomics in the combine), and the float32 CPU
    run of the same block within 5e-2 of scale."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe
    rng = np.random.default_rng(0)
    E, k, D, F = 8, 2, 64, 32
    cfg = MoEConfig(num_experts=E, top_k=k, num_shared=1, d_ff_expert=F)
    p = {"router": rng.standard_normal((D, E)),
         "we_gate": rng.standard_normal((E, D, F)) / 8,
         "we_up": rng.standard_normal((E, D, F)) / 8,
         "we_down": rng.standard_normal((E, F, D)) / 8,
         "shared": {"w_gate": rng.standard_normal((D, F)) / 8,
                    "w_up": rng.standard_normal((D, F)) / 8,
                    "w_down": rng.standard_normal((F, D)) / 8}}
    p["router"][:, 0] += 0.3                 # expert 0 overfills
    x = rng.standard_normal((2, 64, D)) + 1.0

    def on(dev, dt, tree):
        if isinstance(tree, dict):
            return {key: on(dev, dt, v) for key, v in tree.items()}
        return torch.as_tensor(tree, dtype=dt, device=dev)
    pc, xc = on(cuda_device, torch.bfloat16, p), \
        on(cuda_device, torch.bfloat16, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y1, _ = moe.apply_moe(pc, xc, cfg, "swiglu")
        y2, _ = moe.apply_moe(pc, xc, cfg, "swiglu")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y1.device.type == "cuda" and torch.equal(y1, y2)
    want, _ = moe.apply_moe(on("cpu", torch.float32, p),
                            on("cpu", torch.float32, x), cfg, "swiglu")
    assert (y1.float().cpu() - want).abs().max() <= \
        5e-2 * want.abs().max()


@pytest.mark.cuda
def test_graphed_moe_decode_equals_eager(cuda_device):
    """qwen2-moe's bfloat16 smoke config (MHA, QKV bias, a shared expert)
    at head dim 128: the CycleServer with the decode step, MoE blocks and
    all, captured as a graph against the same server run eagerly: the
    same greedy tokens, and its prefills on the tensor-core kernel."""
    from repro_torch.serving import CycleServer
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"), head_dim=128)
    kw = dict(capacity=4, max_seq=64, prefill_len=16, prefill_budget=2,
              device=cuda_device)
    srv = CycleServer(cfg, seed=0, **kw)
    twin = CycleServer(cfg, params=srv.params, jit=False, **kw)
    assert srv.graphed and not twin.graphed
    reqs = []
    for s in (srv, twin):
        r = np.random.default_rng(0)
        reqs.append([s.submit(r.integers(1, cfg.vocab, n).tolist(), 12)
                     for n in (5, 16, 9, 3, 12)])
    routed = K.FLASH_ROUTE_LAUNCHES["wgmma"]
    srv.run_until_drained()
    assert K.FLASH_ROUTE_LAUNCHES["wgmma"] - routed == 5 * cfg.n_layers
    twin.run_until_drained()
    for a, b in zip(*reqs):
        assert a.output == b.output and len(a.output) == 12


# ------------------------------------------------------------------ the mesh
@pytest.fixture
def no_group_left():
    """No fake process group left behind for the next test."""
    yield
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    if dist.is_initialized():
        dist.destroy_process_group()
        dryrun.clear_dtensor_caches()


@pytest.mark.cuda
def test_graphed_mesh_decode_equals_eager(cuda_device, no_group_left):
    """A bfloat16 smoke LM served over a (2, 2) mesh of four simulated
    ranks on the card, its decode step captured (every rank's kernels in
    one graph), against the same mesh server run eagerly: every decode
    beat's logits within 1e-3 of scale, the same greedy tokens."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_axes
    from repro_torch.runtime.elastic import ElasticMeshManager
    from repro_torch.serving import CycleServer
    from repro_torch.core.device import host_numpy
    cfg = dataclasses.replace(smoke_config("yi-6b"), n_kv=2, head_dim=128)
    kw = dict(capacity=4, max_seq=64, prefill_len=16, prefill_budget=2,
              device=cuda_device)
    params = CycleServer(cfg, seed=0, jit=False, **kw).params
    outs, logits = [], []
    with dryrun.simulated_group(4):
        axes = make_axes(ElasticMeshManager().make_mesh((1, 2, 2)))
        for jit in (True, False):
            srv = CycleServer(cfg, axes, params=params, jit=jit, **kw)
            assert srv.graphed == jit
            r = np.random.default_rng(0)
            for n in (5, 16, 9, 3, 12):
                srv.submit(r.integers(1, cfg.vocab, n).tolist(), 8)
            beats = []
            while srv.pending() or srv.active():
                srv.dispatch()
                beats.append(host_numpy(srv._logits.float()))
                srv.collect()
            logits.append(beats)
            outs.append([q.output for q in sorted(srv.completed,
                                                  key=lambda q: q.id)])
    assert outs[0] == outs[1] and len(outs[0]) == 5
    assert len(logits[0]) == len(logits[1]) > 8
    for g, e in zip(*logits):
        assert np.abs(g - e).max() <= 1e-3 * np.abs(e).max()


@pytest.mark.cuda
def test_shrink_and_resume_restores_bit_equal_on_the_card(cuda_device,
                                                          no_group_left,
                                                          tmp_path):
    """The elastic shrink at smoke size on the card: a step on (1, 2, 2)
    of four simulated ranks, the checkpoint, the shrink to (1, 1, 2) and
    the restore: every leaf bit-equal to the checkpoint's bytes, the step
    counter resumed, and the resumed step runs."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.core.device import host_tensor
    from repro_torch.launch import dryrun, train
    from repro_torch.runtime.elastic import (ElasticMeshManager,
                                             shrink_and_resume)
    args = train.parse_args(["--arch", "stablelm-1.6b", "--smoke", "--batch",
                             "2", "--seq", "32", "--ckpt", str(tmp_path)])
    mgr = ElasticMeshManager(ladder=[(1, 2, 2), (1, 1, 2), (1, 1, 1)])
    with shrink_and_resume(mgr, (1, 2, 2), 2, CheckpointManager(str(tmp_path)),
                           steps=1, global_batch=2,
                           regroup=dryrun.simulated_group,
                           build=lambda axes: train.Trainer(args, axes=axes)
                           ) as r:
        assert r["plan"]["target"] == (1, 1, 2)
        state = r["state"]
        saved = np.load(tmp_path / "step_00000001" / "shard_0.npz")
        for path, t in pytree.flatten_with_path(state):
            assert t.device.type == "cuda"
            got = host_tensor(t)
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
            want = saved[pytree.path_key(path)]
            assert got.numpy().tobytes() == want.tobytes()
        assert int(host_tensor(state[1]["step"])) == 1
        state, m = r["trainer"].step_fn(state, 1)
        assert np.isfinite(m["loss"])
        assert int(host_tensor(state[1]["step"])) == 2
