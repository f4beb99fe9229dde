"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU interpret mode, so every test here carries the
``cuda`` marker and skips where there is no card of compute capability
9.0+ or no nvcc.  The file imports torch, numpy and ``repro_torch`` only,
so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: words and rids bit-equal, group counts exact, group sums
within rtol 1e-6 (float atomics add in a varying order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.backends import FusedJoinIn, FusedScanIn
from repro_torch.core.storage import INT_SENTINEL, build_key_partitions
from repro_torch.kernels import clockscan as tcs
from repro_torch.kernels import fused_delta as tfd
from repro_torch.kernels import partitioned_join as tpj
from repro_torch.kernels import ref as tref
from repro_torch.kernels import shared_groupby as tgb


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


def _join(rng, dev, Tl, Tr, D, dn, pseudo=False):
    """One FusedJoinIn over key partitions, or over the block join's
    single-bucket pseudo-partitions."""
    kr = _t(rng.permutation(Tr), dev)
    vr = _t(rng.random(Tr) < 0.9, dev, torch.bool)
    if pseudo:
        rows_r = torch.arange(Tr, dtype=torch.int32, device=dev)
        parts = (torch.where(vr, kr, INT_SENTINEL)[None],
                 torch.where(vr, rows_r, -1)[None],
                 _t([np.iinfo(np.int32).min], dev))
    else:
        parts = build_key_partitions(kr, vr, 2, Tr // 2 + 8)
    rows = np.sort(rng.choice(Tl, dn, replace=False))
    rows = np.concatenate([rows, np.full(D - dn, Tl)])
    return FusedJoinIn(_t(rng.integers(0, Tr, Tl), dev), _t(rows, dev),
                       _t(dn, dev), *parts, _t(rng.integers(-1, Tr, Tl), dev))


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,Q", [(1, 256, 32), (3, 515, 64), (2, 300, 416)])
def test_clockscan_matches_plain(cuda_device, C, T, Q):
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "seams", "identity"])
def test_fused_delta_matches_plain(cuda_device, case):
    """Mixed stages and joins in one launch, dirty rows on pane-tile
    seams, and the span == 0 / dn == 0 identity."""
    rng = np.random.default_rng(len(case))
    dev = cuda_device
    if case == "mixed":
        si = (_scan(rng, dev, 300, 2, 64, 1, 8, 5, 1),
              _scan(rng, dev, 256, 3, 96, 2, 16, 0, 0),
              _scan(rng, dev, 700, 1, 32, 1, 4, 4, 1))
        ji = (_join(rng, dev, 300, 128, 8, 3),
              _join(rng, dev, 256, 64, 8, 8, pseudo=True))
    elif case == "seams":
        si = (_scan(rng, dev, 300, 2, 64, 1, 8, 5, 1,
                    seam=(0, 255, 256, 299)),)
        ji = (_join(rng, dev, 300, 64, 4, 2),)
    else:
        si = (_scan(rng, dev, 128, 2, 64, 2, 8, 0, 0),)
        ji = (_join(rng, dev, 128, 32, 4, 0),)
    carry = si[0].carry.clone()
    want_w, want_r = tref.fused_delta_ref(si, ji)   # out of place
    got_w, got_r = tfd.fused_delta(si, ji)          # words merge in place
    for a, b in zip(got_w + got_r, want_w + want_r):
        assert torch.equal(a, b)
    if case == "identity":
        assert torch.equal(got_w[0], carry)
        assert torch.equal(got_r[0], ji[0].rid_carry)
