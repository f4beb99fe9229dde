"""Port parity, flash attention: the plain version against the JAX
package's oracle, its model-side ``block_attention`` and (at one small
shape) the Pallas kernel in interpret mode; and the CUDA kernels' host
half on the CPU — the route rule (dtype x head dim -> kernel), each
route's tile geometry and key-tile range of each query tile, the kv-head
map, the checks that raise, and each kernel's tile loop (online softmax
over the visited key tiles, -1e30 for masked scores, -inf past Sk)
replayed in torch against the plain version on ragged, windowed and
fully masked shapes: the CUDA-core kernel's in float32, the tensor-core
kernel's in bfloat16 with P rounded to bfloat16 where that kernel rounds
it, and ``chip_smoke.py``'s per-row gate shown to pass that replay and
to catch a key tile left out.

Inputs are made with numpy from fixed seeds.  Tolerance: rtol 1e-5 and
atol 5e-5 in float32, 2e-2 / 1e-1 in bfloat16, as the reference's own
kernel test (tests/test_kernels.py) compares.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.common import block_attention as jax_block_attention
from repro_torch import kernels as K
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models.common import block_attention

# tests/test_kernels.py's flash-attention shapes
SHAPES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (2, 256, 256, 8, 4, 32, True, 64),
    (1, 128, 256, 4, 1, 128, False, 0),   # cross-attention-like
    (2, 128, 128, 4, 4, 64, True, 32),
]
# ragged S, Sq < Sk, Sq > Sk (causal: rows that see no key), D 16 / 128
EDGE = [
    (1, 24, 24, 4, 2, 16, True, 0),
    (1, 200, 200, 4, 2, 128, True, 0),
    (2, 70, 150, 4, 2, 32, True, 0),
    (1, 150, 70, 2, 1, 64, True, 0),
    (1, 130, 40, 2, 2, 16, True, 8),
    (1, 77, 130, 2, 1, 32, False, 20),
    (1, 100, 100, 4, 4, 16, True, 1),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(shape, dtype, seed=0):
    B, Sq, Sk, H, KV, D = shape[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]


def _close(got, want, f32=True):
    tol = 1e-5 if f32 else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_equals_the_reference(shape, dtype):
    causal, window = shape[6], shape[7]
    arrays = _qkv(shape, jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    want = jref.flash_attention_ref(*map(jnp.asarray, arrays), causal=causal,
                                    window=window)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)) for a in arrays)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    _close(got.float().numpy(), want, dtype == "float32")
    if dtype == "float32":
        # the model side: the JAX block_attention and the port's (through
        # the hopper wrapper, which on CPU tensors is the plain version)
        Sq, Sk = shape[1], shape[2]
        jb = jax_block_attention(*map(jnp.asarray, arrays), causal=causal,
                                 window=window, q_offset=Sk - Sq)
        _close(got.numpy(), jb)
        for kernels in ("hopper", "torch"):
            tb = block_attention(tq, tk, tv, causal=causal, window=window,
                                 q_offset=Sk - Sq, kernels=kernels)
            _close(tb.numpy(), jb)


def test_plain_version_equals_the_pallas_kernel():
    """One small shape through the TPU kernel in interpret mode (the
    reference's own tests cover the rest of its shapes)."""
    arrays = _qkv((1, 128, 128, 4, 2, 32), np.float32, seed=3)
    want = flash_attention_pallas(*map(jnp.asarray, arrays), causal=True,
                                  window=48)
    got = ref.flash_attention_ref(*map(torch.from_numpy, arrays),
                                  causal=True, window=48)
    _close(got.numpy(), want)


def test_route_rule():
    """bfloat16 at D 64 / 128 / 256 takes the tensor-core kernel (at D
    256 on 64-query tiles); float32 at every D and bfloat16 at D 16 / 32
    the CUDA-core kernel."""
    assert fa.HEAD_DIMS == (16, 32, 64, 128, 256)
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for D in fa.HEAD_DIMS:
            want = "wgmma" if dtype == torch.bfloat16 \
                and D in (64, 128, 256) else "simt"
            assert fa.route(dtype, D) == want, (dtype, D)
            assert fa.tiles(want, D) == ((64, 64) if want == "simt" or
                                         D == 256 else (128, 64))
    assert fa.TILES == {"simt": (64, 64), "wgmma": (128, 64)}


@pytest.mark.parametrize("kind", ["simt", "wgmma"])
def test_tile_geometry_and_kv_head_map(kind):
    bq = fa.TILES[kind][0]
    assert fa.TILES["simt"] == (64, 64)
    assert [fa.q_tiles(s, 64) for s in (1, 64, 65, 512, 2048)] == \
        [1, 1, 2, 8, 32]
    assert [fa.q_tiles(s, bq) for s in (1, 64, 65, 129, 512, 2048)] == \
        {"simt": [1, 1, 2, 3, 8, 32], "wgmma": [1, 1, 1, 2, 4, 16]}[kind]
    # the Pallas kv index map: bh = b * H + h -> b * KV + h // (H // KV)
    for H, KV in ((32, 4), (32, 16), (8, 8), (4, 1)):
        g = H // KV
        for bh in range(3 * H):
            b, h = divmod(bh, H)
            assert b * KV + fa.kv_head(h, H, KV) == (bh // H) * KV \
                + (bh % H) // g


@pytest.mark.parametrize("kind", ["simt", "wgmma"])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (512, 512, True, 0), (2048, 2048, True, 1024), (24, 24, True, 0),
    (200, 200, True, 0), (70, 150, True, 0), (150, 70, True, 0),
    (130, 40, True, 8), (77, 130, False, 20), (128, 256, False, 0),
    (300, 300, True, 64), (100, 100, True, 1), (1, 300, True, 0),
    (512, 512, True, 2048), (1536, 1536, False, 0), (192, 1536, False, 0),
    (512, 6404, False, 0)])
def test_key_tile_range_covers_exactly_the_visible_keys(Sq, Sk, causal,
                                                        window, kind):
    """Every key a row of the query tile may see lies in a visited tile;
    a visited tile holds a visible key unless the query tile holds a row
    that sees none (then every tile is visited, for its uniform average)."""
    qpos = np.arange(Sq)[:, None] + (Sk - Sq)
    kpos = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= qpos - kpos < window
    bq, bk = fa.TILES[kind]
    n_k = -(-Sk // bk)
    if not causal and not window:      # an encoder's or a cross call's
        assert {fa.key_tile_range(qt, Sq, Sk, causal, window, bq, bk)
                for qt in range(fa.q_tiles(Sq, bq))} == {(0, n_k)}
    for qt in range(fa.q_tiles(Sq, bq)):
        rows = ok[qt * bq:(qt + 1) * bq]
        lo, hi = fa.key_tile_range(qt, Sq, Sk, causal, window, bq, bk)
        assert 0 <= lo < hi <= n_k
        seen = rows.reshape(rows.shape[0], -1)
        tiles = {j for j in range(n_k)
                 if seen[:, j * bk:(j + 1) * bk].any()}
        if not seen.any(axis=1).all():
            assert (lo, hi) == (0, n_k)
        else:
            assert tiles <= set(range(lo, hi))
            assert set(range(lo, hi)) <= tiles


LOG2E = 1.4426950408889634          # kLog2e in csrc/flash_attention.cu


def _tile_loop(q, k, v, causal, window, kind="simt", skip=None):
    """A kernel's algorithm in torch: per (batch x head, query tile), the
    online softmax over the key tiles of ``key_tile_range`` with the
    route's ``tiles``, masked scores at -1e30 and keys past Sk at -inf,
    running max from -1e30.  ``kind="wgmma"``, the tensor-core kernel:
    query tiles in its launch order (last first), scores in the log2
    domain (scale folded into log2 e, exp2), P rounded to bfloat16
    before P.V and the row sum taken over the rounded values, as that
    kernel sums them.  ``skip`` = (head, query tile, key tile): a planted
    fault, that key tile left out of that query tile's loop."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    bq, bk = fa.tiles(kind, D)
    tensor_cores = kind == "wgmma"
    if tensor_cores:
        scale = torch.tensor(LOG2E) / torch.tensor(float(D)).sqrt()
        exp = torch.exp2
    else:
        scale, exp = 1.0 / D ** 0.5, torch.exp
    out = torch.empty(B, Sq, H, D)
    order = range(fa.q_tiles(Sq, bq))
    for b in range(B):
        for h in range(H):
            kvh = fa.kv_head(h, H, KV)
            for qt in (reversed(order) if tensor_cores else order):
                q0 = qt * bq
                rows = torch.arange(q0, min(q0 + bq, Sq))
                qt_ = q[b, rows, h].float()
                m = torch.full((len(rows),), -1e30)
                den = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), D)
                lo, hi = fa.key_tile_range(qt, Sq, Sk, causal, window, bq, bk)
                for j in range(lo, hi):
                    if skip == (h, qt, j):
                        continue
                    keys = torch.arange(j * bk, (j + 1) * bk)
                    real = keys < Sk
                    kk = torch.zeros(bk, D)
                    vv = torch.zeros(bk, D)
                    kk[real] = k[b, keys[real], kvh].float()
                    vv[real] = v[b, keys[real], kvh].float()
                    s = (qt_ @ kk.T) * scale
                    qpos = rows[:, None] + (Sk - Sq)
                    ok = torch.ones_like(s, dtype=torch.bool)
                    if causal:
                        ok &= qpos >= keys[None]
                    if window > 0:
                        ok &= qpos - keys[None] < window
                    s = torch.where(ok, s, torch.tensor(-1e30))
                    s = torch.where(real[None], s, torch.tensor(-np.inf))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    p = exp(s - m_new[:, None])
                    if tensor_cores:
                        p = p.bfloat16().float()
                    corr = exp(m - m_new)
                    den = den * corr + p.sum(dim=1)
                    acc = acc * corr[:, None] + p @ vv
                    m = m_new
                out[b, rows, h] = acc / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("shape", EDGE + SHAPES[:1])
def test_kernel_tile_loop_equals_the_plain_version(shape):
    causal, window = shape[6], shape[7]
    q, k, v = map(torch.from_numpy, _qkv(shape, np.float32, seed=5))
    got = _tile_loop(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.isfinite(got).all()
    _close(got.numpy(), want.numpy())
    Sq, Sk = shape[1], shape[2]
    if causal and Sq > Sk:   # rows that see no key average all of v
        dead = Sq - Sk
        uniform = v.float().repeat_interleave(shape[3] // shape[4],
                                              dim=2).mean(dim=1)
        _close(got[:, :dead].numpy(),
               uniform[:, None].expand(-1, dead, -1, -1).numpy())


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1, 512, 512, 4, 2, 128, True, 0),
                                   (1, 1024, 1024, 2, 1, 128, True, 256)])
def test_row_relative_gate_separates_roundoff_from_a_dropped_key_tile(
        shape):
    """chip_smoke.py holds the tensor-core kernel at the LM paths' shapes
    on standard-normal inputs to FLASH_ROW_REL_TOL of each output row's
    norm: its tile loop replayed in torch (bf16 P) stays under a quarter
    of that, and the same loop with one key tile of one query tile left
    out goes over ten times it."""
    cs = _chip_smoke()
    causal, window = shape[6], shape[7]
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(shape, np.float32, seed=9))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = _tile_loop(q, k, v, causal, window, kind="wgmma")
    assert float(cs.row_rel_err(got, want).max()) < cs.FLASH_ROW_REL_TOL / 4
    qt = fa.q_tiles(shape[1], fa.TILES["wgmma"][0]) - 1
    lo, hi = fa.key_tile_range(qt, shape[1], shape[2], causal, window,
                               *fa.TILES["wgmma"])
    bad = _tile_loop(q, k, v, causal, window, kind="wgmma",
                     skip=(1, qt, (lo + hi) // 2))
    assert float(cs.row_rel_err(bad, want).max()) > 10 * cs.FLASH_ROW_REL_TOL


def test_wrapper_checks_and_cpu_path():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 8, 4, 2, 16), np.float32))
    K.reset_launches()
    out = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert K.LAUNCHES["flash_attention"] == 0     # CPU: no launch
    out = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    assert K.LAUNCHES["flash_attention"] == 0
    assert K.FLASH_ROUTE_LAUNCHES == {"wgmma": 0, "simt": 0}
    bad = [
        ((q[0], k, v), "B,Sq,H,D"),
        ((q, k, v[:, :4]), "B,Sq,H,D"),
        ((q, k[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
          v[:, :, :1].expand(-1, -1, 3, -1).contiguous()), "divide"),
        ((q[..., :8].contiguous(), k[..., :8].contiguous(),
          v[..., :8].contiguous()), "head dim"),
        ((torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
          torch.zeros(1, 8, 2, 48)), "head dim"),
        ((q.half(), k.half(), v.half()), "bfloat16 or float32"),
        ((q, k.bfloat16(), v.bfloat16()), "bfloat16 or float32"),
        ((q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
         "contiguous"),
        ((q[:, :0], k, v), "empty"),
    ]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            fa.flash_attention(*args)
    with pytest.raises(ValueError, match="kernels"):
        block_attention(q, k, v, causal=True, kernels="pallas")



@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("shape", EDGE + SHAPES[:1]
                         + [(2, 256, 256, 8, 4, 64, True, 64),
                            (1, 48, 200, 4, 2, 64, False, 0)])
def test_wgmma_tile_loop_equals_the_plain_version(shape, D):
    """The tensor-core route's replay at bfloat16 tolerance (2e-2 / 1e-1)
    on the ragged, Sq < Sk, Sq > Sk, window and non-causal Sq != Sk (a
    cross call's) shapes, at its head dims (64-query tiles at D 256)."""
    shape = shape[:5] + (D,) + shape[6:]
    causal, window = shape[6], shape[7]
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(shape, np.float32, seed=7))
    assert fa.route(q.dtype, D) == "wgmma"
    got = _tile_loop(q, k, v, causal, window, "wgmma")
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _close(got.float().numpy(), want.float().numpy(), f32=False)
    Sq, Sk = shape[1], shape[2]
    if causal and Sq > Sk:   # rows that see no key average all of v
        dead = Sq - Sk
        uniform = v.float().repeat_interleave(shape[3] // shape[4],
                                              dim=2).mean(dim=1)
        _close(got[:, :dead].float().numpy(),
               uniform[:, None].expand(-1, dead, -1, -1).numpy(), f32=False)


def test_check_args_route_and_cpu_path_at_head_dim_256():
    """Head dim 256 (recurrentgemma-2b's) passes the checks in bfloat16
    and float32 and takes the tensor-core route on 64-query tiles in
    bfloat16; 192 and 512 are refused; on CPU tensors the wrapper is the
    plain version, causal and windowed or not causal with Sq != Sk."""
    for D in (192, 512):
        with pytest.raises(ValueError, match="head dim"):
            fa.check_args(torch.zeros(1, 4, 2, D), torch.zeros(1, 4, 1, D),
                          torch.zeros(1, 4, 1, D))
    assert fa.route(torch.bfloat16, 256) == "wgmma"
    assert fa.route(torch.float32, 256) == "simt"
    assert fa.tiles("wgmma", 256) == (64, 64)
    assert fa.q_tiles(512, fa.tiles("wgmma", 256)[0]) == 8
    for shape in ((1, 40, 40, 4, 1, 256, True, 16),
                  (1, 24, 70, 4, 2, 256, False, 0)):
        causal, window = shape[6], shape[7]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.from_numpy(a).to(dtype)
                       for a in _qkv(shape, np.float32, seed=11))
            fa.check_args(q, k, v)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            assert torch.equal(got, want)
