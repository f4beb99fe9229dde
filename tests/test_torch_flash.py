"""Port parity, flash attention: the plain version against the JAX
package's oracle, its model-side ``block_attention`` and (at one small
shape) the Pallas kernel in interpret mode; and the CUDA kernel's host
half on the CPU — tile geometry, the key-tile range of each query tile,
the kv-head map, the checks that raise, and the kernel's tile loop
(online softmax over the visited key tiles, -1e30 for masked scores,
-inf past Sk) replayed in torch against the plain version on ragged,
windowed and fully masked shapes.

Inputs are made with numpy from fixed seeds.  Tolerance: rtol 1e-5 and
atol 5e-5 in float32, 2e-2 / 1e-1 in bfloat16, as the reference's own
kernel test (tests/test_kernels.py) compares.
"""
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


def test_tile_geometry_and_kv_head_map():
    assert (fa.BLOCK_Q, fa.BLOCK_K) == (64, 64)
    assert [fa.q_tiles(s) for s in (1, 64, 65, 512, 2048)] == \
        [1, 1, 2, 8, 32]
    # the Pallas kv index map: bh = b * H + h -> b * KV + h // (H // KV)
    for H, KV in ((32, 4), (32, 16), (8, 8), (4, 1)):
        g = H // KV
        for bh in range(3 * H):
            b, h = divmod(bh, H)
            assert b * KV + fa.kv_head(h, H, KV) == (bh // H) * KV \
                + (bh % H) // g


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (512, 512, True, 0), (2048, 2048, True, 1024), (24, 24, True, 0),
    (200, 200, True, 0), (70, 150, True, 0), (150, 70, True, 0),
    (130, 40, True, 8), (77, 130, False, 20), (128, 256, False, 0),
    (300, 300, True, 64), (100, 100, True, 1), (1, 300, True, 0)])
def test_key_tile_range_covers_exactly_the_visible_keys(Sq, Sk, causal,
                                                        window):
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
    n_k = -(-Sk // fa.BLOCK_K)
    for qt in range(fa.q_tiles(Sq)):
        rows = ok[qt * fa.BLOCK_Q:(qt + 1) * fa.BLOCK_Q]
        lo, hi = fa.key_tile_range(qt, Sq, Sk, causal, window)
        assert 0 <= lo < hi <= n_k
        seen = rows.reshape(rows.shape[0], -1)
        tiles = {j for j in range(n_k)
                 if seen[:, j * fa.BLOCK_K:(j + 1) * fa.BLOCK_K].any()}
        if not seen.any(axis=1).all():
            assert (lo, hi) == (0, n_k)
        else:
            assert tiles <= set(range(lo, hi))
            assert set(range(lo, hi)) <= tiles


def _tile_loop(q, k, v, causal, window):
    """The kernel's algorithm in torch: per (batch x head, query tile),
    the online softmax over the key tiles of ``key_tile_range``, masked
    scores at -1e30 and keys past Sk at -inf, running max from -1e30."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = 1.0 / D ** 0.5
    out = torch.empty(B, Sq, H, D)
    for b in range(B):
        for h in range(H):
            kvh = fa.kv_head(h, H, KV)
            for qt in range(fa.q_tiles(Sq)):
                q0 = qt * fa.BLOCK_Q
                rows = torch.arange(q0, min(q0 + fa.BLOCK_Q, Sq))
                qt_ = q[b, rows, h].float()
                m = torch.full((len(rows),), -1e30)
                den = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), D)
                lo, hi = fa.key_tile_range(qt, Sq, Sk, causal, window)
                for j in range(lo, hi):
                    keys = torch.arange(j * fa.BLOCK_K, (j + 1) * fa.BLOCK_K)
                    real = keys < Sk
                    kk = torch.zeros(fa.BLOCK_K, D)
                    vv = torch.zeros(fa.BLOCK_K, D)
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
                    p = torch.exp(s - m_new[:, None])
                    corr = torch.exp(m - m_new)
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


def test_wrapper_checks_and_cpu_path():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 8, 4, 2, 16), np.float32))
    K.reset_launches()
    out = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert K.LAUNCHES["flash_attention"] == 0     # CPU: no launch
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
