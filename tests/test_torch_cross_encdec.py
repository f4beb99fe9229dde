"""Port parity, cross-attention and encoder-decoder programs: the ``cross``
(llama-3.2-vision-90b) and encoder-decoder (whisper-small) layer programs
through prefill, decode and the CycleServer, non-causal ``block_attention``
with Sq != Sk, and the decode cache and parameter trees of the four
programs ported with them (with mamba2-370m and recurrentgemma-2b),
against the JAX package's, on the CPU at smoke size with float32
parameters.

Inputs are made with numpy from fixed seeds; the prefills see random
``frames`` / ``vision`` tokens, so the cross sublayers attend to a
context that is not constant.  Tolerances: attention within atol 1e-5
(float32, another summation order); model logits and caches within atol
1e-4, as the dense models' (tests/test_torch_lm.py); served streams as in
tests/test_torch_ssm_rglru.py (equal tokens, logits within 1e-4, each
step's top-1 / top-2 margin above twice their difference).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.models import common, transformer
from repro_torch.models.registry import get_model, params_from_numpy
from test_torch_ssm_rglru import (LOGIT_TOL, _close, _np,
                                  assert_streams_equal)

CPU = torch.device("cpu")
ARCHS = ("llama-3.2-vision-90b", "whisper-small")
ALL_FOUR = ARCHS + ("mamba2-370m", "recurrentgemma-2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module (see test_torch_moe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32_params():
    """Per arch: (port cfg, ref cfg, ref float32 params, port params),
    one numpy tree from the port's seeded init handed to both."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, rcfg = configs.smoke_config(arch), \
                ref_configs.smoke_config(arch)
            tree = _np(transformer.init_lm(torch.Generator().manual_seed(0),
                                           cfg, CPU, torch.float32))
            cache[arch] = (cfg, rcfg, jax.tree.map(jnp.asarray, tree),
                           params_from_numpy(tree, cfg, CPU))
        return cache[arch]
    return get


def _ctx_batch(cfg, rng, B, S):
    """The prefill's context inputs: random frame embeddings (enc-dec,
    S * dec_ratio of them) or vision tokens (cross)."""
    if cfg.enc_dec:
        return {"frames": rng.standard_normal(
            (B, S * cfg.dec_ratio, cfg.d_model)).astype(np.float32)}
    return {"vision": rng.standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("kernels", ["hopper", "torch"])
def test_block_attention_not_causal_with_sq_ne_sk(kernels):
    """A cross call (12 queries over 40 keys, 4 heads over 2) and an
    encoder call (Sq = Sk), neither causal: every key seen, whatever
    q_offset says."""
    rng = np.random.default_rng(4)
    for Sq, Sk in ((12, 40), (24, 24)):
        q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
        want = jax.jit(functools.partial(ref_common.block_attention,
                                         causal=False))(q, k, v)
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        for off in (0, Sk - Sq):
            got = common.block_attention(tq, tk, tv, causal=False,
                                         q_offset=off, kernels=kernels)
            _close(got, want, 1e-5, f"{Sq} x {Sk}, q_offset {off}")
        _close(ref.flash_attention_ref(tq, tk, tv, causal=False), want,
               1e-5)
    with pytest.raises(ValueError, match="q_offset"):
        common.block_attention(tq[:, :4], tk, tv, causal=False, window=8,
                               q_offset=0, kernels=kernels)


@pytest.mark.parametrize("arch", ALL_FOUR)
def test_cache_struct_equals_the_reference(arch):
    """Shapes and dtypes of every cache entry, at smoke size and at the
    published widths (analytic: nothing allocated), at the context length
    that the model API's ctx_len gives (equal to the reference's, as is
    dec_len)."""
    for cfg, rcfg in ((configs.smoke_config(arch),
                       ref_configs.smoke_config(arch)),
                      (configs.get_config(arch),
                       ref_configs.get_config(arch))):
        api, rapi = get_model(cfg, device=CPU), ref_registry.get_model(rcfg)
        for seq in (96, 1536):
            assert api.ctx_len(seq) == rapi.ctx_len(seq)
            assert api.dec_len(seq) == rapi.dec_len(seq)
        ctx = api.ctx_len(96)
        got = transformer.cache_struct(cfg, 3, 40, ctx_len=ctx)
        want, _ = ref_tf.cache_struct(rcfg, 3, 40, ctx_len=ctx)
        assert set(got) == set(want)
        for key, entry in want.items():
            assert set(got[key]) == set(entry), key
            for f, sd in entry.items():
                shape, dt = got[key][f]
                assert shape == sd.shape, (key, f)
                assert str(dt).replace("torch.", "") == str(sd.dtype)
    cache = get_model(configs.smoke_config(arch), device=CPU).init_cache(
        2, 16, ctx_len=8)
    assert all((t == -1).all() if t.dtype == torch.int32 else not t.any()
               for e in cache.values() for t in e.values())


@pytest.mark.parametrize("arch", ALL_FOUR)
def test_params_from_numpy_round_trip(arch):
    """The reference's parameter tree (its shapes, numpy values) comes
    across exactly, bfloat16 leaves too; the port's own init makes the
    same tree, with A_log, dt_bias, D and lam in float32 under bfloat16
    parameters; a tree missing a leaf is refused."""
    cfg, rcfg = configs.smoke_config(arch), ref_configs.smoke_config(arch)
    shapes = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda sd: rng.standard_normal(sd.shape).astype(
        np.float32), shapes)
    back = _np(params_from_numpy(tree, cfg, CPU))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    tb = params_from_numpy(bf, cfg, CPU)
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  bf["embed"].astype(np.float32))
    own = transformer.init_lm(torch.Generator().manual_seed(1), cfg, CPU)
    assert jax.tree.structure(_np(own)) == jax.tree.structure(tree)
    for (path, a), sd in zip(jax.tree_util.tree_leaves_with_path(own),
                             jax.tree.leaves(shapes)):
        assert tuple(a.shape) == sd.shape, path
        f32 = str(path[-1].key) in ("A_log", "dt_bias", "D", "lam")
        assert a.dtype == (torch.float32 if f32 else torch.bfloat16), path
    bad = dict(tree)
    bad.pop({"whisper-small": "enc_final_norm",
             "llama-3.2-vision-90b": "w_vision_proj"}.get(arch, "g0"))
    with pytest.raises(ValueError, match="root"):
        params_from_numpy(bad, cfg, CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(f32_params, arch):
    """Prefill on random frames / vision tokens (logits at a last
    position before the end; the self-attention ring, the cross K/V),
    then two decode steps on that cache."""
    cfg, rcfg, rp, tp = f32_params(arch)
    rng = np.random.default_rng(8)
    B, S, cap = 2, 12, 20
    batch = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
             **_ctx_batch(cfg, rng, B, S)}
    want_l, want_c = jax.jit(functools.partial(
        ref_tf.prefill, cfg=rcfg, cache_capacity=cap, last_pos=9))(
            rp, jax.tree.map(jnp.asarray, batch))
    got_l, got_c = transformer.prefill(
        tp, jax.tree.map(torch.from_numpy, batch), cfg, cache_capacity=cap,
        last_pos=9)
    assert jax.tree.structure(_np(got_c)) == \
        jax.tree.structure(_np(want_c))
    _close((got_l, got_c), (want_l, want_c), LOGIT_TOL, "prefill")
    ctx = next(iter(_ctx_batch(cfg, rng, B, S).values())).shape[1]
    assert got_c["g1"]["k"].shape[2] == ctx       # [attn, cross] x n
    pos = np.full(B, S, np.int32)
    ref_decode = jax.jit(functools.partial(ref_tf.decode_step, cfg=rcfg))
    for step in range(2):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        want_l, want_c = ref_decode(rp, want_c, jnp.asarray(tok),
                                    jnp.asarray(pos))
        got_l, _ = transformer.decode_step(
            tp, got_c, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        _close((got_l, got_c), (want_l, want_c), LOGIT_TOL,
               f"decode {step}")
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cycle_server_stream_equals_the_reference(f32_params, arch):
    """The servers feed zero frames / vision tokens, as the
    reference's does: prefill_len 8 hears 64 frames (whisper)."""
    cfg, rcfg, rp, tp = f32_params(arch)
    assert_streams_equal(cfg, rcfg, rp, tp)
