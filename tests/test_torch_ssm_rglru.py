"""Port parity, recurrent and state-space layers: ``repro_torch.models.ssm``
and ``repro_torch.models.rglru``, and the ``ssm`` (mamba2-370m) and
``rec`` (recurrentgemma-2b) layer programs through prefill, decode and the
CycleServer, against the JAX package's, on the CPU at smoke size with
float32 parameters.

Inputs are made with numpy from fixed seeds.  Tolerances: the causal
conv within atol 1e-6 (the same multiply-adds in the same order); the
SSD scan, the RG-LRU scan and the blocks within atol 1e-5 of outputs of
unit scale (float32 products summed in another order: the port's
log-step scan pairs the steps otherwise than ``associative_scan``);
model logits and caches within atol 1e-4, as the dense models'
(tests/test_torch_lm.py).  A served stream's tokens are equal, its
logits agree within 1e-4, and at every step the reference's top-1 /
top-2 margin exceeds twice their largest difference, so equal tokens are
forced.  The reference server's slot cache is held at the dtypes its
``cache_struct`` declares (``_declared_dtypes``): at float32 parameters
its decode step hands back conv states in float32, which the port's
bfloat16 slot cache, written in place, does not hold.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import ref as jref
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.common import MeshAxes
from repro.serving import CycleServer as RefCycleServer
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.models import rglru, ssm, transformer
from repro_torch.models.registry import params_from_numpy
from repro_torch.serving import CycleServer

CPU = torch.device("cpu")
TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ("mamba2-370m", "recurrentgemma-2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke sizes gain nothing from intra-op threads; one thread keeps
    this module from oversubscribing the cores that parallel test workers
    share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32_params():
    """Per arch: (port cfg, ref cfg, ref float32 params, port params),
    one numpy tree drawn by the port's seeded init at the reference's
    scales (the reference's eager init costs seconds a model) and handed
    to both packages."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, rcfg = _cfg(arch)
            tree = _np(transformer.init_lm(torch.Generator().manual_seed(0),
                                           cfg, CPU, torch.float32))
            cache[arch] = (cfg, rcfg, jax.tree.map(jnp.asarray, tree),
                           params_from_numpy(tree, cfg, CPU))
        return cache[arch]
    return get


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _close(got, want, atol, what=""):
    for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cfg(arch):
    return configs.smoke_config(arch), ref_configs.smoke_config(arch)


# -------------------------------------------------------------- ssm pieces
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equals_the_reference(with_state):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    got = ssm._causal_conv(*_t((u, w, b)),
                           None if st is None else torch.from_numpy(st))
    want = jax.jit(ref_ssm._causal_conv)(
        *_j((u, w, b)), None if st is None else jnp.asarray(st))
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.concatenate([st if with_state else
                                                  np.zeros((2, 3, 12)), u],
                                                 axis=1)[:, -3:])


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("S,chunk,init", [(16, 8, False), (5, 8, False),
                                          (16, 4, True)])
def test_ssd_chunked_equals_the_reference_and_the_scan_oracle(S, chunk,
                                                              init):
    """S a multiple of the chunk, S under one chunk (Q = S), and an
    initial state; the port's naive per-step scan against the reference's
    and against the port's chunked scan."""
    rng = np.random.default_rng(S + chunk)
    args = _ssd_inputs(rng, 2, S, 3, 4, 5)
    st = rng.standard_normal((2, 3, 4, 5)).astype(np.float32) \
        if init else None
    got = ssm.ssd_chunked(*_t(args), chunk,
                          None if st is None else torch.from_numpy(st))
    want = jax.jit(ref_ssm.ssd_chunked, static_argnums=5)(
        *_j(args), chunk, None if st is None else jnp.asarray(st))
    _close(got, want, TOL, "ssd_chunked")
    naive = ref.ssd_scan_ref(*_t(args))
    _close(naive, jax.jit(jref.ssd_scan_ref)(*_j(args)), TOL,
           "ssd_scan_ref")
    if not init:
        _close(got, naive, TOL, "ssd_chunked vs the per-step oracle")


def _ssm_params(rng, cfg):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh, n, K = d_in // cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_kernel

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return {"w_in_zx": r(d, 2 * d_in, s=d ** -0.5),
            "w_in_bc": r(d, 2 * n, s=d ** -0.5),
            "w_in_dt": r(d, nh, s=d ** -0.5),
            "conv_w": r(K, d_in + 2 * n, s=0.5),
            "conv_b": r(d_in + 2 * n, s=0.1),
            "A_log": r(nh, s=0.5), "dt_bias": r(nh, s=0.5),
            "D": r(nh), "norm_scale": r(d_in, s=0.1),
            "w_out": r(d_in, d, s=d_in ** -0.5)}


def test_apply_ssm_train_and_decode_equal_the_reference():
    """A 13-step prefill padded to two chunks of 8 (the pads carry dt =
    0, so the final state is the unpadded one's), then two decode steps
    from its states."""
    cfg, rcfg = _cfg("mamba2-370m")
    rng = np.random.default_rng(2)
    p = _ssm_params(rng, cfg)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    train = jax.jit(lambda p, x: ref_ssm.apply_ssm(p, x, rcfg, MeshAxes()))
    decode = jax.jit(lambda p, x, c, s: ref_ssm.apply_ssm(
        p, x, rcfg, MeshAxes(), conv_state=c, ssd_state=s, decode=True))
    got, (gc, gs) = ssm.apply_ssm(_t(p), torch.from_numpy(x), cfg)
    want, (wc, ws) = train(_j(p), jnp.asarray(x))
    _close((got, gc, gs), (want, wc, ws), TOL, "train")
    for step in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        got, (gc, gs) = ssm.apply_ssm(_t(p), torch.from_numpy(x1), cfg,
                                      conv_state=gc, ssd_state=gs,
                                      decode=True)
        want, (wc, ws) = decode(_j(p), jnp.asarray(x1), wc, ws)
        _close((got, gc, gs), (want, wc, ws), TOL, f"decode {step}")


# ------------------------------------------------------------ rglru pieces
@pytest.mark.parametrize("S", [1, 7, 64])
def test_lru_scan_equals_the_reference(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    u = rng.standard_normal((2, S, 8)).astype(np.float32)
    got = rglru._lru_scan(*_t((a, u)))
    want = jax.jit(ref_rglru._lru_scan)(*_j((a, u)))
    _close(got, want, TOL)
    h, seq = np.zeros((2, 8), np.float32), []
    for t in range(S):                  # the recurrence itself, step by step
        h = a[:, t] * h + u[:, t]
        seq.append(h)
    _close(got, np.stack(seq, axis=1), TOL)


def _rglru_params(rng, cfg):
    d, K = cfg.d_model, cfg.conv_kernel
    nb = rglru._N_BLOCKS if d % rglru._N_BLOCKS == 0 else 1
    c = d // nb

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return {"w_x": r(d, d, s=d ** -0.5), "w_gate": r(d, d, s=d ** -0.5),
            "conv_w": r(K, d, s=0.5), "conv_b": r(d, s=0.1),
            "w_a_gate": r(nb, c, c, s=0.3), "b_a_gate": r(d, s=0.1),
            "w_i_gate": r(nb, c, c, s=0.3), "b_i_gate": r(d, s=0.1),
            "lam": r(d), "w_out": r(d, d, s=d ** -0.5)}


def test_apply_rglru_train_and_decode_equal_the_reference():
    """Prefill from no state and from a given state, then two decode
    steps; the gate's gelu is the tanh form, as jax.nn.gelu's default."""
    cfg, rcfg = _cfg("recurrentgemma-2b")
    rng = np.random.default_rng(3)
    p = _rglru_params(rng, cfg)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    train = jax.jit(lambda p, x, h: ref_rglru.apply_rglru(
        p, x, rcfg, MeshAxes(), h_state=h))
    decode = jax.jit(lambda p, x, c, h: ref_rglru.apply_rglru(
        p, x, rcfg, MeshAxes(), conv_state=c, h_state=h, decode=True))
    for h in (None, h0):
        got = rglru.apply_rglru(_t(p), torch.from_numpy(x), cfg,
                                h_state=None if h is None
                                else torch.from_numpy(h))
        want = train(_j(p), jnp.asarray(x),
                     None if h is None else jnp.asarray(h))
        _close(got, want, TOL, f"train, h_state {h is not None}")
    _, (gc, gh) = got
    _, (wc, wh) = want
    for step in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        got, (gc, gh) = rglru.apply_rglru(_t(p), torch.from_numpy(x1), cfg,
                                          conv_state=gc, h_state=gh,
                                          decode=True)
        want, (wc, wh) = decode(_j(p), jnp.asarray(x1), wc, wh)
        _close((got, gc, gh), (want, wc, wh), TOL, f"decode {step}")


# ------------------------------------------------------------- the models
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(f32_params, arch):
    """Prefill (logits at a last position before the end, the cache's
    conv and recurrent states), then two decode steps on that cache."""
    cfg, rcfg, rp, tp = f32_params(arch)
    rng = np.random.default_rng(7)
    B, S, cap = 2, 12, 20
    toks = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    want_l, want_c = jax.jit(functools.partial(
        ref_tf.prefill, cfg=rcfg, cache_capacity=cap, last_pos=9))(
            rp, {"tokens": jnp.asarray(toks)})
    got_l, got_c = transformer.prefill(
        tp, {"tokens": torch.from_numpy(toks)}, cfg, cache_capacity=cap,
        last_pos=9)
    assert jax.tree.structure(_np(got_c)) == \
        jax.tree.structure(_np(want_c))
    _close((got_l, got_c), (want_l, want_c), LOGIT_TOL, "prefill")
    pos = np.full(B, S, np.int32)
    ref_decode = jax.jit(functools.partial(ref_tf.decode_step, cfg=rcfg))
    for step in range(2):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        want_l, want_c = ref_decode(rp, want_c, jnp.asarray(tok),
                                    jnp.asarray(pos))
        got_l, same = transformer.decode_step(
            tp, got_c, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        assert same is got_c            # the states are written in place
        _close((got_l, got_c), (want_l, want_c), LOGIT_TOL,
               f"decode {step}")
        pos = pos + 1


class _Steps:
    """A server's logits at every prefill and every decode step (rows of
    the slots active in that step), in order."""

    def __init__(self, srv):
        self.logits = []
        prefill, decode = srv._prefill, srv._decode

        def rec_prefill(*a):
            out = prefill(*a)
            self.logits.append(_np(out[0]))
            return out

        def rec_decode(p, c, t, pos):
            out = decode(p, c, t, pos)
            live = [s is not None for s in srv._slots]
            self.logits.append(_np(out[0])[live])
            return out
        srv._prefill, srv._decode = rec_prefill, rec_decode


def _declared_dtypes(srv):
    """Keeps the reference server's slot cache at the dtypes its
    ``cache_struct`` declares (conv states bfloat16): at float32
    parameters its jitted decode step returns the conv states in
    float32, and the next step would read them unrounded, where the
    port's slot cache, written in place, keeps the declared bfloat16."""
    decode = srv._decode

    def step(p, cache, tokens, positions):
        dtypes = jax.tree.map(lambda x: x.dtype, cache)
        logits, cache = decode(p, cache, tokens, positions)
        return logits, jax.tree.map(lambda x, dt: x.astype(dt), cache,
                                    dtypes)
    srv._decode = step


def assert_streams_equal(cfg, rcfg, rp, tp):
    """One CycleServer stream of the port and of the reference on the
    same float32 weights: equal tokens, ids, slots and beats; every
    step's logits within LOGIT_TOL, and the reference's top-1 / top-2
    margin above twice their largest difference (equal tokens forced)."""
    kw = dict(capacity=2, max_seq=24, prefill_len=8)
    want = RefCycleServer(rcfg, params=rp, **kw)
    _declared_dtypes(want)
    got = CycleServer(cfg, params=tp, device="cpu", **kw)
    steps_w, steps_g = _Steps(want), _Steps(got)
    for s in (want, got):
        for prompt in ([5, 17, 3], list(range(1, 11)), [9, 9]):
            s.submit(prompt, 4)
    done_w, done_g = want.run_until_drained(), got.run_until_drained()
    assert [r.id for r in done_g] == [r.id for r in done_w]
    for a, b in zip(done_g, done_w):
        assert (a.output, a.slot, a.truncated) == \
            (b.output, b.slot, b.truncated)
    assert got.last_drain_admitted == want.last_drain_admitted
    assert got.last_drain_active == want.last_drain_active
    assert len(steps_g.logits) == len(steps_w.logits) > 0
    for i, (g, w) in enumerate(zip(steps_g.logits, steps_w.logits)):
        diff = float(np.abs(g - w).max()) if w.size else 0.0
        assert diff <= LOGIT_TOL, (i, diff)
        if w.size:
            top = np.sort(w.astype(np.float64), axis=-1)
            assert (top[:, -1] - top[:, -2]).min() > 2 * diff, (i, diff)


@pytest.mark.parametrize("arch", ARCHS)
def test_cycle_server_stream_equals_the_reference(f32_params, arch):
    cfg, rcfg, rp, tp = f32_params(arch)
    assert_streams_equal(cfg, rcfg, rp, tp)
    srv = CycleServer(cfg, capacity=1, max_seq=8, prefill_len=4,
                      params=tp, device="cpu")
    for entry in srv.cache.values():   # the warm-up step left no state
        for t in entry.values():
            assert (t == -1).all() if t.dtype == torch.int32 \
                else not t.any()
    assert {f for e in srv.cache.values() for f in e} == (
        {"conv", "state"} if arch == "mamba2-370m"
        else {"conv", "h", "k", "v", "pos"})
