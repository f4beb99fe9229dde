"""Port parity, MoE: ``repro_torch.models.moe`` and the ``moe`` layer
programs against the JAX package's, on the CPU at smoke size with
float32 parameters.

Inputs are made with numpy from fixed seeds.  Tolerances: the MoE
block's output within atol 1e-5 (float32 expert matmuls summed in
another order; routing, capacity and drops equal), its aux loss within
rtol 1e-6; the fixed-order combine bit-equal to the reference's
scatter-add in float32 and bfloat16; model logits and caches within
atol 1e-4, as the dense models' (tests/test_torch_lm.py).  Routing is
held equal wherever the reference's k-th / (k+1)-th router probability
margin exceeds twice the largest router-logit difference between the
two packages (a logit moved by d moves a probability ratio by at most
e^(2d)), so an equal route is forced there, not luck.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.models.common import MeshAxes
from repro.serving import CycleServer as RefCycleServer
from repro_torch import configs
from repro_torch.configs import MoEConfig
from repro_torch.models import moe, transformer
from repro_torch.models.registry import params_from_numpy
from repro_torch.serving import CycleServer

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4
MOE_TOL = 1e-5
ARCHS = ("mixtral-8x22b", "qwen2-moe-a2.7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke sizes gain nothing from intra-op threads; one thread keeps
    this module from oversubscribing the cores that parallel test workers
    share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_params(rng, D, E, F, shared, skew=0.0):
    """float32 MoE block parameters; ``skew`` adds to expert 0's router
    column so that, on inputs of positive mean, it draws more tokens than
    its capacity."""
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "we_gate": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
         "we_up": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
         "we_down": rng.standard_normal((E, F, D)).astype(np.float32) / 4}
    p["router"][:, 0] += skew
    if shared:
        p["shared"] = {
            "w_gate": rng.standard_normal((D, shared)).astype(np.float32) / 4,
            "w_up": rng.standard_normal((D, shared)).astype(np.float32) / 4,
            "w_down": rng.standard_normal((shared, D)).astype(np.float32) / 4}
    return p


def _cfgs(E, k, F, shared):
    kw = dict(num_experts=E, top_k=k, num_shared=shared, d_ff_expert=F)
    return MoEConfig(**kw), ref_configs.MoEConfig(**kw)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


# ------------------------------------------------------------- the block
@pytest.mark.parametrize("dispatch", moe.DISPATCHES)
def test_apply_moe_equals_the_reference_with_drops(dispatch):
    rng = np.random.default_rng(3)
    E, k, D, F = 6, 2, 16, 12
    cfg, rcfg = _cfgs(E, k, F, 1)
    p = _moe_params(rng, D, E, F, F, skew=0.15)
    x = rng.standard_normal((2, 40, D)).astype(np.float32) + 1.0
    want_y, want_aux = ref_moe.apply_moe(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg, "swiglu",
        MeshAxes(), dispatch=dispatch)
    got_y, got_aux = moe.apply_moe(_torch(p), torch.from_numpy(x), cfg,
                                   "swiglu", dispatch=dispatch)
    # the skewed router overfills expert 0: some assignments are dropped
    _, top_e = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, D)) @ p["router"]), k)
    C = ref_moe.moe_capacity(80, rcfg)
    assert moe.moe_capacity(80, cfg) == C
    assert np.bincount(np.asarray(top_e).ravel(), minlength=E).max() > C
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=MOE_TOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_sharded_dispatch_is_the_sort_dispatch_on_one_device():
    rng = np.random.default_rng(4)
    cfg, _ = _cfgs(8, 3, 10, 0)
    p = _torch(_moe_params(rng, 12, 8, 10, 0, skew=0.5))
    x = torch.from_numpy(rng.standard_normal((1, 64, 12)).astype(np.float32))
    a = moe.apply_moe(p, x, cfg, "swiglu", dispatch="sort")
    b = moe.apply_moe(p, x, cfg, "swiglu", dispatch="sharded")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="dispatch"):
        moe.apply_moe(p, x, cfg, "swiglu", dispatch="einsum")


def test_top_k_ties_take_the_lower_expert_index():
    """Experts 1, 3 and 4 share one router column, so every token's
    probabilities tie exactly among them; the reference's lax.top_k puts
    the lower index first, and so must the port's route."""
    rng = np.random.default_rng(5)
    D, E, k = 8, 6, 2
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 3] = router[:, 4] = router[:, 1]
    router[:, 1] += 3.0                # the tied experts lead, by far
    router[:, 3] += 3.0
    router[:, 4] += 3.0
    x = np.abs(rng.standard_normal((32, D)).astype(np.float32)) + 0.1
    cfg, _ = _cfgs(E, k, 4, 0)
    probs, top_w, top_e = moe.route({"router": torch.from_numpy(router)},
                                    torch.from_numpy(x), cfg)
    rp = jax.nn.softmax(jnp.asarray(x) @ router, axis=-1)
    rw, re = jax.lax.top_k(rp, k)
    assert np.array_equal(np.asarray(probs[:, 1]), np.asarray(probs[:, 4]))
    assert (top_e.numpy() == [1, 3]).all()
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(re))
    np.testing.assert_allclose(top_w.numpy(), np.asarray(
        rw / rw.sum(-1, keepdims=True)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_equals_the_reference_scatter_add(dtype):
    """The reference scatter-adds each token's k weighted expert outputs
    into zeros in sorted (ascending expert) order; the port gathers them
    back through the inverse of the sort and adds them in that order:
    bit-equal.  Another order (the top-k order) is not."""
    rng = np.random.default_rng(6)
    T, k, D, E = 64, 4, 32, 8
    e = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    order = np.argsort(e.reshape(-1), kind="stable")
    vals = (rng.standard_normal((T * k, D)) * 100).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jnp.zeros((T, D), jdt).at[
        jnp.asarray(np.repeat(np.arange(T), k)[order])].add(
            jnp.asarray(vals).astype(jdt))
    contrib = torch.from_numpy(vals).to(getattr(torch, dtype))
    order_t = torch.from_numpy(order)
    inv = torch.empty_like(order_t)
    inv[order_t] = torch.arange(T * k)
    got = moe.combine(contrib, torch.sort(inv.reshape(T, k), -1).values,
                      T, k)
    want = np.asarray(want.astype(jnp.float32))
    assert np.array_equal(got.float().numpy(), want)
    other = moe.combine(contrib, inv.reshape(T, k), T, k)
    assert not np.array_equal(other.float().numpy(), want)


# ---------------------------------------------------- the model programs
def _smoke(arch):
    return configs.smoke_config(arch), ref_configs.smoke_config(arch)


@pytest.fixture(scope="module")
def f32_params():
    """Per arch: (port cfg, ref cfg, ref float32 params, port params),
    one numpy tree from the port's seeded init handed to both."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, ref = _smoke(arch)
            tree = jax.tree.map(lambda t: t.numpy(), transformer.init_lm(
                torch.Generator().manual_seed(0), cfg, CPU, torch.float32))
            cache[arch] = (cfg, ref, jax.tree.map(jnp.asarray, tree),
                           params_from_numpy(tree, cfg, CPU))
        return cache[arch]
    return get


def test_moe_programs_and_init_match_the_reference(f32_params):
    for arch in ARCHS:
        a = transformer.build_program(configs.get_config(arch))
        b = ref_tf.build_program(ref_configs.get_config(arch))
        assert (a.n_groups, a.n_layers) == (b.n_groups, b.n_layers)
        assert [dataclasses.asdict(s) for s in a.group + a.leftover] == \
            [dataclasses.asdict(s) for s in b.group + b.leftover]
        assert all(s.moe for s in a.group)
        cfg, ref, _, tp = f32_params(arch)
        # init_lm's MoE tree: the reference's keys and shapes
        rp = jax.eval_shape(lambda k: ref_tf.init_lm(
            k, ref, dtype=jnp.float32)[0], jax.random.PRNGKey(0))
        mine = transformer.init_lm(torch.Generator().manual_seed(0), cfg,
                                   CPU, torch.float32)
        mine_np = jax.tree.map(lambda t: t.numpy(), mine)
        assert jax.tree.structure(mine_np) == jax.tree.structure(rp)
        for x, y in zip(jax.tree.leaves(mine_np), jax.tree.leaves(rp)):
            assert x.shape == y.shape
        router = mine["g0"]["mlp"]["router"]
        assert 0.015 < float(router.std()) < 0.025
        assert ("shared" in tp["g0"]["mlp"]) == bool(cfg.moe.num_shared)


def _record_port(monkeypatch, rec):
    """Appends to ``rec``, per MoE block call in order, its input
    [T, D] and router."""
    orig = moe.apply_moe

    def wrapped(p, x, *a, **kw):
        rec.append((x.detach().reshape(-1, x.shape[-1]).numpy().copy(),
                    p["router"].detach().numpy()))
        return orig(p, x, *a, **kw)
    monkeypatch.setattr(moe, "apply_moe", wrapped)


def _record_ref(monkeypatch, rec):
    """The same for the reference's jitted calls, through an ordered
    debug callback."""
    orig = ref_moe.apply_moe

    def wrapped(p, x, *a, **kw):
        jax.debug.callback(
            lambda h, r: rec.append((np.asarray(h).reshape(
                -1, h.shape[-1]), np.asarray(r))), x, p["router"],
            ordered=True)
        return orig(p, x, *a, **kw)
    monkeypatch.setattr(ref_moe, "apply_moe", wrapped)


def _assert_routes_agree(got, want, k):
    """Each MoE call's route: equal wherever the reference's k-th /
    (k+1)-th probability margin exceeds twice the router-logit
    difference.  Returns the tokens so checked."""
    assert len(got) == len(want) > 0
    checked = 0
    for (gh, gr), (wh, wr) in zip(got, want):
        g_logits = torch.from_numpy(gh) @ torch.from_numpy(gr)
        w_logits = np.asarray(jnp.asarray(wh) @ jnp.asarray(wr))
        diff = float(np.abs(g_logits.numpy() - w_logits).max())
        probs = np.asarray(jax.nn.softmax(jnp.asarray(w_logits), axis=-1))
        _, w_e = jax.lax.top_k(probs, k)
        _, _, g_e = moe.route({"router": torch.from_numpy(gr)},
                              torch.from_numpy(gh),
                              MoEConfig(num_experts=gr.shape[1], top_k=k))
        srt = -np.sort(-probs, axis=-1)
        sure = srt[:, k - 1] - srt[:, k] > 2 * diff
        np.testing.assert_array_equal(g_e.numpy()[sure], np.asarray(w_e)[sure])
        checked += int(sure.sum())
    return checked


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_equal_the_reference(f32_params, monkeypatch,
                                                    arch):
    """Prefill logits and cache, then three decode steps, at float32
    parameters: all-SWA mixtral (window 8 < prefill 16, the ring cache)
    and qwen2-moe (full attention, MHA with QKV bias, a shared expert)."""
    cfg, ref, rp, tp = f32_params(arch)
    got_r, want_r = [], []
    _record_port(monkeypatch, got_r)
    _record_ref(monkeypatch, want_r)

    def close(got, want, what):
        np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL,
                                   rtol=0, err_msg=what)

    rng = np.random.default_rng(7)
    B, S, cap = 2, 16, 24
    toks = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    want_l, want_c = jax.jit(functools.partial(
        ref_tf.prefill, cfg=ref, cache_capacity=cap, last_pos=11))(
            rp, {"tokens": jnp.asarray(toks)})
    got_l, got_c = transformer.prefill(
        tp, {"tokens": torch.from_numpy(toks)}, cfg, cache_capacity=cap,
        last_pos=11, kernels="hopper")
    jax.effects_barrier()
    close(got_l.numpy(), want_l, "prefill logits")
    for a, b in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.float().numpy(), got_c)), jax.tree.leaves(want_c)):
        close(a, b, "prefill cache")
    if arch == "mixtral-8x22b":
        assert got_c["g0"]["k"].shape[2] == 8
    pos = np.full(B, S, np.int32)
    ref_decode = jax.jit(functools.partial(ref_tf.decode_step, cfg=ref))
    for step in range(3):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        want_l, want_c = ref_decode(rp, want_c, jnp.asarray(tok),
                                    jnp.asarray(pos))
        got_l, got_c = transformer.decode_step(
            tp, got_c, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        close(got_l.numpy(), want_l, f"decode {step} logits")
        pos = pos + 1
    jax.effects_barrier()
    # prefill: one call a layer; decode: one a layer a step
    assert len(got_r) == 4 * cfg.n_layers
    checked = _assert_routes_agree(got_r, want_r, cfg.moe.top_k)
    assert checked >= 0.9 * (B * S + 3 * B) * cfg.n_layers


def test_moe_cycle_server_stream_equals_the_reference(f32_params):
    """qwen2-moe's smoke config through both CycleServers: right-padded
    prefills whose pads compete for expert capacity, slot reuse, one
    request hitting max_seq.  Tokens equal token for token, every step's
    logits within 1e-4, and the reference's top-1 / top-2 margin above
    twice the difference."""
    cfg, ref, rp, tp = f32_params("qwen2-moe-a2.7b")
    kw = dict(capacity=2, max_seq=16, prefill_len=8, prefill_budget=2)
    want = RefCycleServer(ref, params=rp, **kw)
    got = CycleServer(cfg, params=tp, device="cpu", kernels="hopper", **kw)
    logits = {id(got): [], id(want): []}
    for srv in (got, want):
        decode = srv._decode

        def rec(p, c, t, pos, srv=srv, decode=decode):
            out = decode(p, c, t, pos)
            live = [s is not None for s in srv._slots]
            logits[id(srv)].append(np.asarray(out[0])[live])
            return out
        srv._decode = rec
    prompts = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 3, 2], [7], [9, 9, 9])
    news = (12, 5, 2, 4)
    reqs = {id(s): [s.submit(list(p), n) for p, n in zip(prompts, news)]
            for s in (got, want)}
    done_g = got.run_until_drained(max_cycles=100)
    done_w = want.run_until_drained(max_cycles=100)
    assert [r.id for r in done_g] == [r.id for r in done_w]
    for a, b in zip(reqs[id(got)], reqs[id(want)]):
        assert a.output == b.output, (a.id, a.output, b.output)
        assert (a.truncated, a.slot) == (b.truncated, b.slot)
    assert any(r.truncated for r in reqs[id(got)])
    assert got.last_drain_admitted == want.last_drain_admitted
    g, w = logits[id(got)], logits[id(want)]
    assert len(g) == len(w) > 0
    for i, (a, b) in enumerate(zip(g, w)):
        diff = float(np.abs(a - b).max()) if b.size else 0.0
        assert diff <= LOGIT_TOL, (i, diff)
        if b.size:
            top = np.sort(b.astype(np.float64), axis=-1)
            assert (top[:, -1] - top[:, -2]).min() > 2 * diff, (i, diff)
