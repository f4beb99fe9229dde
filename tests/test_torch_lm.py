"""Port parity, LM serving: the PyTorch package's configs, model pieces,
prefill / decode_step and CycleServer against the JAX package's, on the
CPU at smoke size with float32 parameters.

Inputs are made with numpy from fixed seeds and handed to both packages;
the parameters are one numpy tree of the port's seeded init, handed to
the reference as arrays and to the port through ``params_from_numpy``.
Tolerances:
norms, activations and RoPE at rtol/atol 1e-6 (float32 elementwise);
prefill and decode logits and caches at atol 1e-4 (float32 matmuls summed
in another order) for yi and stablelm.  gemma3's 7 layers amplify that
roundoff about 5x a layer through the random weights' sharp softmax (the
reference itself lies 3.7e-5 from a float64 run of the port at the
prefill logits, and 1.2e-4 of the scale at the last layer's cache), so
its logits and caches are held to 1e-3 of each tensor's largest
magnitude (measured on the reference's own init: 3.7e-4 after three
decode steps).  Served token
streams equal token for token, the logits of every step within 1e-4, and
the reference's top-1 / top-2 logit margin above twice the step's largest
logit difference, so equal tokens are forced at every step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.serving import CycleServer as RefCycleServer
from repro_torch import configs
from repro_torch.models import common, transformer
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.serving import CycleServer

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4
GEMMA_REL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_np(tree):
    if isinstance(tree, dict):
        return {k: _torch_np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _smoke(arch):
    cfg = configs.smoke_config(arch)
    ref = ref_configs.smoke_config(arch)
    if arch != "stablelm-1.6b":          # GQA: 4 heads over 2 kv heads
        cfg = dataclasses.replace(cfg, n_kv=2)
        ref = dataclasses.replace(ref, n_kv=2)
    return cfg, ref


@pytest.fixture(scope="module")
def f32_params():
    """Per arch: (port cfg, ref cfg, ref float32 params, port params),
    one numpy tree from the port's seeded init handed to both."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, ref = _smoke(arch)
            tree = _torch_np(transformer.init_lm(
                torch.Generator().manual_seed(0), cfg, CPU, torch.float32))
            cache[arch] = (cfg, ref, jax.tree.map(jnp.asarray, tree),
                           params_from_numpy(tree, cfg, CPU))
        return cache[arch]
    return get


# ------------------------------------------------------------------ configs
def test_configs_equal_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.SHAPES.keys() == ref_configs.SHAPES.keys()
    for name, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            ref_configs.SHAPES[name])
    for arch in configs.ARCH_IDS:
        a, b = configs.get_config(arch), ref_configs.get_config(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
        assert a.param_count() == b.param_count(), arch
        assert a.vocab_padded() == b.vocab_padded(), arch
        assert dataclasses.asdict(configs.smoke_config(arch)) == \
            dataclasses.asdict(ref_configs.smoke_config(arch)), arch
    assert type(configs.get_config("shareddb-tpcw")).__module__ == \
        "repro_torch.configs.shareddb_tpcw"
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_build_program_matches_and_raises_for_unported_programs():
    """Every configuration's program (and whisper's encoder program)
    equals the reference's, at the published sizes and at smoke size; no
    configuration is left unported."""
    def same(a, b):
        assert (a.n_groups, a.n_layers) == (b.n_groups, b.n_layers)
        assert [dataclasses.asdict(s) for s in a.group + a.leftover] == \
            [dataclasses.asdict(s) for s in b.group + b.leftover]
    for arch in configs.ARCH_IDS:
        for get in ("get_config", "smoke_config"):
            cfg = getattr(configs, get)(arch)
            ref = getattr(ref_configs, get)(arch)
            same(transformer.build_program(cfg), ref_tf.build_program(ref))
            if cfg.enc_dec:
                same(transformer.build_encoder_program(cfg),
                     ref_tf.build_encoder_program(ref))


# ------------------------------------------------------------ model pieces
def test_norms_activation_and_rope_equal_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 0.5
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    pairs = [
        (common.rmsnorm(tx, ts), ref_common.rmsnorm(x, scale)),
        (common.layernorm(tx, ts, tb), ref_common.layernorm(x, scale, bias)),
        (common.act_fn("gelu_glu")(tx), ref_common.act_fn("gelu_glu")(x)),
        (common.act_fn("swiglu")(tx), ref_common.act_fn("swiglu")(x)),
    ]
    pos = np.array([[0, 1, 2, 7, 300]], np.int32)
    sin, cos = common.rope_tables(torch.from_numpy(pos), 16, 5e6)
    rsin, rcos = ref_common.rope_tables(jnp.asarray(pos), 16, 5e6)
    q = rng.standard_normal((1, 5, 4, 16)).astype(np.float32)
    pairs += [(sin, rsin), (cos, rcos),
              (common.apply_rope(torch.from_numpy(q), sin, cos),
               ref_common.apply_rope(q, rsin, rcos))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # gelu is the tanh approximation, as jax.nn.gelu's default
    assert not np.allclose(torch.nn.functional.gelu(tx).numpy(),
                           np.asarray(ref_common.act_fn("gelu")(x)),
                           rtol=1e-6, atol=1e-6)


def test_init_lm_shapes_scales_and_layernorm_scale():
    cfg, ref = _smoke("stablelm-1.6b")
    params = get_model(cfg, device=CPU).init_params(seed=3)
    want = jax.eval_shape(lambda k: ref_tf.init_lm(k, ref)[0],
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(_torch_np(params)) == jax.tree.structure(want)
    for got, ref_leaf in zip(jax.tree.leaves(_torch_np(params)),
                             jax.tree.leaves(want)):
        assert got.shape == ref_leaf.shape
    assert params["embed"].dtype == torch.bfloat16
    # layernorm's scale is drawn (std 1/sqrt(d)), rmsnorm's is zero
    s = params["g0"]["norm"]["scale"].float()
    assert 0.5 / 8 < s.std().item() < 2.0 / 8
    yi = get_model(_smoke("yi-6b")[0], device=CPU).init_params(seed=3)
    assert not yi["g0"]["norm"]["scale"].any()
    e = params["embed"].float()
    assert 0.015 < e.std().item() < 0.025


def test_params_from_numpy_round_trip(f32_params):
    cfg, ref, rp, tp = f32_params("gemma3-27b")
    want = _np_tree(rp)
    back = _torch_np(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # bfloat16 leaves come across exactly
    bf = jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16), rp)
    tb = params_from_numpy(bf, cfg, CPU)
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  np.asarray(bf["embed"], np.float32))
    bad = dict(want)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="root"):
        params_from_numpy(bad, cfg, CPU)
    bad = jax.tree.map(lambda a: a, want)
    bad["g0"]["attn"]["wq"] = bad["g0"]["attn"]["wq"][:, :, :1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(bad, cfg, CPU)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-27b", "stablelm-1.6b"])
def test_prefill_and_decode_equal_the_reference(f32_params, arch):
    """Prefill logits and cache, then three decode steps, at float32
    parameters: GQA (yi), window 8 < prefill 16 with the ring cache
    (gemma3), layernorm (stablelm)."""
    cfg, ref, rp, tp = f32_params(arch)

    def close(got, want, what):
        want = np.asarray(want)
        tol = LOGIT_TOL if arch != "gemma3-27b" else \
            GEMMA_REL_TOL * max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)

    rng = np.random.default_rng(7)
    B, S, cap = 2, 16, 24
    toks = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    # the reference jitted: eager JAX runs its layer scan op by op
    want_l, want_c = jax.jit(functools.partial(
        ref_tf.prefill, cfg=ref, cache_capacity=cap, last_pos=11))(
            rp, {"tokens": jnp.asarray(toks)})
    for kernels in ("hopper", "torch"):
        got_l, got_c = transformer.prefill(
            tp, {"tokens": torch.from_numpy(toks)}, cfg, cache_capacity=cap,
            last_pos=11, kernels=kernels)
        close(got_l.numpy(), want_l, f"prefill logits {kernels}")
        assert jax.tree.structure(_torch_np(got_c)) == \
            jax.tree.structure(_np_tree(want_c))
        for a, b in zip(jax.tree.leaves(_torch_np(got_c)),
                        jax.tree.leaves(_np_tree(want_c))):
            close(a, b, f"prefill cache {kernels}")
    if arch == "gemma3-27b":     # the local layers' ring holds 8 slots
        assert got_c["g0"]["k"].shape[2] == 8
        assert got_c["g5"]["k"].shape[2] == cap
    pos = np.full(B, S, np.int32)
    ref_decode = jax.jit(functools.partial(ref_tf.decode_step, cfg=ref))
    for step in range(3):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        want_l, want_c = ref_decode(rp, want_c, jnp.asarray(tok),
                                    jnp.asarray(pos))
        got_l, got_c = transformer.decode_step(
            tp, got_c, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        close(got_l.numpy(), want_l, f"decode {step} logits")
        for a, b in zip(jax.tree.leaves(_torch_np(got_c)),
                        jax.tree.leaves(_np_tree(want_c))):
            close(a, b, f"decode {step} cache")
        pos = pos + 1


def test_block_attention_rejects_another_query_offset():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 6, 2, 16)
    with pytest.raises(ValueError, match="q_offset"):
        common.block_attention(q, k, k, causal=True, q_offset=0)
    out = common.block_attention(q, k, k, causal=True, q_offset=2)
    assert out.shape == q.shape


# --------------------------------------------------------------- the server
class _Steps:
    """Records a server's logits at every prefill and every decode step
    (rows of the slots active in that step), in order."""

    def __init__(self, srv):
        self.logits = []
        prefill, decode = srv._prefill, srv._decode

        def rec_prefill(*a):
            logits, cache = prefill(*a)
            self.logits.append(_as_np(logits))
            return logits, cache

        def rec_decode(p, c, t, pos):
            logits, cache = decode(p, c, t, pos)
            live = [s is not None for s in srv._slots]
            self.logits.append(_as_np(logits)[live])
            return logits, cache
        srv._prefill, srv._decode = rec_prefill, rec_decode


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _short(s):
    for p in ([5, 17, 3], [9], list(range(1, 8))):
        yield [s.submit(list(p), 1)], 10000


def _empty(s):
    yield [s.submit([], 2)], 20


def _full(s):
    yield [s.submit(list(range(1, 9)), 1)], 10000


def _cap_hit(s):
    yield [s.submit(list(range(1, 9)), 64)], 200
    yield [s.submit(list(range(1, 9)), 3)], 50


def _mixed(s):
    yield [s.submit([1, 2, 3, 4], 99), s.submit([4, 3, 2], 2)], 100


SCENARIOS = {   # the five of tests/test_serving_scheduler.py
    "short_prompt": (dict(capacity=2, max_seq=32, prefill_len=8), _short),
    "empty_prompt": (dict(capacity=1, max_seq=16, prefill_len=4), _empty),
    "full_length": (dict(capacity=1, max_seq=32, prefill_len=8), _full),
    "cap_hit": (dict(capacity=2, max_seq=16, prefill_len=8,
                     prefill_budget=2), _cap_hit),
    "mixed": (dict(capacity=2, max_seq=12, prefill_len=4,
                   prefill_budget=2), _mixed),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cycle_server_streams_equal_the_reference(f32_params, scenario):
    kw, script = SCENARIOS[scenario]
    cfg, ref, rp, tp = f32_params("stablelm-1.6b")
    want = RefCycleServer(ref, params=rp, **kw)
    got = CycleServer(cfg, params=tp, device="cpu", kernels="hopper", **kw)
    steps_w, steps_g = _Steps(want), _Steps(got)
    for (reqs_g, cap), (reqs_w, _) in zip(script(got), script(want)):
        done_g = got.run_until_drained(max_cycles=cap)
        done_w = want.run_until_drained(max_cycles=cap)
        assert [r.id for r in done_g] == [r.id for r in done_w]
        for a, b in zip(reqs_g, reqs_w):
            assert a.output == b.output, (a.id, a.output, b.output)
            assert (a.truncated, a.slot) == (b.truncated, b.slot)
            assert (a.done_time is None) == (b.done_time is None)
        assert got.last_drain_admitted == want.last_drain_admitted
        assert got.last_drain_active == want.last_drain_active
        assert len(got.last_drain_walls) == len(want.last_drain_walls)
        assert got.cycles == want.cycles
        np.testing.assert_array_equal(got._pos, want._pos)
    assert got.active() == want.active() == 0
    # every step's logits agree, and the reference's top-1 / top-2 margin
    # exceeds twice their largest difference: equal argmaxes are then
    # forced, not luck
    assert len(steps_g.logits) == len(steps_w.logits) > 0
    for i, (g, w) in enumerate(zip(steps_g.logits, steps_w.logits)):
        diff = float(np.abs(g - w).max()) if w.size else 0.0
        assert diff <= LOGIT_TOL, (i, diff)
        top = np.sort(w.astype(np.float64), axis=-1)
        if w.size:
            assert (top[:, -1] - top[:, -2]).min() > 2 * diff, (i, diff)
    # the slot cache stays bfloat16 under float32 parameters
    assert got.cache["g0"]["k"].dtype == torch.bfloat16


def test_cycle_server_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    cfg, _ = _smoke("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        CycleServer(cfg, capacity=1, max_seq=8, prefill_len=4)
    with pytest.raises(ValueError, match="kernels"):
        CycleServer(cfg, capacity=1, max_seq=8, prefill_len=4,
                    device="cpu", kernels="pallas")
