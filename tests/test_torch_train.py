"""Port parity, training: ``repro_torch.models.transformer.loss_fn`` and
its gradients for the dense, MoE, SSD, recurrent, encoder-decoder and
cross programs, remat, ``repro_torch.optim`` (AdamW, sign compression,
the cosine schedule) and ``ModelApi.train_step``, against the JAX
package's, on the CPU at smoke size with float32 parameters; and the
flash-attention wrapper's refusal to run on inputs that require grad.

Inputs are made with numpy from fixed seeds; both packages get one
numpy tree from the port's seeded init (the reference's eager init costs
seconds a model).  Tolerances: a loss within 1e-5 relative, each gradient
leaf and each parameter after a step within 1e-4 of its norm (float32
sums in another order: the port's plain attention is the naive one, the
reference's blocked); the optimizer's float32 outputs within 1e-6
relative, an element near cancellation (a moment or an error feedback
near 0) within 1e-6 of its leaf's largest magnitude, its int32 step
equal.  A MoE model's routes are held equal
wherever the reference's k-th / (k+1)-th router probability margin
exceeds twice the largest router-logit difference between the packages
(tests/test_torch_moe.py), so equal routes are forced there, not luck.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.optim import schedules as ref_schedules
from repro_torch import configs
from repro_torch.configs import MoEConfig
from repro_torch.core import pytree
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import moe, transformer
from repro_torch.models.common import block_attention
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.optim import adamw, schedules

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
OPT_RTOL = 1e-6
ARCHS = ("stablelm-1.6b", "qwen2-moe-a2.7b", "mamba2-370m",
         "recurrentgemma-2b", "whisper-small", "llama-3.2-vision-90b")
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke sizes gain nothing from intra-op threads; one thread keeps
    this module from oversubscribing the cores that parallel test workers
    share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port cfg, ref cfg, numpy float32 tree from the port's init)."""
    cfg = configs.smoke_config(arch)
    tree = _np(transformer.init_lm(torch.Generator().manual_seed(0), cfg,
                                   CPU, torch.float32))
    return cfg, ref_configs.smoke_config(arch), tree


def _batch(cfg, step=0):
    """The launcher's batch of ``step`` (numpy; frames / vision float32)."""
    return RefTokenPipeline(RefDataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=3,
        frames_dim=cfg.d_model if cfg.enc_dec else 0,
        frames_len=S * cfg.dec_ratio if cfg.enc_dec else 0,
        vision_tokens=cfg.n_vision_tokens if cfg.cross_every else 0,
        vision_dim=cfg.d_model if cfg.cross_every else 0)).batch_at(step)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _port_loss_and_grads(params, batch, cfg):
    leaves = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    loss = transformer.loss_fn(pytree.unflatten(params, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _assert_leaves_close(got, want, what):
    """Each leaf of ``got`` within LEAF_TOL of the norm of ``want``'s."""
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = np.linalg.norm(g - w)
        assert err <= LEAF_TOL * np.linalg.norm(w), (what, i, err,
                                                     np.linalg.norm(w))


def _record_routes(monkeypatch):
    """Per MoE block call, in order, the port's and the reference's block
    input [T, D] and router (the reference's through an ordered debug
    callback)."""
    got, want = [], []
    orig, ref_orig = moe.apply_moe, ref_moe.apply_moe

    def port(p, x, *a, **kw):
        got.append((x.detach().reshape(-1, x.shape[-1]).numpy().copy(),
                    p["router"].detach().numpy().copy()))
        return orig(p, x, *a, **kw)

    def ref(p, x, *a, **kw):
        jax.debug.callback(
            lambda h, r: want.append((np.asarray(h).reshape(
                -1, h.shape[-1]), np.asarray(r))), x, p["router"],
            ordered=True)
        return ref_orig(p, x, *a, **kw)
    monkeypatch.setattr(moe, "apply_moe", port)
    monkeypatch.setattr(ref_moe, "apply_moe", ref)
    return got, want


def _assert_routes_agree(got, want, k):
    """Equal routes wherever the reference's margin allows; returns the
    tokens so checked."""
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
        np.testing.assert_array_equal(g_e.numpy()[sure],
                                      np.asarray(w_e)[sure])
        checked += int(sure.sum())
    return checked


# ------------------------------------------------------------------ the loss
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_the_reference(arch, monkeypatch):
    """loss_fn and every gradient leaf at float32 parameters: dense
    (stablelm: layernorm, MHA), MoE (qwen2-moe: the aux term at 0.01),
    SSD (mamba2), recurrent (recurrentgemma), encoder-decoder (whisper)
    and cross (llama-vision); one jitted jax.value_and_grad each."""
    cfg, rcfg, tree = _model(arch)
    if cfg.moe is not None:
        # no remat in the reference here: its recompute would run the
        # route recorder twice (remat changes no value, see below)
        rcfg = dataclasses.replace(rcfg, remat="none")
        got_r, want_r = _record_routes(monkeypatch)
    batch = _batch(cfg)
    want_loss, want_g = jax.jit(jax.value_and_grad(functools.partial(
        ref_tf.loss_fn, cfg=rcfg)))(jax.tree.map(jnp.asarray, tree),
                                    jax.tree.map(jnp.asarray, batch))
    loss, grads = _port_loss_and_grads(params_from_numpy(tree, cfg, CPU),
                                       _t(batch), cfg)
    jax.effects_barrier()
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_RTOL * abs(float(want_loss)), (float(loss), float(want_loss))
    _assert_leaves_close([g.numpy() for g in grads], jax.tree.leaves(want_g),
                         f"{arch} grads")
    if cfg.moe is not None:
        # the port's backward recomputes each layer (remat): its calls
        # come twice, the forward's first
        assert len(got_r) == 2 * len(want_r) == 2 * cfg.n_layers
        assert _assert_routes_agree(got_r[:cfg.n_layers], want_r,
                                    cfg.moe.top_k) > 0


def test_moe_aux_term_joins_the_loss_at_one_hundredth(monkeypatch):
    """The MoE model's loss is the cross-entropy plus 0.01 x the aux loss
    summed over its layers."""
    cfg, _, tree = _model("qwen2-moe-a2.7b")
    params = params_from_numpy(tree, cfg, CPU)
    batch = _t(_batch(cfg))
    aux = []
    orig = moe.apply_moe

    def rec(*a, **kw):
        y, a_ = orig(*a, **kw)
        aux.append(a_)
        return y, a_
    with torch.no_grad():
        loss = transformer.loss_fn(params, batch, cfg)
        monkeypatch.setattr(moe, "apply_moe",
                            lambda *a, **kw: (orig(*a, **kw)[0], 0.0))
        ce = transformer.loss_fn(params, batch, cfg)
        monkeypatch.setattr(moe, "apply_moe", rec)
        transformer.loss_fn(params, batch, cfg)
    assert len(aux) == cfg.n_layers and float(sum(aux)) > 0
    torch.testing.assert_close(loss, ce + 0.01 * sum(aux), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ("stablelm-1.6b", "whisper-small"))
def test_remat_changes_nothing(arch, monkeypatch):
    """cfg.remat="full" (each group iteration recomputed in the backward
    pass; whisper's encoder too) and "none" give bit-equal loss and
    gradients."""
    cfg, _, tree = _model(arch)
    batch = _t(_batch(cfg))
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    out = {}
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = _port_loss_and_grads(params_from_numpy(tree, c, CPU),
                                          batch, c)
    groups = transformer.build_program(cfg).n_groups + (
        transformer.build_encoder_program(cfg).n_groups if cfg.enc_dec
        else 0)
    assert len(calls) == groups > 0
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_loss_never_launches_the_flash_kernel(monkeypatch):
    """The loss runs the plain attention whatever the model's kernels:
    the flash wrapper (no backward) is never called on the loss path,
    while prefill with kernels="hopper" calls it."""
    cfg, _, tree = _model("stablelm-1.6b")
    calls = []
    orig = fa.flash_attention

    def rec(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention", rec)
    api = get_model(cfg, device="cpu", kernels="hopper")
    params = params_from_numpy(tree, cfg, CPU)
    opt = api.init_opt(params)
    api.train_step(params, opt, _t(_batch(cfg)))
    assert calls == []
    with torch.no_grad():
        api.prefill(params, {"tokens": torch.ones((1, 8), dtype=torch.int32)})
    assert len(calls) == cfg.n_layers


def test_flash_attention_refuses_inputs_that_require_grad():
    """The kernel has no backward: under grad mode, q, k or v requiring
    grad raises (on the CPU as on the card) instead of returning an
    output cut off from the graph; without grad mode, or through the
    plain path, the same call runs."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    for which in range(3):
        args = [t.clone() for t in (q, k, v)]
        args[which].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention(*args, causal=True)
        with pytest.raises(RuntimeError, match="no backward"):
            block_attention(*args, causal=True, kernels="hopper")
        with torch.no_grad():
            want = fa.flash_attention(*args, causal=True)
        got = block_attention(*args, causal=True, kernels="torch")
        assert got.requires_grad
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- optimizer
def _grad_tree(rng, scale):
    return {"a": (rng.standard_normal((4, 6)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * scale).astype(np.float32)}}


def _close_tree(got, want, what):
    for g, w in zip(pytree.leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:   # near-cancelled elements are held to the leaf's scale
            np.testing.assert_allclose(g, w, rtol=OPT_RTOL,
                                       atol=OPT_RTOL * np.abs(w).max(),
                                       err_msg=what)


@pytest.mark.parametrize("scale", [0.01, 10.0])
@pytest.mark.parametrize("lr", [None, 0.05])
def test_adamw_update_equals_the_reference(scale, lr):
    """Three updates from identical trees: a gradient norm below and
    above grad_clip, the config's lr and an explicit one.  The port's
    update writes into the given tensors."""
    rng = np.random.default_rng(4)
    cfg = adamw.AdamWConfig(weight_decay=0.1)
    rcfg = ref_adamw.AdamWConfig(weight_decay=0.1)
    p_np = _grad_tree(rng, 1.0)
    params, rparams = pytree.tree_map(torch.from_numpy, p_np), \
        jax.tree.map(jnp.asarray, p_np)
    st, rst = adamw.adamw_init(params), ref_adamw.adamw_init(rparams)
    first = pytree.leaves((params, st))
    for _ in range(3):
        g = _grad_tree(rng, scale)
        rparams, rst, rn = ref_adamw.adamw_update(
            rparams, jax.tree.map(jnp.asarray, g), rst, rcfg, lr)
        tg = pytree.tree_map(torch.from_numpy, g)
        params, st, n = adamw.adamw_update(params, tg, st, cfg, lr)
        _close_tree(params, rparams, "params")
        _close_tree((st["m"], st["v"]), (rst["m"], rst["v"]), "moments")
        assert int(st["step"]) == int(rst["step"])
        assert st["step"].dtype == torch.int32
        np.testing.assert_allclose(float(n), float(rn), rtol=OPT_RTOL)
        assert all(a is b for a, b in zip(pytree.leaves((params, st)),
                                          first))
    assert (float(n) > cfg.grad_clip) == (scale > 1)


def test_adamw_update_keeps_bf16_params_and_f32_moments():
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((3, 8)).astype(np.float32)}
    g = {"w": rng.standard_normal((3, 8)).astype(np.float32)}
    params = {"w": torch.from_numpy(p["w"]).to(torch.bfloat16)}
    rparams = {"w": jnp.asarray(p["w"], jnp.bfloat16)}
    tg = {"w": torch.from_numpy(g["w"]).to(torch.bfloat16)}
    rg = {"w": jnp.asarray(g["w"], jnp.bfloat16)}
    cfg, rcfg = adamw.AdamWConfig(), ref_adamw.AdamWConfig()
    new, st, _ = adamw.adamw_update(params, tg, adamw.adamw_init(params),
                                    cfg)
    rnew, rst, _ = ref_adamw.adamw_update(rparams, rg,
                                          ref_adamw.adamw_init(rparams),
                                          rcfg)
    assert new["w"].dtype == torch.bfloat16
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(new["w"].float().numpy(),
                                  np.asarray(rnew["w"], np.float32))
    _close_tree(st["m"], rst["m"], "m")


@pytest.mark.parametrize("compression", ["none", "sign"])
def test_compress_grads_equals_the_reference(compression):
    """Sign compression with error feedback over eight rounds (and the
    pass-through)."""
    rng = np.random.default_rng(6)
    cfg = adamw.AdamWConfig(compression=compression)
    rcfg = ref_adamw.AdamWConfig(compression=compression)
    st, rst = {}, {}
    for _ in range(8):
        g = _grad_tree(rng, 1.0)
        q, st = adamw.compress_grads(pytree.tree_map(torch.from_numpy, g),
                                     st, cfg)
        rq, rst = ref_adamw.compress_grads(jax.tree.map(jnp.asarray, g),
                                           rst, rcfg)
        _close_tree(q, rq, "quantised")
        if compression == "sign":
            _close_tree(st["err"], rst["err"], "error feedback")
        else:
            assert st == {} and rst == {}


def test_cosine_schedule_equals_the_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for kw in (dict(peak_lr=3e-3, warmup=10, total=100),
               dict(peak_lr=1.0, warmup=0, total=50, floor=0.0)):
        got = schedules.cosine_schedule(torch.from_numpy(steps), **kw)
        want = ref_schedules.cosine_schedule(jnp.asarray(steps), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OPT_RTOL, atol=1e-12)


# ---------------------------------------------------------------- train_step
def test_train_step_equals_the_reference():
    """Two train_steps from the same float32 tree and batches: loss,
    gnorm and every parameter and moment after each step, and the step
    count."""
    cfg, rcfg, tree = _model("stablelm-1.6b")
    api = get_model(cfg, device="cpu")
    rapi = ref_registry.get_model(rcfg)
    params = params_from_numpy(tree, cfg, CPU)
    opt = api.init_opt(params)
    rparams = jax.tree.map(jnp.asarray, tree)
    ropt = rapi.init_opt(rparams)
    rstep = jax.jit(rapi.train_step)
    for step in range(2):
        batch = _batch(cfg, step)
        rloss, rparams, ropt, rn = rstep(rparams, ropt,
                                         jax.tree.map(jnp.asarray, batch))
        loss, params, opt, n = api.train_step(params, opt, _t(batch))
        assert abs(float(loss) - float(rloss)) \
            <= LOSS_RTOL * abs(float(rloss))
        np.testing.assert_allclose(float(n), float(rn), rtol=LEAF_TOL)
        _assert_leaves_close([p.numpy() for p in pytree.leaves(params)],
                             jax.tree.leaves(rparams), f"params {step}")
        _assert_leaves_close(
            [m.numpy() for m in pytree.leaves((opt["m"], opt["v"]))],
            jax.tree.leaves((ropt["m"], ropt["v"])), f"moments {step}")
        assert int(opt["step"]) == int(ropt["step"]) == step + 1
