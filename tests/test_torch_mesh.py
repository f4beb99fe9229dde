"""Port parity, sharding: ``MeshAxes`` on DTensor, the flash operator
under ``local_map``, the models, the optimizer step and the server over
a mesh, against the JAX package on the CPU at smoke size with float32
parameters (the analytic specs and the dry-run: test_torch_dryrun.py).

Meshes of ranks are simulated in this one process: a fake process group
of the mesh's size (``launch/dryrun.fake_group``) and
``LocalTensorMode``, under which every rank's shard is a real tensor
and every collective moves real numbers.  The spec trees are held
against the reference's on ``AbstractMesh``es of the production shapes
(no devices, test_torch_dryrun.py); the numbers against the reference
unsharded, except the MoE ``sharded`` dispatch, whose numbers depend on
dp (each shard has its own capacity): it is held against the reference
on an Auto-typed (2, 4) mesh of conftest's 8 host devices, whose dp 2 is
the port's.

Tolerances are ``test_torch_lm.py``'s and ``test_torch_train.py``'s:
logits and caches within 1e-4 absolute (float32 sums in another order
and split over ranks), a loss within 1e-5 relative, each gradient leaf
within 1e-4 of its norm.
"""
import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.models.common import MeshAxes as RefMeshAxes
from repro.serving import CycleServer as RefCycleServer
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.core.device import local_shards
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_axes
from repro_torch.models import moe, transformer
from repro_torch.models.common import MeshAxes, block_attention
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.serving import CycleServer
from repro_torch.core.device import host_numpy

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
FAMILIES = ("yi-6b", "qwen2-moe-a2.7b", "recurrentgemma-2b", "mamba2-370m",
            "whisper-small", "llama-3.2-vision-90b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_no_group_left():
    """One intra-op thread (smoke sizes gain nothing from more), and no
    fake process group left behind for the next module (the launchers'
    tests expect none)."""
    import torch.distributed as dist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()
        dryrun.clear_dtensor_caches()


@contextlib.contextmanager
def local_mesh(shape, names=("data", "model")):
    """A mesh of ``shape`` simulated in this process (LocalTensorMode over
    a fake group of its size) -> its ``MeshAxes`` (``make_axes``)."""
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.simulated_group(math.prod(shape)):
        yield make_axes(init_device_mesh("cpu", shape,
                                         mesh_dim_names=names))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return host_numpy(tree).astype(np.float32)
    return np.asarray(tree, np.float32)


def _close(got, want, atol, what=""):
    got, want = jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))
    assert len(got) == len(want) > 0, what
    for a, b in zip(got, want):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)


@functools.lru_cache(maxsize=None)
def _model(arch, **over):
    """(port cfg, ref cfg, numpy float32 tree of the port's init); MoE
    configs at the global "sort" dispatch unless overridden."""
    cfg = configs.smoke_config(arch)
    rcfg = ref_configs.smoke_config(arch)
    if cfg.moe is not None:
        over = {"moe_dispatch": "sort", **over}
    cfg, rcfg = (dataclasses.replace(c, **over) for c in (cfg, rcfg))
    tree = _np(transformer.init_lm(torch.Generator().manual_seed(0), cfg,
                                   CPU, torch.float32))
    return cfg, rcfg, tree


# ------------------------------------------------------- the flash operator
def test_flash_operator_passes_opcheck():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32))
    for args in ((q, k, k, True, 0), (q.bfloat16(), k.bfloat16(),
                                      k.bfloat16(), False, 3)):
        torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                              args)


@pytest.mark.parametrize("kv", [2, 1], ids=["kv-divides-tp", "kv-1"])
def test_flash_through_local_map_equals_unsharded(kv):
    """block_attention over a (2, 2) mesh: per rank on its batch rows and
    heads; KV on tp when it divides tp (contiguous shards line up),
    else replicated and expanded to H first (recurrentgemma's 1 KV
    head)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 8, 4, 16), (2, 8, kv, 16), (2, 8, kv, 16)))
    want = kref.flash_attention_ref(q, k, v, causal=True, window=3)
    with local_mesh((2, 2)) as axes:
        args = [axes.distribute(t, axes.dp) for t in (q, k, v)]
        with axes.scope():
            got = block_attention(*args, causal=True, window=3,
                                  kernels="hopper", axes=axes,
                                  head_sharded=True, kv_sharded=kv % 2 == 0)
        assert got.placements == tuple(axes.placements(4, axes.dp, None,
                                                       axes.tp, None))
        _close(got, want, 1e-6, "flash")


# ------------------------------------------------------ the models on a mesh
def _batch(cfg, rng, B, S):
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (B, S * cfg.dec_ratio, cfg.d_model)).astype(np.float32)
    if cfg.cross_every:
        b["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return b


def _placed(axes, batch):
    b = axes.batch(batch["tokens"].shape[0])
    return {k: axes.distribute(torch.from_numpy(v), b)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_prefill_decode(arch):
    """The reference unsharded on one seeded batch: the prefill's
    (logits, cache), then two decode steps' (token, position, logits,
    cache); computed once for every mesh it is held against."""
    cfg, rcfg, tree = _model(arch)
    rp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    B, S, cap = 2, 12, 20
    batch = _batch(cfg, rng, B, S)
    want_l, want_c = jax.jit(functools.partial(
        ref_tf.prefill, cfg=rcfg, cache_capacity=cap, last_pos=9))(
            rp, jax.tree.map(jnp.asarray, batch))
    prefill = (_np(want_l), _np(want_c))
    ref_decode = jax.jit(functools.partial(ref_tf.decode_step, cfg=rcfg))
    pos, steps = np.full(B, S, np.int32), []
    for _ in range(2):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        want_l, want_c = ref_decode(rp, want_c, jnp.asarray(tok),
                                    jnp.asarray(pos))
        steps.append((tok, pos, _np(want_l), _np(want_c)))
        pos = pos + 1
    return batch, cap, prefill, steps


def _prefill_decode(arch, shape, names):
    cfg, _, tree = _model(arch)
    batch, cap, (want_l, want_c), steps = _reference_prefill_decode(arch)
    with local_mesh(shape, names) as axes:
        api = get_model(cfg, axes, device="cpu", kernels="hopper")
        tp = params_from_numpy(tree, cfg, CPU, axes)
        got_l, got_c = api.prefill(tp, _placed(axes, batch),
                                   cache_capacity=cap, last_pos=9)
        _close((got_l, got_c), (want_l, want_c), LOGIT_TOL,
               f"{arch} prefill")
        b = axes.batch(batch["tokens"].shape[0])
        for step, (tok, pos, want_l, want_c) in enumerate(steps):
            got_l, same = api.decode_step(
                tp, got_c, axes.distribute(torch.from_numpy(tok), b),
                axes.distribute(torch.from_numpy(pos), b))
            assert same is got_c            # written in place, per shard
            _close((got_l, got_c), (want_l, want_c), LOGIT_TOL,
                   f"{arch} decode {step}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_on_a_2x2_mesh_equal_the_reference(arch):
    """Prefill (logits at a last position before the end, the cache) and
    two decode steps over a (data 2, model 2) mesh, against the
    reference unsharded: dense GQA, MoE, recurrent, SSD, enc-dec and
    cross."""
    _prefill_decode(arch, (2, 2), ("data", "model"))


def test_dense_prefill_and_decode_on_a_2x2x2_mesh_equal_the_reference():
    """The multi-pod layout: the batch on ("pod", "data")."""
    _prefill_decode("yi-6b", (2, 2, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b"])
def test_loss_and_grads_on_a_2x2_mesh_equal_the_reference(arch):
    """The loss and every gradient leaf over the mesh (remat, the
    vocabulary-sharded gold logit, the MoE dispatch's partial-sum
    gradients) against the reference's jitted value_and_grad."""
    cfg, rcfg, tree = _model(arch)
    rng = np.random.default_rng(3)
    batch = _batch(cfg, rng, 2, 16)
    batch["labels"] = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want_loss, want_g = jax.jit(jax.value_and_grad(functools.partial(
        ref_tf.loss_fn, cfg=rcfg)))(jax.tree.map(jnp.asarray, tree),
                                    jax.tree.map(jnp.asarray, batch))
    with local_mesh((2, 2)) as axes:
        api = get_model(cfg, axes, device="cpu")
        params = params_from_numpy(tree, cfg, CPU, axes)
        with axes.scope():
            live = [p.detach().requires_grad_()
                    for p in pytree.leaves(params)]
            loss = api.loss(pytree.unflatten(params, live),
                            _placed(axes, batch))
            grads = torch.autograd.grad(loss, live)
        got_loss = float(host_numpy(loss))
        got_g = [host_numpy(g) for g in grads]
    assert abs(got_loss - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss)), (got_loss, float(want_loss))
    want_g = jax.tree.leaves(want_g)
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= LEAF_TOL * np.linalg.norm(w), i


def test_train_step_on_a_mesh_equals_the_unsharded_step():
    """AdamW in place on DTensor leaves with the whole-mesh global norm:
    the sharded step's parameters equal the unsharded step's."""
    cfg, _, tree = _model("yi-6b")
    rng = np.random.default_rng(4)
    batch = _batch(cfg, rng, 2, 16)
    batch["labels"] = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    api0 = get_model(cfg, device="cpu")
    p0 = params_from_numpy(tree, cfg, CPU)
    loss0, p0, _, gn0 = api0.train_step(p0, api0.init_opt(p0),
                                        {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    with local_mesh((2, 2)) as axes:
        api = get_model(cfg, axes, device="cpu")
        p = params_from_numpy(tree, cfg, CPU, axes)
        opt = api.init_opt(p)
        loss, p, opt, gn = api.train_step(p, opt, _placed(axes, batch))
        got = [host_numpy(t) for t in pytree.leaves(p)]
        assert int(host_numpy(opt["step"])) == 1
        assert abs(float(host_numpy(gn)) - float(gn0)) <= 1e-5 * float(gn0)
    for g, w in zip(got, pytree.leaves(p0)):    # test_torch_train's bound
        err = np.linalg.norm(np.float64(g) - w.numpy())
        assert err <= LEAF_TOL * np.linalg.norm(w.numpy())


def test_moe_sharded_dispatch_equals_the_reference_at_dp_2():
    """dispatch="sharded" splits the tokens into dp shards, each with its
    own capacity: the port on a (2, 2) mesh against the reference on an
    Auto-typed (2, 4) mesh of 8 host devices (dp 2 both); with drops in
    this batch the unsharded reference differs."""
    if jax.device_count() < 8:
        pytest.skip("needs conftest's 8 host devices")
    cfg, rcfg, _ = _model("qwen2-moe-a2.7b", moe_dispatch="sharded")
    mcfg, act = cfg.moe, cfg.act
    rng = np.random.default_rng(5)
    D, E, F = cfg.d_model, mcfg.num_experts, mcfg.d_ff_expert
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
         "we_gate": rng.standard_normal((E, D, F)).astype(np.float32) / 8,
         "we_up": rng.standard_normal((E, D, F)).astype(np.float32) / 8,
         "we_down": rng.standard_normal((E, F, D)).astype(np.float32) / 8,
         "shared": {k: rng.standard_normal(s).astype(np.float32) / 8
                    for k, s in (("w_gate", (D, F)), ("w_up", (D, F)),
                                 ("w_down", (F, D)))}}
    x = rng.standard_normal((4, 8, D)).astype(np.float32)
    x[:, :, :8] += 2.0      # skew the routes: some experts overflow
    rmesh = jax.make_mesh((2, 4), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    raxes = RefMeshAxes(mesh=rmesh)
    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    want_y, want_aux = jax.jit(lambda p_, x_: ref_moe.apply_moe(
        p_, x_, rcfg.moe, act, raxes, dispatch="sharded"))(jp, jx)
    one_y, _ = jax.jit(lambda p_, x_: ref_moe.apply_moe(
        p_, x_, rcfg.moe, act, RefMeshAxes(), dispatch="sharded"))(jp, jx)
    assert np.abs(np.asarray(one_y) - np.asarray(want_y)).max() > 1e-3
    specs = {"router": ("data", None),
             "we_gate": (None, "data", "model"),
             "we_up": (None, "data", "model"),
             "we_down": (None, "model", "data"),
             "shared": {"w_gate": ("data", "model"),
                        "w_up": ("data", "model"),
                        "w_down": ("model", "data")}}
    with local_mesh((2, 2)) as axes:
        tp = pytree.dict_map(
            lambda a, s: axes.distribute(torch.from_numpy(a), *s), p, specs)
        with axes.scope():
            y, aux = moe.apply_moe(
                axes.unshard_fsdp(tp),
                axes.distribute(torch.from_numpy(x), axes.dp), mcfg, act,
                dispatch="sharded", axes=axes)
        _close((y, aux), (want_y, want_aux), 1e-5, "moe sharded")


def test_mesh_server_stream_equals_the_unsharded_server():
    """CycleServer(cfg, axes) over a (2, 2) mesh, eager, on the unsharded
    server's weights: the same tokens, beat for beat; jit=True with a
    mesh builds the graph's twin on the CPU (``graphed`` False; its
    stream: test_mesh_server_with_jit_serves_the_references_stream)."""
    cfg, _, tree = _model("yi-6b")
    params = params_from_numpy(tree, cfg, CPU)
    prompts = [list(range(3, 3 + n)) for n in (5, 16, 9)]

    def serve(axes):
        srv = CycleServer(cfg, axes, capacity=4, max_seq=32, prefill_len=16,
                          params=params, device="cpu", jit=False)
        for pr in prompts:
            srv.submit(pr, max_new_tokens=4)
        return [r.output for r in sorted(srv.run_until_drained(),
                                         key=lambda r: r.id)]
    want = serve(MeshAxes())
    with local_mesh((2, 2)) as axes:
        assert serve(axes) == want
        srv = CycleServer(cfg, axes, capacity=2, max_seq=8, prefill_len=4,
                          params=params, device="cpu")
        assert not srv.graphed and srv._graph is None
        assert tuple(srv._logits.shape) == (2, cfg.vocab_padded())


class _HostReads(TorchDispatchMode):
    """Records the ops of a step that read device values on the host or
    move them between devices: ``.item()`` / ``bool()``
    (``_local_scalar_dense``, ``is_nonzero``), ``nonzero``, ``equal``,
    masked selects and boolean-mask indexing (a ``nonzero`` inside), host
    data lifted into a tensor, and copies to another device."""

    READS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.item",
             "aten.nonzero", "aten.equal", "aten.masked_select",
             "aten.masked_scatter", "aten.lift_fresh", "aten.tolist")
    INDEX = ("aten.index.Tensor", "aten.index_put", "aten._index_put_impl_")

    def __init__(self):
        super().__init__()
        self.on, self.ops, self.reads = False, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if self.on:
            self.ops += 1
            read = name.startswith(self.READS)
            if name.startswith(self.INDEX):
                read = any(isinstance(i, torch.Tensor) and
                           i.dtype == torch.bool for i in args[1] or ())
            if name.startswith("aten._to_copy") and \
                    kwargs.get("device", args[0].device) != args[0].device:
                read = True
            if name.startswith("aten.copy_") and \
                    args[0].device != args[1].device:
                read = True
            if read:
                self.reads.append(name)
        return func(*args, **kwargs)


def test_mesh_decode_step_is_capture_safe():
    """The mesh server's decode body, as a graph would replay it: over two
    beats every boundary tensor (parameters, cache, tokens, positions,
    logits) keeps each rank's storage, and the body reads nothing on the
    host (recorded under the ranks' own ops, after a warm-up beat that
    fills the mesh's coordinate caches)."""
    from torch.distributed._local_tensor import LocalTensorMode
    cfg, _, tree = _model("yi-6b")
    params = params_from_numpy(tree, cfg, CPU)
    with local_mesh((2, 2)) as axes:
        srv = CycleServer(cfg, axes, capacity=4, max_seq=32, prefill_len=16,
                          params=params, device="cpu", jit=True)
        srv.submit(list(range(3, 12)), max_new_tokens=6)
        srv.submit([5, 4, 3], max_new_tokens=6)

        def ptrs():
            return [[t.data_ptr() for t in local_shards(x)]
                    for x in pytree.leaves((srv.params, srv.cache,
                                            srv._tokens, srv._positions,
                                            srv._logits))]
        before = ptrs()
        assert len(before[0]) == 4
        for _ in range(2):
            srv.run_cycle()
            assert ptrs() == before
        body = srv._decode_body_on(srv._logits)
    reads = _HostReads()
    with reads, LocalTensorMode(4):
        body()
        reads.on = True
        body()
    assert reads.ops > 1000 and reads.reads == []
    assert ptrs() == before


def test_mesh_server_with_jit_serves_the_references_stream():
    """CycleServer(cfg, axes, jit=True) over a (2, 2) mesh on the CPU:
    built as the graph's twin (``graphed`` False), the same tokens as
    the reference's unsharded CycleServer on the same weights."""
    cfg, rcfg, tree = _model("yi-6b")
    kw = dict(capacity=2, max_seq=12, prefill_len=4, prefill_budget=2)
    want = RefCycleServer(rcfg, params=jax.tree.map(jnp.asarray, tree), **kw)
    with local_mesh((2, 2)) as axes:
        got = CycleServer(cfg, axes, params=params_from_numpy(tree, cfg, CPU),
                          device="cpu", jit=True, **kw)
        assert not got.graphed and got.capture_stats == {}
        reqs = [[s.submit([1, 2, 3, 4], 5), s.submit([4, 3, 2], 2),
                 s.submit([9, 8], 3)] for s in (got, want)]
        beats = 0
        while got.pending() or got.active():
            got.run_cycle()
            want.run_cycle()
            beats += 1
            np.testing.assert_array_equal(got._pos, want._pos)
    assert beats > 3 and not want.active() and not want.pending()
    for a, b in zip(*reqs):
        assert a.output == b.output and len(a.output) == a.max_new_tokens
