"""Shared model infrastructure of the port: parameter init, norms, RoPE,
and the prefill and decode attention.

The port of ``repro.models.common``.  Layouts are the JAX package's at
every public function (``q [B,S,H,D]``, ``k/v [B,S,KV,D]``) so the tests
compare like with like.

``MeshAxes`` is the reference's sharding bundle on DTensor: it wraps a
``torch.distributed.device_mesh.DeviceMesh`` (or None), maps a
PartitionSpec-like tuple of axis names to DTensor placements
(``placements``) and redistributes a tensor to them (``constrain``, the
reference's ``with_sharding_constraint``).  With ``mesh=None`` every
helper is the identity, so the single-device path is unchanged.

Prefill attention (``block_attention``) goes through the hand-written
flash-attention kernel (``kernels/flash_attention.py``) or, with
``kernels="torch"``, its plain version.  Decode attention is plain torch,
as the reference computes it in XLA outside any kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import pytree
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

# decode_attention's mask value (the reference's -0.7 * float32 max)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Mesh axes / sharding helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Resolves logical sharding axes to the physical mesh.

    dp: axes carrying the batch (("data",) single-pod, ("pod", "data")
    multi).  fsdp: axis sharding weight rows (gathered per use).  tp: the
    tensor-parallel axis (heads / d_ff / vocab).  ``mesh`` is a
    ``DeviceMesh`` whose ``mesh_dim_names`` hold these names, or None:
    no sharding, every helper the identity.

    A spec entry is None (replicated), an axis name, or a tuple of axis
    names; a dimension sharded over ("pod", "data") is split by pod
    first, then by data, as JAX splits it, which is DTensor's order when
    the mesh lists pod before data (``placements`` raises otherwise)."""

    mesh: Any = None
    dp: tuple = ("data",)
    fsdp: Optional[str] = "data"
    tp: str = "model"

    def size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.size(self.tp)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.dp:
            n *= self.size(a)
        return n

    def batch(self, n: int):
        """The spec of an activation's batch (or token) dim of size
        ``n``: the dp axes when they divide it, else replicated.  The
        reference pins dp whatever the size (XLA pads an uneven split);
        DTensor's view and matmul rules need the split even."""
        if self.mesh is not None and n % self.dp_size == 0:
            return self.dp
        return None

    def placements(self, ndim: int, *spec) -> list:
        """DTensor placements of a tensor of ``ndim`` dims laid out as
        ``spec`` (dims past the spec replicated): Shard(d) on every mesh
        dim that tensor dim d names, Replicate on the rest."""
        from torch.distributed.tensor import Replicate, Shard
        if len(spec) > ndim:
            raise ValueError(f"spec {spec} has more entries than {ndim} dims")
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            group = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in group]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} splits its dim in "
                                 f"another order than the mesh {names}")
            for i in idx:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]} used twice in "
                                     f"{spec}")
                out[i] = Shard(d)
        return out

    def distribute(self, t, *spec):
        """A full tensor placed on the mesh as ``spec`` (no mesh: ``t``)."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements(t.dim(),
                                                               *spec))

    def constrain(self, x, *spec):
        """Redistribute ``x`` to ``spec`` (the reference's
        with_sharding_constraint), or ``x`` itself off-mesh.  A plain
        tensor under a mesh is taken as replicated."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, self.placements(x.dim(), *spec))

    def unshard_fsdp(self, tree):
        """``tree``'s DTensor leaves gathered over the fsdp axis (ZeRO-3:
        the weights a sublayer uses, whole on every data rank for the
        duration of the use; the backward reduce-scatters their
        gradients).  Off-mesh, or without fsdp, ``tree`` itself."""
        if self.mesh is None or self.fsdp is None:
            return tree
        from torch.distributed.tensor import DTensor, Replicate, Shard
        i = self.mesh.mesh_dim_names.index(self.fsdp)

        def gather(t):
            if not isinstance(t, DTensor) or \
                    not isinstance(t.placements[i], Shard):
                return t
            pl = list(t.placements)
            pl[i] = Replicate()
            return t.redistribute(self.mesh, pl)

        return pytree.dict_map(gather, tree)

    def scope(self):
        """The context a model pass runs in: under a mesh, plain tensors
        that meet DTensors (positions, masks, constants) count as
        replicated; off-mesh nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``,
    re-entrant: the remat recompute enters it inside a pass that holds it,
    and leaving the inner one must not end the outer one."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    was = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = was


def row_parallel(a, w, axes: MeshAxes, eq: str = None):
    """``a @ w`` (or ``einsum(eq, a, w)``) whose contraction runs over the
    tp-sharded dim (an attention output over its heads, an MLP's over
    d_ff).  Off-mesh the plain product.  Under a mesh each rank's partial
    sum (rounded once, as the unsharded product rounds) reduces across tp
    in float32 and the result rounds to ``a``'s dtype, where bfloat16
    partials summed in bfloat16 would round again on every rank."""
    y = a @ w if eq is None else torch.einsum(eq, a, w)
    if axes.mesh is None:
        return y
    y = axes.constrain(y.float(), axes.batch(y.shape[0]),
                       *([None] * (y.dim() - 1)))
    return y.to(a.dtype)


# ---------------------------------------------------------------------------
# Parameter init: the reference's ParamStore.add distributions and scales
# ---------------------------------------------------------------------------


class ParamStore:
    """Builds a nested dict of parameters on ``device`` from ``generator``.

    ``add`` draws as the reference's ``ParamStore.add`` does: zeros, or a
    float32 standard normal times ``scale`` (default 1/sqrt(fan-in), the
    fan-in being ``shape[-2]``, or ``shape[-1]`` for a vector), cast to
    the store's dtype.  ``stack`` prepends a layer axis of that many
    copies, each drawn independently, while the scale stays the one of a
    single layer's shape.  The bits differ from JAX's: the port does not
    reproduce ``jax.random``.

    ``specs`` is the parallel tree of each leaf's PartitionSpec as a
    tuple (the reference's ``pspec``), a stacked leaf's with a leading
    None for its layer axis, as the reference's ``stack_specs`` gives."""

    def __init__(self, generator: torch.Generator, device,
                 dtype=torch.bfloat16, stack: int = 0):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.stack = stack
        self.params: dict = {}
        self.specs: dict = {}

    def add(self, name: str, shape, spec=(), *, scale: float = None,
            zeros: bool = False, dtype=None):
        dtype = dtype or self.dtype
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        if self.device.type == "meta":      # shapes and dtypes only
            val = torch.empty(full, dtype=dtype, device=self.device)
        elif zeros:
            val = torch.zeros(full, dtype=dtype, device=self.device)
        else:
            if scale is None:
                scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2
                                        else shape[-1])
            # scaled in place: one float32 copy of a leaf at a time (a
            # full-size MoE expert stack is 16.6 GB in float32)
            val = torch.randn(full, generator=self.generator,
                              dtype=torch.float32,
                              device=self.device).mul_(scale).to(dtype)
        self.params[name] = val
        self.specs[name] = ((None,) if self.stack else ()) + tuple(spec)
        return val

    def subtree(self, name: str) -> "ParamStore":
        sub = ParamStore(self.generator, self.device, self.dtype, self.stack)
        sub.params = self.params.setdefault(name, {})
        sub.specs = self.specs.setdefault(name, {})
        return sub


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"gelu": _gelu_tanh, "silu": F.silu,
            "gelu_glu": _gelu_tanh, "swiglu": F.silu}[name]


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, theta: float):
    """positions [*, S] -> (sin, cos) each [*, S, head_dim/2], float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x [..., S, H, D]; sin/cos [..., S, D/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _expand_kv(k, n_heads: int):
    """[B, S, KV, D] -> [B, S, H, D] by repeating each group (GQA)."""
    KV = k.shape[2]
    if KV == n_heads:
        return k
    return k.repeat_interleave(n_heads // KV, dim=2)


def _attend(q, k, v, causal: bool, window: int, kernels: str):
    if kernels == "hopper":
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    if kernels == "torch":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    raise ValueError(f"kernels must be 'hopper' or 'torch', got {kernels!r}")


def block_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
                    kernels: str = "hopper", axes: MeshAxes = MeshAxes(),
                    head_sharded: bool = True, kv_sharded: bool = False):
    """Prefill attention. q [B,Sq,H,D]; k, v [B,Sk,KV,D] (KV divides H)
    -> [B,Sq,H,D].

    Query i sits at position q_offset + i, which must be Sk - Sq (always
    so in prefill) when the call is causal or windowed; a call that is
    neither (an encoder's, a cross sublayer's) sees every key, so its
    query positions do not matter.  ``window`` > 0 keeps keys fewer than
    ``window`` positions back.  ``kernels="hopper"`` runs the
    flash-attention kernel (its plain version on CPU tensors), which has
    no backward and raises on inputs that require grad under grad mode;
    ``"torch"`` the plain version, which autograd differentiates.

    Under a mesh (``axes.mesh``) the attention runs per rank through
    ``local_map``: the batch on dp when dp divides it, the heads on tp
    when ``head_sharded``.  K/V are pinned as the reference pins them:
    on tp when ``kv_sharded`` (n_kv divides tp: contiguous head shards
    line up, each rank's query heads meet its own KV groups), else
    replicated and expanded to H before the heads are sharded."""
    Sq, Sk = q.shape[1], k.shape[1]
    if (causal or window > 0) and int(q_offset) != Sk - Sq:
        raise ValueError(f"block_attention: q_offset {q_offset} != Sk - Sq "
                         f"= {Sk - Sq}; the kernel places query i at "
                         f"i + Sk - Sq")
    if axes.mesh is None:
        return _attend(q, k, v, causal, window, kernels)
    from torch.distributed.tensor.experimental import local_map
    B, H = q.shape[0], q.shape[2]
    tp_spec = axes.tp if head_sharded else None
    b_spec = axes.batch(B)
    kv_tp = axes.tp if kv_sharded else None
    k = axes.constrain(k, b_spec, None, kv_tp, None)
    v = axes.constrain(v, b_spec, None, kv_tp, None)
    if kv_tp is None and tp_spec is not None:
        k, v = _expand_kv(k, H), _expand_kv(v, H)
        kv_tp = tp_spec
    q = axes.constrain(q, b_spec, None, tp_spec, None)
    k = axes.constrain(k, b_spec, None, kv_tp, None)
    v = axes.constrain(v, b_spec, None, kv_tp, None)
    q_pl = axes.placements(4, b_spec, None, tp_spec, None)
    kv_pl = axes.placements(4, b_spec, None, kv_tp, None)
    fn = local_map(
        lambda ql, kl, vl: _attend(ql, kl, vl, causal, window, kernels),
        out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
        device_mesh=axes.mesh)
    out = fn(q, k, v)
    return axes.constrain(out, axes.batch(B), None, tp_spec, None)


def _decode_scores(q, k_cache, kv_positions, pos, window: int):
    """Masked float32 scores [B,1,KV,G,W] of decode attention (GQA folded:
    q [B,1,H,D] as [B,1,KV,G,D] against k_cache [B,W,KV,D])."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    qf = q.reshape(B, 1, KV, H // KV, D).float()
    s = torch.einsum("bqkgd,bwkd->bqkgw", qf, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window > 0:
        ok &= (pos[:, None] - kv_positions) < window
    return s.masked_fill(~ok[:, None, None, None, :], NEG_INF)


def _decode_values(p, v_cache, q):
    """The value sum of probabilities p [B,1,KV,G,W] (rounded to the
    cache's dtype, as in the reference) -> [B,1,H,D] in q's dtype."""
    B, _, H, D = q.shape
    out = torch.einsum("bqkgw,bwkd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *,
                     window: int = 0, axes: MeshAxes = MeshAxes(),
                     seq_axis_spec=None):
    """Single-token attention against a (possibly ring-buffered) cache.

    q [B,1,H,D]; k_cache / v_cache [B,W,KV,D]; kv_positions [B,W] the
    absolute position of each slot (-1 = empty); pos [B] the query's
    position.  GQA stays folded (q as [B,1,KV,G,D]), so the repeated KV
    never materialises.  Scores in float32; the probabilities are rounded
    to the cache's dtype before the value sum, as in the reference.

    Under a mesh the cache is pinned as the reference pins it (batch on
    dp when it divides, KV heads on tp when they divide it and the
    sequence is not on tp, the sequence on ``seq_axis_spec``) and each
    rank attends over its own shard (``local_map``).  With a sharded
    sequence (split-KV) the softmax's normalisation is the cross-rank
    combine: the ranks' maxima reduced by max, then their sums by sum,
    then their value sums by sum."""
    if axes.mesh is None:
        s = _decode_scores(q, k_cache, kv_positions, pos, window)
        return _decode_values(torch.softmax(s, dim=-1), v_cache, q)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    B, KV = q.shape[0], k_cache.shape[2]
    b_spec = axes.batch(B)
    kv_tp = axes.tp if (KV % max(axes.tp_size, 1) == 0
                        and seq_axis_spec != axes.tp) else None
    sq = seq_axis_spec
    # the query heads fold into (KV, G): on tp as the KV heads are
    args = (axes.constrain(q, b_spec, None, kv_tp, None),
            axes.constrain(k_cache, b_spec, sq, kv_tp, None),
            axes.constrain(v_cache, b_spec, sq, kv_tp, None),
            axes.constrain(kv_positions, b_spec, sq),
            axes.constrain(pos, b_spec))
    in_pl = tuple(list(a.placements) for a in args)
    out_pl = axes.placements(4, b_spec, None, kv_tp, None)

    def lmap(fn, out):
        return local_map(fn, out_placements=(out,), in_placements=in_pl,
                         device_mesh=axes.mesh)

    if sq is None:
        def whole(q_, k_, v_, kp, p_):
            s = _decode_scores(q_, k_, kp, p_, window)
            return _decode_values(torch.softmax(s, dim=-1), v_, q_)
        return lmap(whole, out_pl)(*args)
    names = axes.mesh.mesh_dim_names
    seq_dims = [names.index(a) for a in
                (sq if isinstance(sq, tuple) else (sq,))]

    def reduced(op):
        pl = axes.placements(5, b_spec, None, kv_tp, None)
        for i in seq_dims:
            pl[i] = Partial(op)
        return pl

    m = lmap(lambda q_, k_, v_, kp, p_: _decode_scores(
        q_, k_, kp, p_, window).amax(-1, keepdim=True), reduced("max"))(
            *args)
    m = axes.constrain(m, b_spec, None, kv_tp, None)

    def sums(q_, k_, v_, kp, p_, m_):
        return torch.exp(_decode_scores(q_, k_, kp, p_, window) - m_).sum(
            -1, keepdim=True)
    m_pl = list(m.placements)
    l_ = local_map(sums, out_placements=(reduced("sum"),),
                   in_placements=in_pl + (m_pl,),
                   device_mesh=axes.mesh)(*args, m)
    l_ = axes.constrain(l_, b_spec, None, kv_tp, None)

    def values(q_, k_, v_, kp, p_, m_, l_):
        p = torch.exp(_decode_scores(q_, k_, kp, p_, window) - m_) / l_
        return _decode_values(p, v_, q_)
    out_sum = list(out_pl)
    for i in seq_dims:
        out_sum[i] = Partial("sum")
    out = local_map(values, out_placements=(out_sum,),
                    in_placements=in_pl + (m_pl, list(l_.placements)),
                    device_mesh=axes.mesh)(*args, m, l_)
    return axes.constrain(out, b_spec, None, kv_tp, None)
