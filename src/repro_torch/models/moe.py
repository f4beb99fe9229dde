"""Dense gated MLP and sort-based capacity MoE (``repro.models.moe``'s
port).

``init_mlp`` / ``apply_mlp`` are the gated MLP (swiglu / geglu),
``init_mlp_nonglu`` / ``apply_mlp_nonglu`` the plain one with biases.

The MoE dispatch follows the "tokens become data" discipline: token ->
expert assignments are sorted by expert id and scattered into a
capacity-padded [E, C, D] buffer, so the expert FFN is one batched
matmul over the experts (static shapes: the decode step that holds it
is captured as a CUDA graph).  Three rules keep it equal to the
reference and reproducible on the card:

  * top-k by a stable descending sort: among equal probabilities the
    lower expert index comes first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order);
  * capacity and drops exactly as the reference's: a stable argsort by
    expert, the rank within an expert as ``arange - searchsorted(left)``,
    ``keep = rank < C``, dropped assignments into the overflow row E*C;
  * a fixed-order combine: each token's k weighted expert outputs are
    gathered back through the inverse of the sort and added in the order
    the reference's scatter-add adds them (ascending expert id for the
    sort dispatch, the top-k order for the one-hot one), in ``x.dtype``,
    with no atomics, so a run and its re-run agree bit for bit.

Nothing in it reads a value back to the host (no ``nonzero``, boolean
indexing or ``.item()``).

Sharding (``MeshAxes``): expert weights are FSDP x TP sharded as the
reference's specs say, and ``dispatch="sharded"`` is the reference's
shard-local dispatch: the T tokens split into ``dp_size`` shards of T /
dp_size, each dispatched into its own capacity ``moe_capacity(T /
dp_size)`` buffer by the sort machinery, on its own rank (``local_map``:
tokens on the dp axes, replicated over tp; the expert weights gathered
over fsdp and kept on tp, so each rank's expert outputs are a partial
sum over tp).  No token crosses a data rank.  Without a mesh there is
one shard, and "sharded" is "sort".
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (MeshAxes, ParamStore, act_fn,
                                       row_parallel)

DISPATCHES = ("sort", "onehot", "sharded")


# ---------------------------------------------------------------------------
# Dense gated MLP (swiglu / geglu)
# ---------------------------------------------------------------------------


def init_mlp(store: ParamStore, d_model: int, d_ff: int,
             axes: MeshAxes = MeshAxes()):
    store.add("w_gate", (d_model, d_ff), (axes.fsdp, axes.tp))
    store.add("w_up", (d_model, d_ff), (axes.fsdp, axes.tp))
    store.add("w_down", (d_ff, d_model), (axes.tp, axes.fsdp))


def apply_mlp(p, x, act: str, axes: MeshAxes = MeshAxes()):
    h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_up"])
    if h.dim() == 3:
        h = axes.constrain(h, axes.batch(h.shape[0]), None, axes.tp)
    else:   # flattened tokens [T, d_ff] (the MoE shared experts)
        h = axes.constrain(h, axes.batch(h.shape[0]), axes.tp)
    return row_parallel(h, p["w_down"], axes)


def init_mlp_nonglu(store: ParamStore, d_model: int, d_ff: int,
                    axes: MeshAxes = MeshAxes()):
    store.add("w_in", (d_model, d_ff), (axes.fsdp, axes.tp))
    store.add("b_in", (d_ff,), (axes.tp,), zeros=True)
    store.add("w_out", (d_ff, d_model), (axes.tp, axes.fsdp))
    store.add("b_out", (d_model,), (None,), zeros=True)


def apply_mlp_nonglu(p, x, act: str, axes: MeshAxes = MeshAxes()):
    h = act_fn(act)(x @ p["w_in"] + p["b_in"])
    h = axes.constrain(h, axes.batch(h.shape[0]), None, axes.tp)
    return row_parallel(h, p["w_out"], axes) + p["b_out"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def init_moe(store: ParamStore, d_model: int, moe_cfg,
             axes: MeshAxes = MeshAxes()):
    E, ffe = moe_cfg.num_experts, moe_cfg.d_ff_expert
    store.add("router", (d_model, E), (axes.fsdp, None), scale=0.02)
    store.add("we_gate", (E, d_model, ffe), (None, axes.fsdp, axes.tp))
    store.add("we_up", (E, d_model, ffe), (None, axes.fsdp, axes.tp))
    store.add("we_down", (E, ffe, d_model), (None, axes.tp, axes.fsdp))
    if moe_cfg.num_shared:
        # shared experts act as one dense MLP of width num_shared * ffe
        init_mlp(store.subtree("shared"), d_model, moe_cfg.num_shared * ffe,
                 axes)


def moe_capacity(n_tokens: int, moe_cfg) -> int:
    c = int(n_tokens * moe_cfg.top_k / moe_cfg.num_experts
            * moe_cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p, xt, moe_cfg):
    """Router of ``xt`` [T, D]: (probs [T, E] float32, top_w [T, k]
    normalised to sum 1, top_e [T, k] int64), the k largest probabilities
    in descending order, the lower expert index first among equals."""
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    return (probs,) + top_k(probs, moe_cfg)


def top_k(probs, moe_cfg):
    """(top_w normalised, top_e) of router probabilities [T, E]."""
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = srt[:, :moe_cfg.top_k], idx[:, :moe_cfg.top_k]
    return top_w / top_w.sum(dim=-1, keepdim=True), top_e


def combine(contrib, slot_of, T: int, k: int):
    """y [T, D] = each token's k rows of ``contrib`` [T*k, D] added in a
    fixed order, in ``contrib.dtype``: ``slot_of`` [T, k] holds the rows
    of token t in the order they are added (the reference's scatter-add
    order), starting from the first (0 + c == c)."""
    parts = contrib[slot_of.reshape(-1)].reshape(T, k, -1)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def apply_moe(p, x, moe_cfg, act: str, dispatch: str = "sort",
              axes: MeshAxes = MeshAxes()):
    """x: [B, S, D] -> ([B, S, D], aux).

    dispatch="sort": one global stable argsort by expert id.
    dispatch="onehot": GShard-style positions by a per-expert cumsum
    (for numerical cross-checks).  dispatch="sharded": the reference's
    shard-local dispatch, ``dp_size`` shards under a mesh (one without,
    where it equals "sort").  ``aux`` is the Switch load-balance loss
    E * sum_e f_e * p_e (serving discards it)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, "
                         f"got {dispatch!r}")
    if axes.mesh is not None:
        return _apply_moe_mesh(p, x, moe_cfg, act, dispatch, axes)
    B, S, D = x.shape
    E = moe_cfg.num_experts
    xt = x.reshape(B * S, D)
    y, probs, top_e = _dispatch(p, xt, moe_cfg, act, dispatch)

    if moe_cfg.num_shared:
        y = y + apply_mlp(p["shared"], xt, act)

    # auxiliary load-balance loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    first = torch.zeros_like(probs).scatter_(1, top_e[:, :1], 1.0)
    aux = E * torch.sum(me * first.mean(dim=0))
    return y.reshape(B, S, D), aux


def _dispatch(p, xt, moe_cfg, act: str, dispatch: str, probs=None):
    """The routed experts of ``xt`` [T, D] at capacity ``moe_capacity(T)``
    -> (y [T, D], probs [T, E], top_e [T, k]); ``probs``, when given, are
    the router's probabilities of ``xt``."""
    T, D = xt.shape
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    dev = xt.device
    if probs is None:
        probs, top_w, top_e = route(p, xt, moe_cfg)
    else:
        top_w, top_e = top_k(probs, moe_cfg)
    C = moe_capacity(T, moe_cfg)
    flat_e = top_e.reshape(-1)                         # [T*k]
    ar = torch.arange(T * k, device=dev)

    if dispatch == "onehot":
        onehot = (flat_e[:, None] == torch.arange(E, device=dev)).long()
        pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
        order = ar                     # assignments in token-major order
        e = flat_e
    else:
        order = torch.argsort(flat_e, stable=True)
        e = flat_e[order]
        pos = ar - torch.searchsorted(e, e, side="left")  # rank in expert
    keep = pos < C
    dest = torch.where(keep, e * C + pos, E * C)       # E*C: overflow row
    tok_idx = torch.div(ar, k, rounding_mode="floor")[order]
    buf = xt.new_zeros((E * C + 1, D))
    buf.index_copy_(0, dest, xt[tok_idx])

    xb = buf[:E * C].reshape(E, C, D)
    h = act_fn(act)(torch.bmm(xb, p["we_gate"])) \
        * torch.bmm(xb, p["we_up"])
    yb = torch.bmm(h, p["we_down"]).reshape(E * C, D)

    y_flat = torch.where(keep[:, None], yb[dest.clamp(max=E * C - 1)], 0.0)
    w = top_w.reshape(-1)[order][:, None].to(xt.dtype)
    contrib = (y_flat * w).to(xt.dtype)                # assignment order
    if dispatch == "onehot":
        # the reference adds in token-major order: a token's top-k order
        slot_of = ar.reshape(T, k)
    else:
        # the reference adds in sorted order: a token's experts ascending.
        # inv[a] = where assignment a (token-major) sits in the sorted
        # order; a token's k sorted positions, ascending, are its rows in
        # ascending expert order
        inv = torch.empty_like(order)
        inv[order] = ar
        slot_of = torch.sort(inv.reshape(T, k), dim=-1).values
    return combine(contrib, slot_of, T, k), probs, top_e


def _apply_moe_mesh(p, x, moe_cfg, act: str, dispatch: str,
                    axes: MeshAxes):
    """``apply_moe`` over a mesh: each rank dispatches its own token
    shard (``dp_size`` shards for "sharded", the whole batch on every
    rank for "sort" / "onehot", the reference's global dispatch) through
    ``_dispatch`` under ``local_map``.  The router's probabilities come
    in from the DTensor pass (so the load-balance loss differentiates
    there); the expert weights arrive gathered over fsdp and sharded on
    tp along d_ff, so each rank's expert outputs are a partial sum over
    tp (the combine is linear).  The gradients leave as they arise: a
    partial sum over tp for the tokens and probabilities, and over the
    token shards for the expert weights."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    T, E = B * S, moe_cfg.num_experts
    n_sh = axes.dp_size if dispatch == "sharded" else 1
    if T % n_sh:
        raise ValueError(f"apply_moe: {T} tokens do not split into "
                         f"{n_sh} shards")
    tok = axes.dp if n_sh > 1 else None
    names = axes.mesh.mesh_dim_names

    def partial(pl, *axis_names):
        for a in axis_names:
            pl[names.index(a)] = Partial()
        return pl

    shard_axes = tuple(axes.dp) if tok else ()
    xt = axes.constrain(x.reshape(T, D), tok, None)
    probs = axes.constrain(
        torch.softmax((xt @ p["router"]).float(), dim=-1), tok, None)
    tok_pl = axes.placements(2, tok, None)
    w_in = (axes.placements(3, None, None, axes.tp),
            axes.placements(3, None, None, axes.tp),
            axes.placements(3, None, axes.tp, None))

    def local(xl, pr, wg, wu, wd):
        pl = {"we_gate": wg, "we_up": wu, "we_down": wd}
        y, _, top_e = _dispatch(pl, xl, moe_cfg, act, dispatch, probs=pr)
        first = torch.zeros_like(pr).scatter_(1, top_e[:, :1], 1.0)
        return y, first.mean(dim=0)[None]

    fn = local_map(
        local, out_placements=(partial(list(tok_pl), axes.tp), tok_pl),
        in_placements=(tok_pl, tok_pl) + w_in,
        in_grad_placements=(partial(list(tok_pl), axes.tp),
                            partial(list(tok_pl), axes.tp))
        + tuple(partial(list(w), *shard_axes) for w in w_in),
        device_mesh=axes.mesh, redistribute_inputs=True)
    y, ce = fn(xt, probs, p["we_gate"], p["we_up"], p["we_down"])
    if moe_cfg.num_shared:
        y = y + apply_mlp(p["shared"], xt, act, axes)
    # the Switch loss over all T tokens: the shards are equal, so the
    # mean of the shard means is the mean
    aux = E * torch.sum(probs.mean(dim=0) * ce.mean(dim=0).detach())
    return y.reshape(B, S, D), aux
