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
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ParamStore, act_fn

DISPATCHES = ("sort", "onehot", "sharded")


# ---------------------------------------------------------------------------
# Dense gated MLP (swiglu / geglu)
# ---------------------------------------------------------------------------


def init_mlp(store: ParamStore, d_model: int, d_ff: int):
    store.add("w_gate", (d_model, d_ff))
    store.add("w_up", (d_model, d_ff))
    store.add("w_down", (d_ff, d_model))


def apply_mlp(p, x, act: str):
    h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def init_mlp_nonglu(store: ParamStore, d_model: int, d_ff: int):
    store.add("w_in", (d_model, d_ff))
    store.add("b_in", (d_ff,), zeros=True)
    store.add("w_out", (d_ff, d_model))
    store.add("b_out", (d_model,), zeros=True)


def apply_mlp_nonglu(p, x, act: str):
    h = act_fn(act)(x @ p["w_in"] + p["b_in"])
    return h @ p["w_out"] + p["b_out"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def init_moe(store: ParamStore, d_model: int, moe_cfg):
    E, ffe = moe_cfg.num_experts, moe_cfg.d_ff_expert
    store.add("router", (d_model, E), scale=0.02)
    store.add("we_gate", (E, d_model, ffe))
    store.add("we_up", (E, d_model, ffe))
    store.add("we_down", (E, ffe, d_model))
    if moe_cfg.num_shared:
        # shared experts act as one dense MLP of width num_shared * ffe
        init_mlp(store.subtree("shared"), d_model, moe_cfg.num_shared * ffe)


def moe_capacity(n_tokens: int, moe_cfg) -> int:
    c = int(n_tokens * moe_cfg.top_k / moe_cfg.num_experts
            * moe_cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p, xt, moe_cfg):
    """Router of ``xt`` [T, D]: (probs [T, E] float32, top_w [T, k]
    normalised to sum 1, top_e [T, k] int64), the k largest probabilities
    in descending order, the lower expert index first among equals."""
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = srt[:, :moe_cfg.top_k], idx[:, :moe_cfg.top_k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_e


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


def apply_moe(p, x, moe_cfg, act: str, dispatch: str = "sort"):
    """x: [B, S, D] -> ([B, S, D], aux).

    dispatch="sort": one global stable argsort by expert id.
    dispatch="onehot": GShard-style positions by a per-expert cumsum
    (for numerical cross-checks).  dispatch="sharded": the reference's
    shard-local dispatch; one device is one shard (the reference's
    ``n_sh = 1`` without a mesh), where it equals "sort".  ``aux`` is the
    Switch load-balance loss E * sum_e f_e * p_e (serving discards it)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, "
                         f"got {dispatch!r}")
    B, S, D = x.shape
    T = B * S
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    dev = x.device
    xt = x.reshape(T, D)
    probs, top_w, top_e = route(p, xt, moe_cfg)
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
    buf = x.new_zeros((E * C + 1, D))
    buf.index_copy_(0, dest, xt[tok_idx])

    xb = buf[:E * C].reshape(E, C, D)
    h = act_fn(act)(torch.bmm(xb, p["we_gate"])) \
        * torch.bmm(xb, p["we_up"])
    yb = torch.bmm(h, p["we_down"]).reshape(E * C, D)

    y_flat = torch.where(keep[:, None], yb[dest.clamp(max=E * C - 1)], 0.0)
    w = top_w.reshape(-1)[order][:, None].to(x.dtype)
    contrib = (y_flat * w).to(x.dtype)                 # assignment order
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
    y = combine(contrib, slot_of, T, k)

    if moe_cfg.num_shared:
        y = y + apply_mlp(p["shared"], xt, act)

    # auxiliary load-balance loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    first = torch.zeros_like(probs).scatter_(1, top_e[:, :1], 1.0)
    aux = E * torch.sum(me * first.mean(dim=0))
    return y.reshape(B, S, D), aux
