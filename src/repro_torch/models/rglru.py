"""Griffin / RecurrentGemma RG-LRU recurrent block of the port
(``repro.models.rglru``'s counterpart, arXiv:2402.19427).

The gated linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  r, i input-dependent gates,

runs in prefill as a log-step scan (``_lru_scan``: ceil(log2 S) shifted
multiply-adds over the whole sequence, where the reference takes
``jax.lax.associative_scan``) and in decode as one step on an O(d) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (MeshAxes, ParamStore, _gelu_tanh,
                                       row_parallel)
from repro_torch.models.ssm import _causal_conv

_C = 8.0
_N_BLOCKS = 16      # block-diagonal gate projections, as Griffin's


def init_rglru(store: ParamStore, cfg, axes: MeshAxes = MeshAxes()):
    d = cfg.d_model
    dr = d          # lru width = d_model in recurrentgemma-2b
    nb = _N_BLOCKS if dr % _N_BLOCKS == 0 else 1
    c = dr // nb
    store.add("w_x", (d, dr), (axes.fsdp, axes.tp))
    store.add("w_gate", (d, dr), (axes.fsdp, axes.tp))
    store.add("conv_w", (cfg.conv_kernel, dr), (None, axes.tp), scale=0.5)
    store.add("conv_b", (dr,), (axes.tp,), zeros=True)
    store.add("w_a_gate", (nb, c, c), (axes.tp, None, None), scale=0.02)
    store.add("b_a_gate", (dr,), (axes.tp,), zeros=True)
    store.add("w_i_gate", (nb, c, c), (axes.tp, None, None), scale=0.02)
    store.add("b_i_gate", (dr,), (axes.tp,), zeros=True)
    store.add("lam", (dr,), (axes.tp,), scale=1.0, dtype=torch.float32)
    store.add("w_out", (dr, d), (axes.tp, axes.fsdp))


def _block_linear(x, w):
    """x [B,S,dr], w [nb,c,c] block-diagonal -> [B,S,dr]."""
    B, S, dr = x.shape
    nb, c, _ = w.shape
    return torch.einsum("bsnc,nck->bsnk", x.reshape(B, S, nb, c),
                        w).reshape(B, S, dr)


def _lru_scan(a, u):
    """h_t = a_t h_{t-1} + u_t from h_{-1} = 0; a, u [B,S,C] float32.

    Hillis-Steele: at shift d every step t >= d folds in step t - d,
    (a, u)_t <- (a_{t-d} a_t, u_{t-d} a_t + u_t), so after the shifts
    1, 2, 4, ... < S each step has folded in all before it."""
    S = a.shape[1]
    d = 1
    while d < S:
        u = torch.cat([u[:, :d], torch.addcmul(u[:, d:], a[:, d:],
                                                u[:, :-d])], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u


def apply_rglru(p, x, cfg, conv_state=None, h_state=None,
                decode: bool = False, axes: MeshAxes = MeshAxes()):
    """x [B,S,D] -> (out [B,S,D], (conv_state, h_state)); the states are
    new tensors (the caller writes them into its cache).  Under a mesh
    the width rides tp and the batch dp (the reference's constraint);
    the sequence is whole on every rank, so the log-step scan's shifted
    slices and concatenations stay shard-local."""
    xb = x @ p["w_x"]
    gate = _gelu_tanh(x @ p["w_gate"])      # jax.nn.gelu: tanh form
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    xb = axes.constrain(xb, axes.batch(xb.shape[0]), None, axes.tp)

    xf = xb.float()
    r = torch.sigmoid(_block_linear(xf, p["w_a_gate"].float())
                      + p["b_a_gate"].float())
    i = torch.sigmoid(_block_linear(xf, p["w_i_gate"].float())
                      + p["b_i_gate"].float())
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)           # [B,S,C]
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)

    if decode:
        h0 = torch.zeros_like(gated_in[:, 0]) if h_state is None \
            else h_state
        new_h = a[:, 0] * h0 + gated_in[:, 0]
        y = new_h[:, None]
    else:
        if h_state is not None:
            first = gated_in[:, :1] + a[:, :1] * h_state[:, None]
            gated_in = torch.cat([first, gated_in[:, 1:]], dim=1)
        y = _lru_scan(a, gated_in)
        new_h = y[:, -1]
    out = row_parallel(y.to(x.dtype) * gate, p["w_out"], axes)
    return out, (new_conv, new_h)
