"""Dense MLPs of the port (``repro.models.moe``'s dense half).

``init_mlp`` / ``apply_mlp`` are the gated MLP (swiglu / geglu),
``init_mlp_nonglu`` / ``apply_mlp_nonglu`` the plain one with biases.
The sort-based MoE (``apply_moe``) comes with the MoE slice (ROADMAP).
"""
from __future__ import annotations

from repro_torch.models.common import ParamStore, act_fn


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
