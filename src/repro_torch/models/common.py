"""Shared model infrastructure of the port: parameter init, norms, RoPE,
and the prefill and decode attention.

The port of ``repro.models.common``.  Layouts are the JAX package's at
every public function (``q [B,S,H,D]``, ``k/v [B,S,KV,D]``) so the tests
compare like with like.  ``MeshAxes`` (sharding) is not ported.

Prefill attention (``block_attention``) goes through the hand-written
flash-attention kernel (``kernels/flash_attention.py``) or, with
``kernels="torch"``, its plain version.  Decode attention is plain torch,
as the reference computes it in XLA outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

# decode_attention's mask value (the reference's -0.7 * float32 max)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


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
    reproduce ``jax.random``."""

    def __init__(self, generator: torch.Generator, device,
                 dtype=torch.bfloat16, stack: int = 0):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.stack = stack
        self.params: dict = {}

    def add(self, name: str, shape, *, scale: float = None,
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
        return val

    def subtree(self, name: str) -> "ParamStore":
        sub = ParamStore(self.generator, self.device, self.dtype, self.stack)
        sub.params = self.params.setdefault(name, {})
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


def block_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
                    kernels: str = "hopper"):
    """Prefill attention. q [B,Sq,H,D]; k, v [B,Sk,KV,D] (KV divides H)
    -> [B,Sq,H,D].

    Query i sits at position q_offset + i, which must be Sk - Sq (always
    so in prefill) when the call is causal or windowed; a call that is
    neither (an encoder's, a cross sublayer's) sees every key, so its
    query positions do not matter.  ``window`` > 0 keeps keys fewer than
    ``window`` positions back.  ``kernels="hopper"`` runs the
    flash-attention kernel (its plain version on CPU tensors), which has
    no backward and raises on inputs that require grad under grad mode;
    ``"torch"`` the plain version, which autograd differentiates."""
    Sq, Sk = q.shape[1], k.shape[1]
    if (causal or window > 0) and int(q_offset) != Sk - Sq:
        raise ValueError(f"block_attention: q_offset {q_offset} != Sk - Sq "
                         f"= {Sk - Sq}; the kernel places query i at "
                         f"i + Sk - Sq")
    if kernels == "hopper":
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    if kernels == "torch":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    raise ValueError(f"kernels must be 'hopper' or 'torch', got {kernels!r}")


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *,
                     window: int = 0):
    """Single-token attention against a (possibly ring-buffered) cache.

    q [B,1,H,D]; k_cache / v_cache [B,W,KV,D]; kv_positions [B,W] the
    absolute position of each slot (-1 = empty); pos [B] the query's
    position.  GQA stays folded (q as [B,1,KV,G,D]), so the repeated KV
    never materialises.  Scores in float32; the probabilities are rounded
    to the cache's dtype before the value sum, as in the reference."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, 1, KV, G, D).float()
    s = torch.einsum("bqkgd,bwkd->bqkgw", qf, k_cache.float()) * scale
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window > 0:
        ok &= (pos[:, None] - kv_positions) < window
    s = s.masked_fill(~ok[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bqkgw,bwkd->bqkgd", p.float(), v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
