"""Mamba-2 SSD (state-space duality) block of the port
(``repro.models.ssm``'s counterpart).

The train / prefill branch is the chunked SSD algorithm of
arXiv:2405.21060: the quadratic intra-chunk part as dense products, the
inter-chunk part a recurrence over S / Q chunk states (a Python loop:
two chunks at a 512-token prefill).  Decode is the O(1)-state recurrent
step.  The naive per-step recurrence is ``kernels/ref.ssd_scan_ref``, the
oracle.  No Pallas kernel computes any of it in the reference: the
products stay ``torch.einsum`` / ``matmul``.

Layouts are the reference's: x [b,s,h,p], dt [b,s,h], A [h], B / C
[b,s,n]; states [b,h,p,n] in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import MeshAxes, ParamStore, row_parallel


def init_ssm(store: ParamStore, cfg, axes: MeshAxes = MeshAxes()):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n
    store.add("w_in_zx", (d, 2 * d_in), (axes.fsdp, axes.tp))
    store.add("w_in_bc", (d, 2 * n), (axes.fsdp, None))
    store.add("w_in_dt", (d, nh), (axes.fsdp, None))
    store.add("conv_w", (cfg.conv_kernel, conv_dim), (None, None), scale=0.5)
    store.add("conv_b", (conv_dim,), (None,), zeros=True)
    # float32 whatever the store's dtype, as in the reference
    store.add("A_log", (nh,), (None,), scale=0.0, dtype=torch.float32)
    store.add("dt_bias", (nh,), (None,), zeros=True, dtype=torch.float32)
    store.add("D", (nh,), (None,), zeros=True, dtype=torch.float32)
    store.add("norm_scale", (d_in,), (axes.tp,), zeros=True)
    store.add("w_out", (d_in, d), (axes.tp, axes.fsdp))


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv of width K.  u [B,S,C]; w [K,C]; state
    [B,K-1,C], the trailing context (zeros when None).  Returns (y,
    new_state), new_state the last K-1 steps of [state, u]."""
    K, S = w.shape[0], u.shape[1]
    if state is None:
        pad = u.new_zeros(u.shape[:1] + (K - 1,) + u.shape[2:])
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    y = sum(full[:, i:i + S] * w[i].to(u.dtype) for i in range(K))
    return y + b.to(u.dtype), full[:, full.shape[1] - (K - 1):]


def _segsum(a):
    """a [..., Q] -> [..., Q, Q]: the lower-triangular pairwise sums
    a[j+1..i], -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD scan.  x [b,s,h,p], dt [b,s,h], A [h], B / C [b,s,n] ->
    (y [b,s,h,p], final_state [b,h,p,n]); s a multiple of the chunk."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    if s % Q:
        raise ValueError(f"ssd_chunked: seq {s} not divisible by chunk {Q}")
    nc = s // Q

    dA = (dt * A).reshape(b, nc, Q, h)         # negative log-decay a step
    xs = (x * dt[..., None]).reshape(b, nc, Q, h, p)
    Bc = B.reshape(b, nc, Q, n)
    Cc = C.reshape(b, nc, Q, n)
    dA_cs = torch.cumsum(dA, dim=2)            # [b,nc,Q,h]

    # 1. intra-chunk (diagonal blocks): quadratic in Q
    L = torch.exp(_segsum(dA.movedim(3, 2)))   # [b,nc,h,Q,Q]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bcqk,bchqk,bckhp->bcqhp", scores,
                          L.to(scores.dtype), xs)

    # 2. each chunk's end state
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc,
                          decay_to_end.to(Bc.dtype), xs)

    # 3. the inter-chunk recurrence over nc chunks; prev[c] is the state
    #    entering chunk c
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # [b,nc,h]
    carry = x.new_zeros((b, h, p, n)) if init_state is None \
        else init_state.to(x.dtype)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None].to(carry.dtype) \
            + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # [b,nc,h,p,n]

    # 4. the inter-chunk contribution
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, prev_states,
                         torch.exp(dA_cs).to(Cc.dtype))
    return (y_diag + y_off).reshape(b, s, h, p), carry


def _ssd(x, dt, A, B, C, chunk: int, init_state, axes: MeshAxes):
    """``ssd_chunked``; under a mesh per rank (``local_map``) on its batch
    rows (dp) and heads (tp, where it divides them), B and C whole on
    every tp rank: the scan is independent per (batch row, head)."""
    if axes.mesh is None:
        return ssd_chunked(x, dt, A, B, C, chunk, init_state)
    from torch.distributed.tensor.experimental import local_map
    b, h = axes.batch(x.shape[0]), \
        axes.tp if x.shape[2] % axes.tp_size == 0 else None
    x_pl = axes.placements(4, b, None, h, None)
    st_pl = axes.placements(4, b, h, None, None)
    pl = [x_pl, axes.placements(3, b, None, h), axes.placements(1, h),
          axes.placements(3, b), axes.placements(3, b)]
    args = [x, dt, A, B, C]
    if init_state is not None:
        pl.append(st_pl)
        args.append(init_state)

    def local(x_, dt_, A_, B_, C_, st=None):
        return ssd_chunked(x_, dt_, A_, B_, C_, chunk, st)
    return local_map(local, out_placements=(x_pl, st_pl),
                     in_placements=tuple(pl), device_mesh=axes.mesh,
                     redistribute_inputs=True)(*args)


def _pad_steps(a, pad: int):
    """``a`` [B,S,...] with ``pad`` zero steps appended on axis 1."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                     dim=1)


def apply_ssm(p, x, cfg, conv_state=None, ssd_state=None,
              decode: bool = False, axes: MeshAxes = MeshAxes()):
    """Mamba-2 block.  x [B,S,D] -> (out [B,S,D], (conv_state,
    ssd_state)); the states are new tensors (the caller writes them into
    its cache).  Under a mesh the conv and the scan run on DTensors with
    the sequence whole on every rank (the reference's constraint puts
    the batch on dp and the inner width on tp), so the chunk cumsums and
    the carry loop stay shard-local."""
    B_, S, D = x.shape
    d_in = cfg.ssm_expand * D
    hd = cfg.ssm_head_dim
    nh = d_in // hd
    n = cfg.ssm_state

    z, xin = torch.split(x @ p["w_in_zx"], d_in, dim=-1)
    bc = x @ p["w_in_bc"]
    dt = F.softplus((x @ p["w_in_dt"]).float() + p["dt_bias"])

    u = torch.cat([xin, bc], dim=-1)
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    u = F.silu(u)
    xin, Bmat, Cmat = torch.split(u, [d_in, n, n], dim=-1)
    xin = axes.constrain(xin, axes.batch(B_), None, axes.tp)

    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B_, S, nh, hd).float()
    Bf, Cf = Bmat.float(), Cmat.float()

    if decode:
        # one step: state <- exp(dt A) state + dt B (x) x
        st = x.new_zeros((B_, nh, hd, n), dtype=torch.float32) \
            if ssd_state is None else ssd_state
        dA = torch.exp(dt[:, 0] * A)                        # [B,h]
        upd = torch.einsum("bn,bh,bhp->bhpn", Bf[:, 0], dt[:, 0], xh[:, 0])
        new_state = st * dA[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cf[:, 0], new_state)[:, None]
    else:
        # pad S to a whole chunk; the padded steps carry dt = 0 (no
        # decay, no input), so the final state stays exact
        Q = min(cfg.ssm_chunk, max(S, 1))
        pad = (-S) % Q
        xp, Bp, Cp, dtp = xh, Bf, Cf, dt
        if pad:
            xp, Bp, Cp, dtp = (_pad_steps(a, pad) for a in (xh, Bf, Cf, dt))
        y, new_state = _ssd(xp, dtp, A, Bp, Cp, Q, ssd_state, axes)
        y = y[:, :S]
    y = y + xh * p["D"][:, None]
    y = y.reshape(B_, S, d_in).to(x.dtype)

    # gated RMSNorm, then the out-projection
    gf = (y * F.silu(z)).float()
    gf = gf * torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + 1e-6)
    g = (gf * (1.0 + p["norm_scale"].float())).to(x.dtype)
    return row_parallel(g, p["w_out"], axes), (new_conv, new_state)
