"""Flash attention (causal / sliding-window, GQA): the LM server's prefill
attention, every layer of every admission.

The kernel is ``csrc/flash_attention.cu`` (it replaces the JAX package's
``repro/kernels/flash_attention.py::flash_attention_pallas``): one thread
block per (batch x head, 64-query tile) loops over the 64-key tiles that
the tile's causal or window range reaches (``key_tile_range``), with the
online softmax's running max, sum and accumulator in float32.  Unlike the
TPU kernel it takes any ``Sq`` / ``Sk`` (ragged tails are masked) and it
skips key tiles that no row of the query tile can see, as the model's
``block_attention`` does.

The checks (``check_args``) hold on every device, so the CPU tests see
the kernel's contract; on CPU tensors the wrapper then computes the plain
version (``ref.flash_attention_ref``).
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

BLOCK_Q = 64               # kBlockQ / kBlockK in csrc/flash_attention.cu
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)
MAX_GRID_Y = 65535         # B * H rides gridDim.y


def q_tiles(Sq: int) -> int:
    """Query tiles of the launch grid (its x extent)."""
    return -(-Sq // BLOCK_Q)


def kv_head(h: int, H: int, KV: int) -> int:
    """The kv head that query head ``h`` reads (GQA groups of H/KV)."""
    return h // (H // KV)


def key_tile_range(qt: int, Sq: int, Sk: int, causal: bool,
                   window: int) -> tuple:
    """[lo, hi) of the key tiles that query tile ``qt`` visits.

    Query i sits at position i + Sk - Sq.  A causal tile stops at its
    last row's position, a window tile starts ``window - 1`` before its
    first row's.  A causal tile holding a row at a negative position (a
    row that sees no key) visits every tile: that row averages all of v,
    as the reference does."""
    off = Sk - Sq
    n_k = -(-Sk // BLOCK_K)
    p0 = qt * BLOCK_Q + off
    p1 = min(qt * BLOCK_Q + BLOCK_Q, Sq) - 1 + off
    if causal and p0 < 0:
        return 0, n_k
    hi = min(Sk, p1 + 1) if causal else Sk
    lo = max(0, p0 - window + 1) if window > 0 else 0
    return lo // BLOCK_K, -(-hi // BLOCK_K)


def check_args(q, k, v) -> None:
    """The kernel's contract: q [B,Sq,H,D], k and v [B,Sk,KV,D], one
    dtype (bfloat16 or float32), one device, contiguous, KV divides H,
    D in HEAD_DIMS, no empty axis.  Raises ValueError."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         f"[B,Sq,H,D] and two equal [B,Sk,KV,D]")
    B, Sq, H, D = q.shape
    Bk, Sk, KV, Dk = k.shape
    if Bk != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}: batch and head dim must match "
                         f"and KV must divide H")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if min(B, Sq, Sk, H) < 1 or B * H > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B {B}, Sq {Sq}, Sk {Sk}, H {H}: "
                         f"want no empty axis and B*H <= {MAX_GRID_Y}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in (torch.bfloat16, torch.float32) \
                or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; want "
                             f"bfloat16 or float32, the same for q, k, v")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,D]; k, v [B,Sk,KV,D] -> [B,Sq,H,D] in q's dtype."""
    check_args(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    code = _k.library().shareddb_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, D, int(bool(causal)), int(window),
        int(q.dtype == torch.bfloat16), q_tiles(Sq), _k.stream_of(q))
    _k.LAUNCHES["flash_attention"] += 1
    _k.check_launch(code, "flash_attention")
    return out
