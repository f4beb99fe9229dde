"""Flash attention (causal, sliding-window or full, GQA): the LM server's
prefill attention, every attention and cross layer of every admission
(and every encoder layer of an encoder-decoder's).

The kernels are in ``csrc/flash_attention.cu`` (they replace the JAX
package's ``repro/kernels/flash_attention.py::flash_attention_pallas``).
``route`` picks one from the dtype and the head dim alone:

- ``"wgmma"`` (bfloat16, D 64 / 128 / 256, every LM config the port
  serves): ``flash_attention_wgmma_kernel``, both products on the tensor
  cores (wgmma), K / V in a TMA-fed ring of shared-memory stages; one
  block per (batch x head, 128-query tile; 64-query at D 256, ``tiles``)
  over 64-key tiles, P rounded to bfloat16 for P.V.
- ``"simt"`` (float32 at any D, bfloat16 at D 16 / 32):
  ``flash_attention_simt_kernel``, float32 multiply-adds on the CUDA
  cores; one block per (batch x head, 64-query tile) over 64-key tiles.

Both loop over the key tiles that the query tile's causal or window range
reaches (``key_tile_range``, with the route's ``tiles``), with the online
softmax's running max, sum and accumulator in float32.  Unlike the TPU
kernel they take any ``Sq`` / ``Sk`` (ragged tails are masked) and skip
key tiles that no row of the query tile can see, as the model's
``block_attention`` does.  A route's kernel that fails to build or
launch raises; the other route is never tried instead.

The checks (``check_args``) hold on every device, so the CPU tests see
the kernel's contract.  The wrapper then calls the custom operator
``torch.ops.repro_torch.flash_attention`` through the dispatcher: its CPU
implementation is the plain version (``ref.flash_attention_ref``), its
CUDA one launches the kernel, and its fake one gives the output's shape.
Going through the dispatcher is what lets a mesh run it: under
``local_map`` (``models/common.block_attention``) each rank's local
tensors reach the operator, and under ``LocalTensorMode`` each simulated
rank's call launches the kernel on that rank's heads (and counts).
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

# (query tile, key tile) of each route: kBlockQ / kBlockK and
# WgSmem<D>::kBlockQ / kWgBlockK in csrc/flash_attention.cu; the
# tensor-core route's at D 256 is WGMMA_D256_TILES (``tiles``)
TILES = {"simt": (64, 64), "wgmma": (128, 64)}
WGMMA_D256_TILES = (64, 64)
WGMMA_HEAD_DIMS = (64, 128, 256)
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GRID_Y = 65535         # simt: B * H rides gridDim.y


def route(dtype, D: int) -> str:
    """The kernel that a call of this dtype and head dim runs: "wgmma"
    for bfloat16 at D 64 / 128 / 256, else "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS \
        else "simt"


def tiles(kind: str, D: int) -> tuple:
    """(query tile, key tile) of route ``kind`` at head dim ``D``."""
    return WGMMA_D256_TILES if kind == "wgmma" and D == 256 else TILES[kind]


def q_tiles(Sq: int, block_q: int) -> int:
    """Query tiles (of ``block_q`` rows, the route's ``TILES[0]``) of the
    launch grid."""
    return -(-Sq // block_q)


def kv_head(h: int, H: int, KV: int) -> int:
    """The kv head that query head ``h`` reads (GQA groups of H/KV)."""
    return h // (H // KV)


def key_tile_range(qt: int, Sq: int, Sk: int, causal: bool, window: int,
                   block_q: int, block_k: int) -> tuple:
    """[lo, hi) of the key tiles (of ``block_k`` keys) that query tile
    ``qt`` (of ``block_q`` rows) visits; the route's ``TILES`` give both.

    Query i sits at position i + Sk - Sq.  A causal tile stops at its
    last row's position, a window tile starts ``window - 1`` before its
    first row's.  A causal tile holding a row at a negative position (a
    row that sees no key) visits every tile: that row averages all of v,
    as the reference does."""
    off = Sk - Sq
    n_k = -(-Sk // block_k)
    p0 = qt * block_q + off
    p1 = min(qt * block_q + block_q, Sq) - 1 + off
    if causal and p0 < 0:
        return 0, n_k
    hi = min(Sk, p1 + 1) if causal else Sk
    lo = max(0, p0 - window + 1) if window > 0 else 0
    return lo // block_k, -(-hi // block_k)


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
    """q [B,Sq,H,D]; k, v [B,Sk,KV,D] -> [B,Sq,H,D] in q's dtype.

    Forward only: the kernel has no backward (nor has the reference's),
    so inputs that require grad under grad mode raise RuntimeError, on
    the CPU too, rather than return an output cut off from the graph;
    differentiate the plain version (``kernels="torch"``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: its inputs require grad "
            "under grad mode; differentiate the plain attention "
            "(block_attention(kernels='torch'), as loss_fn does)")
    check_args(q, k, v)
    return flash_attention_op(q, k, v, bool(causal), int(window))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """The operator (``check_args`` is the wrapper's); on the CPU the
    plain version, contiguous like the kernel's output."""
    return ref.flash_attention_ref(q, k, v, causal=causal,
                                   window=window).contiguous()


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window):
    return torch.empty_like(q)


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, window):
    """The operator on the card: launches the route's kernel."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kind = route(q.dtype, D)
    n_q = q_tiles(Sq, tiles(kind, D)[0])
    out = torch.empty_like(q)
    if kind == "wgmma":
        # TMA reads whole 16-byte units from each tensor's base
        for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 f"aligned")
        code = _k.library().shareddb_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, D, int(bool(causal)), int(window),
            n_q, _k.stream_of(q))
    else:
        code = _k.library().shareddb_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, D, int(bool(causal)), int(window),
            int(q.dtype == torch.bfloat16), n_q, _k.stream_of(q))
    _k.count_launch("flash_attention", kind)
    _k.check_launch(code, f"flash_attention ({kind})")
    return out
