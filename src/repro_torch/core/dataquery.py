"""The data-query model (paper §3.1) on PyTorch tensors.

Every (intermediate) relation carries a *query-set* column: the set of
active query ids interested in each tuple, packed 32 queries to a word —
``mask[t, w]`` holds bits for queries 32w..32w+31, bit ``b`` of word ``w``
is query ``32w+b``.

The words are held as **int32 bit patterns**, not uint32: PyTorch's CPU
kernels lack ``>>`` for uint32, and the bit algebra (``&``, ``|``, ``~``,
masked shifts) is identical on the two's-complement pattern.  Compare a
word tensor with the JAX package's uint32 words through
``words.numpy().view(np.uint32)``.

Set algebra is bitwise:
    union        = mask_a | mask_b
    intersection = mask_a & mask_b        <- the query_id join predicate!
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device

WORD = 32


def mask_width(qcap: int) -> int:
    if qcap % WORD != 0:
        raise ValueError(
            f"[planlint:no-bare-assert] query capacity {qcap} is not "
            f"a multiple of {WORD}")
    return qcap // WORD


def empty_mask(n_rows: int, qcap: int, device=None):
    """int32 words [n_rows, W], no query set (``device=None``: the card)."""
    return torch.zeros((n_rows, mask_width(qcap)), dtype=torch.int32,
                       device=resolve_device(device))


def full_mask(n_rows: int, qcap: int, device=None):
    """int32 words [n_rows, W], every query set: the pattern 0xFFFFFFFF,
    which is -1 in int32 (``device=None``: the card)."""
    return torch.full((n_rows, mask_width(qcap)), -1, dtype=torch.int32,
                      device=resolve_device(device))


def wrap_i32(x):
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack(bits):
    """bool[..., Q] -> int32 words [..., Q/32]."""
    *lead, Q = bits.shape
    W = mask_width(Q)
    b = bits.reshape(*lead, W, WORD).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) \
        << torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return wrap_i32((b * weights).sum(-1))


def unpack(mask, qcap: int = None):
    """int32 words [..., W] -> bool[..., W*32]."""
    *lead, W = mask.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=mask.device)
    bits = (mask.to(torch.int32)[..., None] >> shifts) & 1
    out = bits.reshape(*lead, W * WORD).bool()
    if qcap is not None:
        out = out[..., :qcap]
    return out


def union(a, b):
    return a | b


def intersect(a, b):
    return a & b


def any_query(mask):
    """bool[T]: does any active query want this tuple?"""
    return (mask != 0).any(dim=-1)


def popcount(mask):
    """int32[T]: number of subscribed queries per tuple."""
    return unpack(mask).sum(-1).to(torch.int32)


def query_bit(qid, qcap: int, device=None):
    """int32[W] single-query mask row (``qid`` an int or a 0-d tensor)."""
    W = mask_width(qcap)
    qid = torch.as_tensor(qid, dtype=torch.int64, device=device)
    word = qid // WORD
    bit = wrap_i32(torch.ones((), dtype=torch.int64, device=qid.device)
                   << (qid % WORD))
    return torch.where(torch.arange(W, device=qid.device) == word, bit,
                       torch.zeros((), dtype=torch.int32,
                                   device=qid.device))


def select_query(mask, qid):
    """bool[T]: rows subscribed to query ``qid`` — a Python int, or a 0-d
    tensor whose word is gathered on its device with no host read."""
    if isinstance(qid, torch.Tensor):
        qid = qid.to(device=mask.device, dtype=torch.int64)
        w = torch.index_select(mask, -1, (qid // WORD).reshape(1))[..., 0]
    else:
        w = mask[..., qid // WORD]
    return ((w.to(torch.int32) >> (qid % WORD)) & 1).bool()
