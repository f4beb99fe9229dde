"""The compiled beat: a step body captured as a CUDA graph, the port's
counterpart of the reference's ``jax.jit`` with donated buffers.

A body that is captured reads fixed tensors and leaves its outputs in
fixed tensors (``copy_into``): every tensor that crosses a step boundary
lives in buffers its owner allocated outside every graph pool, so each
replay reads and writes the addresses the capture saw.  ``capture``
records the body's kernel launches (``kernels.recording``) so that each
replay adds them to the counts, and keeps the cached device constants
those launches read (``kernels.hold``) alive with the graph.

A capture runs on the caller's current stream, which must not be the
default one, through ``CUDAGraph.capture_begin`` / ``capture_end`` with
``capture_error_mode="thread_local"``: ``torch.cuda.graph`` synchronises
the device and empties the cache on entry, which a fold thread must not
do while the serving thread runs beats under
``torch.cuda.set_sync_debug_mode("error")``, and the global mode would
refuse the serving thread's own CUDA calls while a capture is open.
CUDA still refuses a device-wide synchronise (``torch.cuda.
synchronize()``) from any thread while a capture is open, and the
capture breaks: callers that run beside one wait on events or streams.

Stage marks: a body calls ``mark(name)`` at its stage boundaries (the
cycle bodies of ``core/lowering.py`` and ``SharedDBEngine._body``).  A
mark records into the thread's ``MarkSink`` when one is open
(``marking``) and is a no-op otherwise.  On a card each mark records a
timing event on the current stream; opened around a capture
(``capture(..., marks=True)``), the events are ``external`` and become
event-record nodes of the graph, recorded again by every replay.  On the
CPU, where a body runs synchronously, a mark stamps ``perf_counter``.
``stage_seconds`` turns a sink's marks into seconds per stage, each
stage timed from the mark before it.

Packed trees: ``pack_layout`` places a tree's leaves in one flat byte
buffer and ``unpack`` views a buffer of that layout as the tree, so one
copy moves every leaf (the engine's results, device to pinned host).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels


def map_tree(fn, tree):
    """``fn`` on every tensor leaf of nested dicts and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def empty_like_tree(tree):
    return map_tree(torch.empty_like, tree)


def clone_tree(tree):
    return map_tree(torch.clone, tree)


def leaves(tree):
    """The tensor leaves of nested dicts and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


#: Byte alignment of each leaf in a packed buffer (``pack_layout``).
PACK_ALIGN = 16


@functools.lru_cache(maxsize=None)
def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


@dataclasses.dataclass(frozen=True)
class Span:
    """Where one leaf of a packed tree lies in its flat byte buffer."""
    offset: int
    nbytes: int
    dtype: torch.dtype
    shape: Tuple[int, ...]

    def view(self, flat):
        """The leaf in ``flat``, a byte tensor or a numpy uint8 array."""
        part = flat[self.offset:self.offset + self.nbytes]
        if isinstance(part, torch.Tensor):
            return part.view(self.dtype).view(self.shape)
        return part.view(_numpy_dtype(self.dtype)).reshape(self.shape)


def pack_layout(tree):
    """``(layout, nbytes)``: ``tree`` with each tensor leaf replaced by
    its ``Span`` in one flat byte buffer of ``nbytes``, leaves in order,
    each at a ``PACK_ALIGN``-byte boundary and no two at one address."""
    end = 0

    def place(t):
        nonlocal end
        span = Span(end, t.nbytes, t.dtype, tuple(t.shape))
        end += -(-max(t.nbytes, 1) // PACK_ALIGN) * PACK_ALIGN
        return span
    layout = map_tree(place, tree)
    return layout, end


def unpack(flat, layout):
    """The tree of contiguous views into ``flat`` (a byte tensor on a
    device or on the host, or a numpy uint8 array) that ``layout``
    places."""
    return map_tree(lambda s: s.view(flat), layout)


def copy_into(dst, src, path=()) -> None:
    """Write every leaf of ``src`` into the same leaf of ``dst`` (same
    keys, shapes and dtypes, else ValueError).  A leaf of ``src`` that
    IS ``dst``'s (updated in place) is skipped."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or sorted(dst) != sorted(src):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"copy_into {path}: keys {sorted(dst)} vs "
                             f"{got}")
        for k in dst:
            copy_into(dst[k], src[k], path + (k,))
    elif isinstance(dst, tuple):
        if not isinstance(src, tuple) or len(src) != len(dst):
            raise ValueError(f"copy_into {path}: a tuple of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            copy_into(d, s, path + (i,))
    elif dst is not src:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"copy_into {path}: {src.dtype} "
                             f"{tuple(src.shape)} into {dst.dtype} "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)


_marking = threading.local()


class MarkSink:
    """The stage marks of one body, ``(name, stamp)`` in order: a timing
    CUDA event on a card (``external`` inside a capture), a
    ``perf_counter`` on the CPU."""

    def __init__(self, device: torch.device, external: bool = False):
        self.cuda = device.type == "cuda"
        self.external = external
        self.marks: List[Tuple[str, object]] = []

    def add(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True, external=self.external)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))


@contextlib.contextmanager
def marking(sink: Optional[MarkSink]):
    """Send this thread's ``mark`` calls to ``sink`` (None: drop them)."""
    outer = getattr(_marking, "sink", None)
    _marking.sink = sink
    try:
        yield sink
    finally:
        _marking.sink = outer


def mark(name: str) -> None:
    """A stage boundary of the body being built or run; a no-op unless a
    sink is open on this thread."""
    sink = getattr(_marking, "sink", None)
    if sink is not None:
        sink.add(name)


def stage_seconds(marks) -> Dict[str, float]:
    """Seconds per stage from one body's marks, in mark order: each mark
    after the first closes the stage of its name, timed from the mark
    before it (a name met twice sums).  Events must have completed."""
    out: Dict[str, float] = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        s = b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3
        out[name] = out.get(name, 0.0) + s
    return out


@dataclasses.dataclass
class Graph:
    """One captured body.  ``replay`` enqueues it on the current stream
    and counts the kernel launches it holds; ``marks`` are its stage
    marks' events (empty unless captured with ``marks=True``), recorded
    again by each replay."""
    graph: torch.cuda.CUDAGraph
    record: kernels.LaunchRecord
    marks: List[Tuple[str, object]] = dataclasses.field(default_factory=list)

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.record)

    def reset(self) -> None:
        self.graph.reset()
        self.record.held.clear()


def capture(body, pool, marks: bool = False) -> Graph:
    """Capture ``body`` on the current (non-default) stream into a graph
    drawing its temporaries from ``pool``; with ``marks`` its stage marks
    become event-record nodes of the graph.  Raises if the capture fails:
    nothing falls back to eager."""
    graph = torch.cuda.CUDAGraph()
    sink = MarkSink(torch.device("cuda"), external=True) if marks else None
    with kernels.recording() as record, marking(sink):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
    return Graph(graph, record, sink.marks if marks else [])


def pool_bytes(pool) -> int:
    """Device bytes that the caching allocator holds for a graph pool."""
    want = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == want)
