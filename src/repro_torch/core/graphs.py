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
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class Graph:
    """One captured body.  ``replay`` enqueues it on the current stream
    and counts the kernel launches it holds."""
    graph: torch.cuda.CUDAGraph
    record: kernels.LaunchRecord

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.record)

    def reset(self) -> None:
        self.graph.reset()
        self.record.held.clear()


def capture(body, pool) -> Graph:
    """Capture ``body`` on the current (non-default) stream into a graph
    drawing its temporaries from ``pool``.  Raises if the capture fails:
    nothing falls back to eager."""
    graph = torch.cuda.CUDAGraph()
    with kernels.recording() as record:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
    return Graph(graph, record)


def pool_bytes(pool) -> int:
    """Device bytes that the caching allocator holds for a graph pool."""
    want = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == want)
