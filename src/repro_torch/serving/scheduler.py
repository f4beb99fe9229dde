"""SharedDB-cycle LM serving on PyTorch (``repro.serving.scheduler``'s
port).

Requests queue while a cycle runs; each heartbeat admits up to
``prefill_budget`` queued requests into free slots (one batch-1 prefill
each, right-padded to ``prefill_len``) and then runs ONE decode step for
ALL ``capacity`` slots.  Per-cycle work is a function of (capacity,
max_seq), never of the queue length, so worst-case first-token latency
is bounded by 2 cycles (the paper's §3.5 guarantee).  Idle slots still
flow through the decode step, parked at position 0.

The slot cache is updated IN PLACE: admission copies a prefill's cache
into its slot and each decode step writes its K/V into the ring buffer,
where the reference donates the cache to jit instead.  The decode step
reads its tokens and positions from fixed device buffers, filled by two
asynchronous copies from pinned host buffers, and leaves its logits in
a fixed buffer; with ``jit=True`` on a card it is captured once as a
CUDA graph (the reference jits it) and every beat replays it.  Prefill
and the cache insert stay eager; their host arrays go up through pinned
memory, asynchronously (``core/device.upload``).  Greedy argmax runs
over the padded vocabulary, as the reference's does.  An encoder-decoder
model's prefill hears ``prefill_len * dec_ratio`` zero frames, a
cross-attention model's sees ``n_vision_tokens`` zero vision tokens, as
the reference's server feeds them.

``CycleServer(cfg, axes)`` serves over a mesh (``MeshAxes`` on a torch
``DeviceMesh``, the reference's ``CycleServer(cfg, axes)``): parameters
and the slot cache are DTensors placed by their specs, each beat's
tokens and positions are written into the fixed DTensor buffers placed
by the input specs, and the flash kernel runs per rank on its own
heads.  With ``jit=True`` on a card its decode step is captured too
(the reference jits it under the mesh): the graph holds every rank's
kernels and the collectives between them, and a replay runs none of
DTensor's Python.  Under ``LocalTensorMode`` (every rank of the mesh
simulated in one process) its host values are the ranks' common value.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import kernels as _k
from repro_torch.configs import ArchConfig
from repro_torch.core import graphs as cg
from repro_torch.core import pytree
from repro_torch.core.device import (host_numpy, is_dtensor, local_shards,
                                     upload)
from repro_torch.models.common import MeshAxes
from repro_torch.models.registry import get_model


@dataclasses.dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float
    output: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    slot: int = -1
    # the request hit the KV-cache capacity (max_seq) before producing
    # max_new_tokens and was force-finished to protect the cache
    truncated: bool = False


def _cache_insert(cache, cache1, slot: int, axes: MeshAxes = MeshAxes()):
    """Copy a batch-1 prefill cache into slot ``slot`` of the slot cache,
    in place.  Group entries ("g*") carry batch at axis 1, leftover
    entries ("x*") at axis 0.  Under a mesh each rank writes its own
    shard (``local_map``): the rank holding batch row ``slot`` takes the
    prefill's row, gathered to the slot cache's layout; the others keep
    theirs.  Returns ``cache``."""
    for key, entry in cache.items():
        axis = 1 if key.startswith("g") else 0
        for f, dst in entry.items():
            if axes.mesh is None:
                dst.narrow(axis, slot, 1).copy_(cache1[key][f])
            else:
                _insert_row(dst, cache1[key][f], slot, axis, axes)
    return cache


def _insert_row(dst, src, slot: int, axis: int, axes: MeshAxes):
    """dst's batch row ``slot`` (on ``axis``) <- src's one row, each rank
    comparing its share of the row ids with ``slot``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    d_pl = list(dst.placements)
    s_pl = [Replicate() if p == Shard(axis) else p for p in d_pl]
    i_pl = [Shard(0) if p == Shard(axis) else Replicate() for p in d_pl]
    ids = torch.arange(dst.shape[axis], device=dst.device)
    ids = axes.constrain(ids).redistribute(axes.mesh, i_pl)

    def local(d, s, i):
        hit = (i == slot).reshape((1,) * axis + (-1,)
                                  + (1,) * (d.dim() - axis - 1))
        d.copy_(torch.where(hit, s.to(d.dtype), d))
        return d

    local_map(local, out_placements=(d_pl,), in_placements=(d_pl, s_pl, i_pl),
              device_mesh=axes.mesh, redistribute_inputs=True)(dst, src, ids)


def _argmax_host(logits) -> np.ndarray:
    """argmax over the last (vocabulary) axis, on the host; a DTensor's
    logits are gathered whole first (each rank then takes the same
    argmax)."""
    if is_dtensor(logits):
        logits = logits.full_tensor()
    return host_numpy(torch.argmax(logits, dim=-1))


class CycleServer:
    """The LM heartbeat server.  ``device=None`` is the CUDA card (raises
    without one); ``kernels`` picks the prefill attention: "hopper" (the
    flash-attention kernel), "torch" (its plain version) or "auto"
    (hopper on a card of capability 9.0+, torch on the CPU).  ``params``
    (the port's nested dict, e.g. from ``params_from_numpy``) replaces
    the random init from ``seed`` (bfloat16).  ``jit=True`` on a card
    captures the decode step as a CUDA graph at construction (the batch
    geometry is fixed per server) and every beat replays it; a capture
    that fails raises.  ``jit=False``, and the CPU, run the same step
    eagerly; ``graphed`` says which."""

    def __init__(self, cfg: ArchConfig, axes: MeshAxes = MeshAxes(), *,
                 capacity: int = 8, max_seq: int = 256,
                 prefill_budget: int = 2, prefill_len: int = 64,
                 params=None, seed: int = 0, device=None,
                 kernels: str = "auto", jit: bool = True):
        self.cfg = cfg
        self.axes = axes
        self.capacity = capacity
        self.max_seq = max_seq
        self.prefill_budget = prefill_budget
        self.prefill_len = prefill_len
        api = get_model(cfg, axes, device=device, kernels=kernels)
        self.api = api
        self.device = api.device
        self.kernels = api.kernels
        if params is None:
            params = api.init_params(seed)
        elif axes.mesh is not None and not is_dtensor(
                pytree.leaves(params)[0]):
            params = api.place(params)  # full tensors onto the mesh
        self.params = params
        # the cross sublayers' context: an enc-dec prefill hears
        # dec_ratio frames a decoder token
        self.ctx_len = api.ctx_len(prefill_len * cfg.dec_ratio)
        self.cache = api.init_cache(capacity, max_seq, ctx_len=self.ctx_len)
        # the zero frames / vision tokens of every admission, made once
        self._ctx_batch = {}
        if self.ctx_len:
            self._ctx_batch["frames" if cfg.enc_dec else "vision"] = \
                axes.distribute(torch.zeros(
                    (1, self.ctx_len, cfg.d_model),
                    dtype=self.params["embed"].dtype, device=self.device))
        # the step functions, as attributes like the reference's jitted
        # ones: prefill (batch 1, at the cache capacity, logits at
        # ``last``) and the shared decode step
        self._prefill = lambda p, batch, last: api.prefill(
            p, batch, cache_capacity=max_seq, last_pos=last)
        self._decode = api.decode_step
        self._queue: collections.deque = collections.deque()
        self._ids = itertools.count()
        self._slots: List[Optional[Request]] = [None] * capacity
        # the decode step's inputs: host arrays that are views of pinned
        # buffers, copied into fixed device buffers at each dispatch
        if axes.mesh is None:
            pin = self.device.type == "cuda"
            self._tok_host = torch.zeros(capacity, dtype=torch.int32,
                                         pin_memory=pin)
            self._pos_host = torch.zeros(capacity, dtype=torch.int32,
                                         pin_memory=pin)
            self._last_tok = self._tok_host.numpy()
            self._pos = self._pos_host.numpy()
        else:   # numpy-backed (from_numpy makes no per-rank tensor)
            self._last_tok = np.zeros(capacity, np.int32)
            self._pos = np.zeros(capacity, np.int32)
            self._tok_host = torch.from_numpy(self._last_tok)
            self._pos_host = torch.from_numpy(self._pos)
        # the reference's int32 inputs, placed by the input specs (what the
        # dry-run counts)
        b = axes.batch(capacity)
        self._tokens = axes.distribute(torch.zeros(
            (capacity, 1), dtype=torch.int32, device=self.device), b, None)
        self._positions = axes.distribute(torch.zeros(
            capacity, dtype=torch.int32, device=self.device), b)
        self.graphed = bool(jit) and self.device.type == "cuda"
        self._logits, self._graph, self.capture_stats = \
            self._build_decode()
        self._pending_logits = None
        self.cycles = 0
        self.completed: List[Request] = []
        # per-cycle wall times / admitted-prefill / active-slot counts of
        # the last run_until_drained (the relational engine's CycleResult
        # accounting)
        self.last_drain_walls: List[float] = []
        self.last_drain_admitted: List[int] = []
        self.last_drain_active: List[int] = []
        self.last_admitted = 0       # prefills admitted by the last beat
        # host seconds of the last beat: admission (prefills, inserts and
        # first tokens, which wait for the card) and the decode step
        # (enqueue in dispatch() to the end of collect()'s wait)
        self.last_admit_s = 0.0
        self.last_decode_s = 0.0
        self._t_decode = 0.0

    def _build_decode(self):
        """The decode step's logits buffer, its graph when ``graphed``
        (else None) and the capture's stats.  One eager step on the idle
        slots (parked at position 0) gives the logits' shape and, on a
        card, warms the capture's side stream up (library handles and
        workspaces); the cache is then reset to its empty state.  A mesh
        server's step is captured as an unsharded one is: every rank's
        kernels (each simulated rank's under ``LocalTensorMode``) and
        the collectives between them, into one graph."""
        cuda = self.device.type == "cuda"
        graph, stats = None, {}
        side = torch.cuda.Stream(self.device) if cuda else None
        if cuda:        # the parameters and the cache come from the
            #             serving stream
            side.wait_stream(torch.cuda.current_stream(self.device))
        with (torch.cuda.stream(side) if cuda else contextlib.nullcontext()):
            with _k.recording():          # the warm-up serves no beat
                logits, _ = self._decode(self.params, self.cache,
                                         self._tokens, self._positions)
            out = torch.empty_like(logits)
            if self.graphed:
                t0 = time.perf_counter()
                pool = torch.cuda.graph_pool_handle()
                graph = cg.capture(self._decode_body_on(out), pool)
                stats = {"capture_s": time.perf_counter() - t0, "graphs": 1,
                         "pool_bytes": cg.pool_bytes(pool)}
            for entry in self.cache.values():     # every field: int32
                for t in entry.values():            # slots -1, the rest 0
                    if t.dtype == torch.int32:
                        t.fill_(-1)
                    else:
                        t.zero_()
        if cuda:
            # the serving stream waits, on the card, for the warm-up, the
            # reset and the buffer allocated on the side stream
            serving = torch.cuda.current_stream(self.device)
            serving.wait_stream(side)
            for t in local_shards(out):
                t.record_stream(serving)
        return out, graph, stats

    def _tokens_spec(self):
        return (self.axes.batch(self.capacity), None)

    def _decode_body_on(self, out):
        def body():
            logits, _ = self._decode(self.params, self.cache, self._tokens,
                                     self._positions)
            out.copy_(logits)
        return body

    # ---------------------------------------------------------------- API
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> Request:
        r = Request(next(self._ids), list(prompt), max_new_tokens,
                    time.time())
        self._queue.append(r)
        return r

    def pending(self) -> int:
        return len(self._queue)

    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    # ---------------------------------------------------------- heartbeat
    def _admit(self) -> int:
        budget = self.prefill_budget
        admitted = 0
        for slot in range(self.capacity):
            if budget == 0 or not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            req = self._queue.popleft()
            budget -= 1
            admitted += 1
            P = self.prefill_len
            toks = np.asarray(req.prompt[-P:] if len(req.prompt) >= P
                              else req.prompt + [0] * (P - len(req.prompt)),
                              np.int64)
            # short prompts are RIGHT-padded to the prefill length, so the
            # first token comes from the true last prompt position (causal
            # attention: it never sees the pads).  An EMPTY prompt
            # conditions on the single pad token at position 0.
            n_real = max(1, min(len(req.prompt), P))
            batch = {"tokens": self.axes.distribute(
                         upload(toks[None], self.device)),
                     **self._ctx_batch}
            logits, cache1 = self._prefill(self.params, batch, n_real - 1)
            _cache_insert(self.cache, cache1, slot, self.axes)
            tok = int(_argmax_host(logits[0]))
            req.slot = slot
            req.output.append(tok)
            req.first_token_time = time.time()
            self._slots[slot] = req
            self._pos[slot] = n_real
            self._last_tok[slot] = tok
        return admitted

    def dispatch(self) -> None:
        """Admit + prefill, then enqueue ONE shared decode step for all
        slots; returns while the card still computes it."""
        if self._pending_logits is not None:
            raise RuntimeError(
                "dispatch() with a decode step already in flight: decode "
                "N+1 consumes N's tokens, collect() the previous cycle "
                "first")
        t0 = time.perf_counter()
        self.last_admitted = self._admit()
        self._t_decode = time.perf_counter()
        self.last_admit_s = self._t_decode - t0
        cuda = self.device.type == "cuda"
        if self.axes.mesh is None:
            self._tokens.copy_(self._tok_host[:, None], non_blocking=cuda)
            self._positions.copy_(self._pos_host, non_blocking=cuda)
        else:
            self._tokens.copy_(self.axes.distribute(
                self._tok_host[:, None].to(self.device),
                *self._tokens_spec()))
            self._positions.copy_(self.axes.distribute(
                self._pos_host.to(self.device), *self._tokens_spec()[:1]))
        if self._graph is not None:
            self._graph.replay()
        else:
            self._decode_body_on(self._logits)()
        self._pending_logits = self._logits

    def collect(self) -> List[Request]:
        """Wait for the in-flight decode step and route its tokens.  Step
        N+1 consumes step N's argmax, so the pipeline depth is one."""
        if self._pending_logits is None:
            return []
        logits = self._pending_logits
        self._pending_logits = None
        nxt = _argmax_host(logits)
        self.last_decode_s = time.perf_counter() - self._t_decode
        finished = []
        now = time.time()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.output.append(tok)
            # the step that just ran wrote KV at self._pos[slot]; a request
            # whose next position would leave the cache is FORCE-FINISHED
            # (clamping would overwrite one KV entry every step)
            hit_cap = self._pos[slot] + 1 >= self.max_seq
            if len(req.output) >= req.max_new_tokens or hit_cap:
                req.truncated = hit_cap and \
                    len(req.output) < req.max_new_tokens
                req.done_time = now
                finished.append(req)
                self.completed.append(req)
                self._slots[slot] = None
                # park the freed slot at position 0: its dummy KV writes
                # stay in bounds, and admission overwrites the slot
                self._pos[slot] = 0
                self._last_tok[slot] = 0
            else:
                self._pos[slot] += 1
                self._last_tok[slot] = tok
        self.cycles += 1
        return finished

    def run_cycle(self) -> List[Request]:
        """One heartbeat: admit + prefill, ONE shared decode step, route."""
        self.dispatch()
        return self.collect()

    def run_until_drained(self, max_cycles: int = 10000) -> List[Request]:
        """Heartbeat until idle; ``max_cycles`` bounds cycles run.  Per-
        cycle walls, admitted prefills and post-admission active slots
        land in ``last_drain_walls`` / ``last_drain_admitted`` /
        ``last_drain_active``."""
        out = []
        self.last_drain_walls = []
        self.last_drain_admitted = []
        self.last_drain_active = []
        while (self.pending() or self.active()) \
                and len(self.last_drain_walls) < max_cycles:
            t0 = time.time()
            self.dispatch()
            self.last_drain_admitted.append(self.last_admitted)
            self.last_drain_active.append(self.active())
            out.extend(self.collect())
            self.last_drain_walls.append(time.time() - t0)
        return out
