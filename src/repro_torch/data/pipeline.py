"""Sharded training-data pipeline: ``repro.data.pipeline`` copied (it is
numpy only), so that ``batch_at(step)`` is bit-identical to the
reference's; the trainer moves each batch to its device.

Deterministic, checkpointable, host-sharded: every host generates exactly
its slice of the global batch from a (seed, step) pair, so restart-replay
and elastic re-sharding need no data movement — the stream is a pure
function of the step counter (the same discipline the SharedDB engine uses
for its cycles).

Sources: synthetic LM tokens (default; zipf-ish unigram mix so losses move)
or a memory-mapped token file.  Prefetch runs one step ahead on a
background thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"         # synthetic | file
    path: Optional[str] = None
    # aux modality stubs
    frames_dim: int = 0             # enc-dec: frame-embedding dim
    frames_len: int = 0
    vision_tokens: int = 0
    vision_dim: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 n_hosts: int = 1, prefetch: int = 2):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self._tokens = None
        if cfg.kind == "file" and cfg.path:
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._step = 0

    # ------------------------------------------------------------- state
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: Dict) -> None:
        self._step = int(state["step"])

    # ------------------------------------------------------------- batch
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host) — replayable."""
        cfg, B, S = self.cfg, self.local_batch, self.cfg.seq_len
        rng = self._rng(step)
        if self._tokens is not None:
            n = len(self._tokens) - (S + 1)
            starts = rng.integers(0, n, B)
            tok = np.stack([self._tokens[s:s + S + 1] for s in starts])
        else:
            # synthetic: mixture of zipf unigrams + local repetition so the
            # model has learnable structure
            base = rng.zipf(1.3, (B, S + 1)).astype(np.int64)
            tok = (base % (cfg.vocab - 2)) + 1
            rep = rng.random((B, S + 1)) < 0.3
            tok[:, 1:] = np.where(rep[:, 1:], tok[:, :-1], tok[:, 1:])
        batch = {"tokens": tok[:, :-1].astype(np.int32),
                 "labels": tok[:, 1:].astype(np.int32)}
        if cfg.frames_dim:
            batch["frames"] = rng.standard_normal(
                (B, cfg.frames_len, cfg.frames_dim)).astype(np.float32)
        if cfg.vision_tokens:
            batch["vision"] = rng.standard_normal(
                (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
        return batch

    # ---------------------------------------------------------- iterator
    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = self.batch_at(step)
            self._q.put((step, b))
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()
        while True:
            step, b = self._q.get()
            self._step = step + 1
            yield b

    def stop(self):
        self._stop.set()
