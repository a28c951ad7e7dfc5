"""Deterministic synthetic LM data pipeline with host sharding + prefetch.

A copy of ``repro/train/data.py`` (numpy only): the same ``RandomState``
seeding per (seed, step, host), so the same batches bit for bit. The
port keeps its own copy because it imports nothing of the reference.
Batches are numpy; ``train/loop.py`` puts them on the card.

Production shape: each host materializes only its shard of the global batch
(host_id / n_hosts), derived from a counter-based PRNG so any host can
reproduce any step's data after a restart (checkpoint stores only the step
counter — data state is free). A background thread prefetches batches.

The synthetic stream is Zipf-distributed token ids with a deterministic
"repeated n-gram" structure so the LM loss actually decreases — enough
signal for the end-to-end example runs required by deliverable (b).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 8          # repeated-structure period (learnable signal)


class SyntheticLMStream:
    """Deterministic, shardable synthetic token stream."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def batch_at(self, step: int) -> dict:
        """Materialize this host's shard of the batch for `step`."""
        cfg = self.cfg
        rs = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 131 + self.host_id) % (2**31))
        b, t = self.local_batch, cfg.seq_len
        # Zipf base stream, clipped to vocab
        base = rs.zipf(cfg.zipf_a, size=(b, t)).astype(np.int64)
        base = np.minimum(base, cfg.vocab - 1)
        # inject learnable periodic structure: every ngram-th token repeats
        # the token ngram positions earlier
        if cfg.ngram > 1 and t > cfg.ngram:
            base[:, cfg.ngram:] = np.where(
                (np.arange(cfg.ngram, t) % cfg.ngram) == 0,
                base[:, :-cfg.ngram], base[:, cfg.ngram:])
        tokens = base.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch queue over a step-indexed stream."""

    def __init__(self, stream: SyntheticLMStream, *, start_step: int = 0,
                 depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
