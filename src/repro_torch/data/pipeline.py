"""Sharded, resumable streaming input pipeline (the JAX package's
``repro/data/pipeline.py``, numpy only: the same seed, host striping and
cursor give the same batches in the same order).

Each host reads a disjoint shard of the record stream (host_id/num_hosts
striping), prefetches ahead of the device, and exposes a CURSOR that the
checkpointer persists — restart resumes mid-epoch with no duplicated or
dropped records (deterministic for a fixed seed).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class Cursor:
    epoch: int = 0
    position: int = 0  # index within this host's shard order

    def as_dict(self):
        return {"epoch": self.epoch, "position": self.position}

    @classmethod
    def from_dict(cls, d):
        return cls(epoch=int(d["epoch"]), position=int(d["position"]))


class ShardedStream:
    """Deterministic shuffled stream over an array-backed dataset."""

    def __init__(self, data: np.ndarray, *, host_id: int = 0, num_hosts: int = 1,
                 batch: int = 32, seed: int = 0, cursor: Optional[Cursor] = None):
        self.data = data
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.batch = batch
        self.seed = seed
        self.cursor = cursor or Cursor()

    def _shard_order(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed, epoch))
        perm = rng.permutation(len(self.data))
        return perm[self.host_id :: self.num_hosts]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            order = self._shard_order(self.cursor.epoch)
            while self.cursor.position + self.batch <= len(order):
                idx = order[self.cursor.position : self.cursor.position + self.batch]
                self.cursor.position += self.batch
                yield self.data[idx]
            self.cursor.epoch += 1
            self.cursor.position = 0


class Prefetcher:
    """Background-thread prefetch (depth-bounded) around any iterator."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self.it:
                self.q.put(item)
        finally:
            self.q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._DONE:
            raise StopIteration
        return item
