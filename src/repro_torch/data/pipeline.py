"""Host-side input pipeline of the training path: deterministic batching
with prefetch onto the device.

Counterpart of the JAX package's ``data/pipeline.py``.  ``TokenBatcher``
is its numpy copy: the batch for step N is a pure function of (stream, N),
so a resumed run takes the very batches an uninterrupted one would.
``Prefetcher`` keeps up to ``size`` batches ahead on a background thread:
on a card each array goes through pinned host memory and a
``non_blocking`` copy on the device's current stream, so the copy is
ordered before the step that reads it and overlaps the previous step's
work.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class TokenBatcher:
    """Deterministic LM batches from a token stream.

    Produces {tokens (B, S), targets (B, S)} int32 with next-token targets;
    step-indexed addressing makes resume-after-restart exact (the batch
    for step N is a pure function of (stream, N), so a checkpoint restores
    mid-epoch without replaying the iterator).
    """

    def __init__(self, stream: np.ndarray, batch: int, seq_len: int,
                 host_index: int = 0, host_count: int = 1):
        assert batch % host_count == 0
        self.stream = stream
        self.batch = batch
        self.local_batch = batch // host_count
        self.seq = seq_len
        self.host_index = host_index
        self.host_count = host_count
        self.tokens_per_step = batch * (seq_len + 1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self.stream)
        span = self.seq + 1
        out_t = np.empty((self.local_batch, self.seq), np.int32)
        out_y = np.empty((self.local_batch, self.seq), np.int32)
        for i in range(self.local_batch):
            row = self.host_index * self.local_batch + i
            start = (step * self.batch + row) * span % (n - span - 1)
            window = self.stream[start:start + span]
            out_t[i] = window[:-1]
            out_y[i] = window[1:]
        return {"tokens": out_t, "targets": out_y}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: on a card through pinned
    memory with ``non_blocking`` copies."""
    out = {}
    for key, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            out[key] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[key] = t.to(device)
    return out


class Prefetcher:
    """Background-thread prefetch of host batches onto the device, in the
    iterator's order."""

    def __init__(self, it: Iterator, size: int = 2,
                 device: DeviceLike = None):
        self._it = it
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        for batch in self._it:
            item = to_device(batch, self._device)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.01)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set():
                return

    def __next__(self):
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        self._thread.join()
