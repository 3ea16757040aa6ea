"""Training data pipeline of ``repro.data.pipeline``: a deterministic
synthetic token stream, placement on the device, background prefetch.

Batches are pure functions of (seed, step), drawn with numpy exactly as
the reference draws them (the same bytes), so a resumed run consumes
identical data with no coordination state. :func:`to_device` places a
batch on one device; the reference's sharded placement (``shard_batch``)
waits for multi-GPU.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def synthetic_batch(cfg: ModelConfig, global_batch: int, seq_len: int,
                    step: int, seed: int = 0) -> np.ndarray:
    """Deterministic tokens for (seed, step): structured (zipf-ish) stream so
    losses move; restart-replayable by construction."""
    rng = np.random.default_rng((seed << 20) ^ step)
    # zipf-distributed ids resemble natural token frequencies
    ids = rng.zipf(1.3, size=(global_batch, seq_len)).astype(np.int64)
    return np.minimum(ids, cfg.vocab_size - 2).astype(np.int32)


def frontend_batch(cfg: ModelConfig, global_batch: int, step: int,
                   seed: int = 0) -> Optional[np.ndarray]:
    if not cfg.frontend_dim:
        return None
    rng = np.random.default_rng((seed << 21) ^ step)
    return rng.standard_normal(
        (global_batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


def to_device(batch: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(batch).to(device)


class Prefetcher:
    """Background-thread prefetch of data batches."""

    def __init__(self, make: Callable[[int], object], start_step: int,
                 depth: int = 2):
        self._make = make
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(s), timeout=0.1)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=1.0)
