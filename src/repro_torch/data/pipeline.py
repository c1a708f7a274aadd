"""Data pipeline (counterpart of ``repro.data.pipeline``): a deterministic
synthetic token stream with a prefetching host loader.

Deterministic per (seed, step): a restart resumes from any step without
replaying the stream (the checkpoint stores only the step counter), and a
re-shard keeps sample assignment stable because indexing is by global
sample id, not worker id.  Each sample draws from
``numpy.random.default_rng(SeedSequence([seed, step, sample]))``, as the
JAX package's does, so both packages see the same int32 tokens.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..models.config import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    prefetch: int = 2


class SyntheticTokenDataset:
    """Zipf-like synthetic tokens with enough structure that the loss
    falls: each sequence repeats a short motif, both drawn from a
    per-(seed, step, sample) counter-based generator (stateless, so
    seekable)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int, sample: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, sample]))

    def sample(self, step: int, sample_id: int) -> np.ndarray:
        rng = self._rng(step, sample_id)
        v = self.cfg.vocab
        s = self.cfg.seq_len
        # zipf marginals + short-range structure (a motif inserted 4 times)
        toks = (rng.zipf(1.3, size=s + 1) - 1) % v
        motif = (rng.zipf(1.3, size=8) - 1) % v
        start = int(rng.integers(0, max(1, s - 64)))
        for r in range(4):
            o = start + r * 8
            if o + 8 <= s + 1:
                toks[o:o + 8] = motif
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        gb = self.cfg.global_batch
        seqs = np.stack([self.sample(step, i) for i in range(gb)])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


class DataLoader:
    """A loader that stages batches on a background thread while the
    current step computes, from ``start_step`` on.  ``close()`` stops the
    thread."""

    def __init__(self, dataset: SyntheticTokenDataset, start_step: int = 0,
                 extras: Optional[Dict[str, Any]] = None):
        self.dataset = dataset
        self.step = start_step
        self.extras = extras or {}
        self._q: "queue.Queue" = queue.Queue(maxsize=dataset.cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.dataset.batch(step)
            batch.update(self.extras)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def make_batch_shapes(cfg: ArchConfig, shape: ShapeConfig):
    from ..launch.specs import train_batch_specs
    return train_batch_specs(cfg, shape)
