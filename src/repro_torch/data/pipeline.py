"""Deterministic, restartable data pipeline with background prefetch.

Copied from ``src/repro/data/pipeline.py`` (numpy only); only this
paragraph of its docstring differs.

Design points for the 1000-node regime:

* **Stateless indexing** — batch contents are a pure function of
  ``(seed, step)``: a restarted (or elastically resized) job replays the
  exact stream without coordination.  Each data-parallel host slices its
  own rows (``host_slice``), so no global shuffle service is needed.
* **Background prefetch** — a bounded queue keeps ``depth`` batches staged
  ahead of the training loop (compute/IO overlap on real hardware); the
  bound also provides *straggler mitigation*: a slow shard can fall at most
  ``depth`` batches behind before the trainer notices and can re-assign its
  file range (documented policy; the skip hook is ``on_straggler``).
* Sources: synthetic token streams (benchmarks/examples) or a tokenized
  binary corpus file (memory-mapped, one uint32 token per entry).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int                  # global batch (rows)
    seq_len: int
    vocab_size: int
    seed: int = 0
    corpus: Optional[str] = None   # path to uint32 token file; None=synthetic
    prefetch_depth: int = 2
    host_index: int = 0            # this host's slice of the batch
    host_count: int = 1


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.batch % cfg.host_count == 0
        self.cfg = cfg
        self._tokens = None
        if cfg.corpus:
            self._tokens = np.memmap(cfg.corpus, dtype=np.uint32, mode="r")
            assert len(self._tokens) > cfg.seq_len + 1
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch_depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stall_events = 0  # straggler observability

    # -- pure batch construction ----------------------------------------
    def batch_at(self, step: int) -> dict:
        """The full deterministic batch for ``step`` (all hosts)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        if self._tokens is None:
            tok = rng.integers(
                0, cfg.vocab_size, size=(cfg.batch, cfg.seq_len + 1),
                dtype=np.int64).astype(np.int32)
        else:
            max_start = len(self._tokens) - cfg.seq_len - 1
            starts = rng.integers(0, max_start, size=cfg.batch)
            tok = np.stack([
                np.asarray(self._tokens[s:s + cfg.seq_len + 1], np.int64)
                for s in starts]).astype(np.int32)
            tok = np.minimum(tok, cfg.vocab_size - 1)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def host_slice(self, batch: dict) -> dict:
        cfg = self.cfg
        rows = cfg.batch // cfg.host_count
        lo = cfg.host_index * rows
        return {k: v[lo:lo + rows] for k, v in batch.items()}

    # -- background prefetch ---------------------------------------------
    def start(self, from_step: int = 0):
        def worker():
            step = from_step
            while not self._stop.is_set():
                b = self.host_slice(self.batch_at(step))
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._stop.clear()
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def next(self, timeout: float = 60.0):
        """Blocking get with stall accounting (straggler signal)."""
        try:
            return self._q.get(timeout=0.5)
        except queue.Empty:
            self.stall_events += 1
            return self._q.get(timeout=timeout)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # drain so the worker can observe the stop flag
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        step = 0
        while True:
            yield step, self.host_slice(self.batch_at(step))
            step += 1
