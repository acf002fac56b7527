"""Request capture and sessionization (Palpatine §3.1, "Data pre-processing").

Copied unchanged from ``src/repro/core/sessions.py``: the port keeps its
own copy and imports nothing from ``repro``.

Palpatine intercepts read requests at the client library and builds its own
structured backlog: a *sequence database* of user sessions.  A session is a
burst of activity — consecutive requests separated by less than a time gap.
An item is a *data container*: the metadata identifying a cell in the back
store (table, row, column family:qualifier, or any combination).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "Container",
    "AccessLogger",
    "SequenceDatabase",
]


@dataclasses.dataclass(frozen=True, order=True)
class Container:
    """A data container: identifies a cell (or slice) of the back store.

    Any component may be ``None`` — e.g. a frequent *column* sequence for the
    same row uses containers that only differ in ``column`` (paper §3.1
    pattern type 1), a frequent *row* sequence only in ``row`` (type 2), and
    hybrid sequences vary both (type 3).
    """

    table: Optional[str] = None
    row: Optional[str] = None
    column: Optional[str] = None  # "family:qualifier"

    def key(self) -> tuple:
        return (self.table, self.row, self.column)

    def __str__(self) -> str:  # compact log form
        return f"{self.table or '*'}/{self.row or '*'}/{self.column or '*'}"


class SequenceDatabase:
    """An integer-encoded sequence database over a container vocabulary.

    Sessions are tuples of item ids.  The database owns the id<->container
    vocabulary and lazily materializes the padded matrix / packed vertical
    bitmaps used by the miners.
    """

    def __init__(self) -> None:
        self._vocab: dict = {}
        self._items: list = []
        self.sessions: list[tuple[int, ...]] = []

    # -- vocabulary ---------------------------------------------------------
    def item_id(self, container) -> int:
        key = container.key() if isinstance(container, Container) else container
        iid = self._vocab.get(key)
        if iid is None:
            iid = len(self._items)
            self._vocab[key] = iid
            self._items.append(key)
        return iid

    def item(self, iid: int):
        return self._items[iid]

    @property
    def n_items(self) -> int:
        return len(self._items)

    # -- key-space translation (pattern exchange between clients) ----------
    def decode(self, item_ids: Iterable[int]) -> tuple:
        """Translate item ids to container keys — vocabulary-independent
        form, so a pattern can leave this client (gossip, persistence)."""
        return tuple(self._items[i] for i in item_ids)

    def encode(self, keys: Iterable) -> tuple:
        """Translate container keys to this database's item ids, growing
        the vocabulary for keys not seen locally yet."""
        return tuple(self.item_id(k) for k in keys)

    def __len__(self) -> int:
        return len(self.sessions)

    # -- construction -------------------------------------------------------
    def add_session(self, containers: Iterable) -> None:
        seq = tuple(self.item_id(c) for c in containers)
        if seq:
            self.sessions.append(seq)

    @classmethod
    def from_sessions(cls, sessions: Iterable[Sequence]) -> "SequenceDatabase":
        db = cls()
        for s in sessions:
            db.add_session(s)
        return db

    # -- dense views for the miners ----------------------------------------
    def padded_matrix(self) -> tuple[np.ndarray, np.ndarray]:
        """Return ``(mat, lengths)``; ``mat`` is (n_sessions, max_len) int32,
        padded with -1."""
        if not self.sessions:
            return np.zeros((0, 0), np.int32), np.zeros((0,), np.int32)
        lengths = np.array([len(s) for s in self.sessions], np.int32)
        mat = np.full((len(self.sessions), int(lengths.max())), -1, np.int32)
        for i, s in enumerate(self.sessions):
            mat[i, : len(s)] = s
        return mat, lengths

    def tail(self, n_sessions: int) -> "SequenceDatabase":
        """A view database over the most recent ``n_sessions`` (online mining
        works on the chunk of the backlog since the last mining run)."""
        db = SequenceDatabase()
        db._vocab, db._items = self._vocab, self._items  # share vocab
        db.sessions = self.sessions[-n_sessions:]
        return db


class AccessLogger:
    """Monitoring component: appends intercepted reads to the backlog and
    cuts sessions on time gaps (paper §3.1).

    ``session_gap`` is in the same (virtual) time unit the caller uses.
    """

    def __init__(self, session_gap: float = 1.0) -> None:
        self.session_gap = float(session_gap)
        self.db = SequenceDatabase()
        self._open: list = []
        self._last_t: Optional[float] = None
        self.n_events = 0

    def record(self, t: float, container) -> None:
        if self._last_t is not None and (t - self._last_t) > self.session_gap:
            self.flush_session()
        self._open.append(container)
        self._last_t = t
        self.n_events += 1

    def record_many(self, t: float, containers: Iterable) -> None:
        """Log a batch issued as overlapping in-flight reads: one burst at
        a single virtual timestamp.  The batch order is preserved in the
        session (mining sees the same sequence a loop of ``record`` calls
        would produce), and a batch never straddles a session cut."""
        for c in containers:
            self.record(t, c)

    def flush_session(self) -> None:
        if self._open:
            self.db.add_session(self._open)
            self._open = []

    def snapshot(self) -> SequenceDatabase:
        """Close the open session and return the backlog database."""
        self.flush_session()
        return self.db

    def reset_backlog(self) -> None:
        """Drop logged sessions (after a mining run consumed them) but keep
        the vocabulary, so pattern ids stay stable across mining runs."""
        self.flush_session()
        db = SequenceDatabase()
        db._vocab, db._items = self.db._vocab, self.db._items
        self.db = db
