"""Reader-writer lock — the MURSIW concurrency contract for the host API.

The reference serializes writers with an exclusive lock on page 0 held for
the whole graph update while readers proceed under share locks
(embedding.c:624-631: "MURSIW, single writer").  The engine needs the
same contract made explicit at the Python tier, and one stricter rule: the
insert path updates the graph tensors IN PLACE (core/build
insert_batch_core), so a search overlapping a mutation could gather
half-written link rows — reads must not overlap writes at all, not merely
see stale data.

``RWLock`` grants either many concurrent readers or one writer.  It is
reentrancy-aware per thread: a thread holding the write lock may take
read/write sections freely (the auto-checkpoint path calls save() — a
reader — from inside add() — a writer), and nested read sections are
counted.  Writers are PREFERRED: once a writer is waiting, fresh read
sections block until it runs.  Without this, a read-heavy workload on
few cores starves the writer indefinitely — two spinning reader threads
always keep the read side held (observed as a livelocked two-thread
smoke test on the one-core CI host); reentrant reads are exempt so a
reader never deadlocks against a writer it must itself finish first.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: int | None = None   # owning thread id
        self._write_depth = 0
        self._writers_waiting = 0
        self._local = threading.local()

    def _read_depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextmanager
    def read(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me or self._read_depth() > 0:
                # reentrant under our own write or read section
                self._local.depth = self._read_depth() + 1
                reentrant = True
            else:
                # writer preference: fresh readers also yield to WAITING
                # writers, or spinning readers starve them forever
                while (self._writer is not None
                       or self._writers_waiting > 0):
                    self._cond.wait()
                self._readers += 1
                self._local.depth = 1
                reentrant = False
        try:
            yield
        finally:
            with self._cond:
                self._local.depth = self._read_depth() - 1
                if not reentrant:
                    self._readers -= 1
                    if self._readers == 0:
                        self._cond.notify_all()

    @contextmanager
    def write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._write_depth += 1
                nested = True
            else:
                if self._read_depth() > 0:
                    raise RuntimeError(
                        "cannot upgrade a read section to a write section "
                        "(lock-ordering deadlock); restructure the caller")
                self._writers_waiting += 1
                try:
                    while self._writer is not None or self._readers > 0:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = me
                self._write_depth = 1
                nested = False
        try:
            yield
        finally:
            with self._cond:
                if nested:
                    self._write_depth -= 1
                else:
                    self._writer = None
                    self._write_depth = 0
                    self._cond.notify_all()
