"""Write-ahead delta log — incremental durability between snapshots.

The reference WAL-logs every insert and delete through GenericXLog
(embedding.c:651-686 per-insert page images; 797-806 on end_write; 912-937
per vacuum page), so a crash never loses acknowledged writes.  The
engine's full-state ``save()`` snapshot alone loses everything since the
last snapshot; this module closes that gap with the library-native analog:
an append-only log of logical (insert/delete) records that ``load()``
replays on top of a snapshot.

A copy of pg_embedding_tpu/wal.py (numpy only): the two packages write the
same bytes, so a log written by either replays in the other.

Design:
  * logical logging (vectors + labels), not page images — the graph is
    deterministically rebuilt by re-running the insert path, which is the
    same discipline as the reference's "metadata is reconstructed from
    reloptions" (embedding.c:58-64) applied to the data plane.
  * records are appended and flushed BEFORE the device mutation is issued
    (write-ahead ordering).
  * a snapshot stores the WAL byte offset at save time (the LSN analog);
    load(snapshot, wal=...) seeks there and replays the tail.
  * torn tails (crash mid-append) are detected by length and dropped —
    exactly the semantics of an incomplete WAL record never having been
    acknowledged.

Format (little-endian):
  header: b"HNSWWAL1" + u32 len + config-json (frozen-field guard on reopen;
          carries "epoch" — bumped by truncation, see below)
  record: u8 op (1=insert, 2=delete) + u32 count + payload
          op=1: u64 labels[count] + f32 vectors[count * dims]
          op=2: u64 labels[count]

Lifecycle (round 3): the log no longer grows forever.  ``save()`` truncates
the replayed prefix — the checkpoint-bounded discipline of the reference,
where GenericXLog records are reclaimed once a Postgres checkpoint persists
the pages (embedding.c:526-530, 651-686).  Truncation is made crash-safe by
an *epoch* in the header: the snapshot is written first, recording BOTH the
pre-truncation (epoch, offset) and the predicted post-truncation epoch;
``truncate()`` then atomically replaces the file with a header-only log at
the new epoch.  On recovery, the WAL's actual epoch selects which of the
two replay positions applies, so a crash on either side of the truncation
replays exactly the un-snapshotted tail — never a duplicate, never a loss.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

_MAGIC = b"HNSWWAL1"
OP_INSERT = 1
OP_DELETE = 2


class WalWriter:
    """Append-only writer. Creates the file with a config header, or
    validates + appends to an existing one."""

    def __init__(self, path: str, config) -> None:
        self.path = path
        self.dims = config.dims
        self._header_cfg = config.to_dict()
        if os.path.exists(path) and os.path.getsize(path) > 0:
            stored = read_header(path)
            if (stored.get("dims"), stored.get("m"), stored.get("metric")) \
                    != (self._header_cfg.get("dims"),
                        self._header_cfg.get("m"),
                        self._header_cfg.get("metric")):
                raise ValueError(
                    "WAL was written with different frozen options "
                    "(dims/m/metric)")
            self.epoch = int(stored.get("epoch", 0))
            self._f = open(path, "ab")
        else:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self.epoch = 0
            self._f = open(path, "wb")
            self._write_header(self._f, 0)

    def _write_header(self, f, epoch: int) -> None:
        blob = json.dumps(dict(self._header_cfg, epoch=epoch)).encode()
        f.write(_MAGIC + struct.pack("<I", len(blob)) + blob)
        f.flush()
        os.fsync(f.fileno())

    def header_len(self, epoch: int) -> int:
        """Byte offset just past the header a file at ``epoch`` would have
        (= the replay start of a freshly truncated log)."""
        blob = json.dumps(dict(self._header_cfg, epoch=epoch)).encode()
        return 12 + len(blob)

    def truncate(self, new_epoch: int) -> None:
        """Atomically replace the log with a header-only file at
        ``new_epoch`` — the checkpoint reclaiming the replayed prefix.
        The caller must already have made the covering snapshot durable."""
        tmp = self.path + ".truncating"
        with open(tmp, "wb") as f:
            self._write_header(f, new_epoch)
        self._f.close()
        os.replace(tmp, self.path)
        dirfd = os.open(os.path.dirname(os.path.abspath(self.path)) or ".",
                        os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self.epoch = new_epoch
        self._f = open(self.path, "ab")

    def tell(self) -> int:
        return self._f.tell()

    def log_insert(self, vectors: np.ndarray, labels: np.ndarray) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        labels = np.ascontiguousarray(labels, np.uint64)
        n = len(labels)
        self._f.write(struct.pack("<BI", OP_INSERT, n))
        self._f.write(labels.tobytes())
        self._f.write(vectors.tobytes())
        self._flush()

    def log_delete(self, labels: np.ndarray) -> None:
        labels = np.ascontiguousarray(labels, np.uint64)
        self._f.write(struct.pack("<BI", OP_DELETE, len(labels)))
        self._f.write(labels.tobytes())
        self._flush()

    def _flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"not a WAL file: {path}")
        (ln,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(ln).decode())


def header_end(path: str) -> int:
    with open(path, "rb") as f:
        f.seek(8)
        (ln,) = struct.unpack("<I", f.read(4))
        return 12 + ln


def replay(path: str, dims: int, from_offset: Optional[int] = None
           ) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
    """Yield (op, labels, vectors-or-None) records from ``from_offset``
    (default: just past the header). Stops silently at a torn tail."""
    start = header_end(path) if from_offset is None else int(from_offset)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        while pos < size:
            head = f.read(5)
            if len(head) < 5:
                return  # torn record header
            op, n = struct.unpack("<BI", head)
            lab_bytes = 8 * n
            vec_bytes = 4 * n * dims if op == OP_INSERT else 0
            if pos + 5 + lab_bytes + vec_bytes > size:
                return  # torn payload: record was never fully acknowledged
            labels = np.frombuffer(f.read(lab_bytes), np.uint64)
            vectors = None
            if op == OP_INSERT:
                vectors = np.frombuffer(f.read(vec_bytes),
                                        np.float32).reshape(n, dims)
            yield op, labels, vectors
            pos = f.tell()
