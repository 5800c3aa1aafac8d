"""VectorTable — the SQL-surface analog, the counterpart of
pg_embedding_tpu/table.py.

The reference's user surface is a Postgres table with one or more hnsw
indexes on a real[] column and `ORDER BY col <op> q LIMIT k` queries
(embedding--0.3.6.sql; test/sql/knn.sql builds THREE indexes with different
opclasses on the same column).  This module reproduces that surface as a
small host-side table object whose indexes live on one torch device:

  t = VectorTable(dims=3, device="cuda")        CREATE TABLE t (val real[])
  t.insert(rows)                                INSERT INTO t VALUES ...
  t.create_index("<->", m=3)                    CREATE INDEX USING hnsw (...)
  t.order_by(q, "<->", limit=4)                 SELECT ... ORDER BY val <-> q
  t.delete(ids); t.vacuum()                     DELETE + VACUUM (tombstones)
  t.truncate()                                  TRUNCATE (fresh indexes)

`order_by` uses an index when one exists for the operator (the planner
always prefers the hnsw index for ordered scans, embedding.c:393-436) and
falls back to the exact seq scan otherwise, which runs the fused exact
entry (ops/cuda_bruteforce) on the table's device.  Rows with None vectors
are skipped by indexes but counted in the table, mirroring the reference's
NULL handling (embedding.c:171-173).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .api import HnswIndex
from .config import HnswConfig, Metric, resolve_metric
from .ops.cuda_bruteforce import fused_exact_search


class VectorTable:
    """A vector column with optional hnsw indexes per metric, on
    ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, dims: int, device="cuda") -> None:
        self.dims = int(dims)
        self.device = torch.device(device)
        self._rows: List[Optional[np.ndarray]] = []   # None = SQL NULL
        self._live: List[bool] = []
        self._indexes: Dict[Metric, HnswIndex] = {}
        self._index_opts: Dict[Metric, dict] = {}

    def _check_dims(self, n: int) -> None:
        if n != self.dims:
            raise ValueError(f"wrong number of dimensions: {n} instead of "
                             f"{self.dims} expected")

    # ------------------------------------------------------------------ #
    # DML
    # ------------------------------------------------------------------ #

    def insert(self, rows: Sequence) -> List[int]:
        """INSERT: rows may contain None (NULL) entries, which indexes skip
        (embedding.c:171-173). Returns assigned row ids (the ctid analog)."""
        ids = []
        new_vecs, new_ids = [], []
        for r in rows:
            rid = len(self._rows)
            if r is None:
                self._rows.append(None)
            else:
                v = np.asarray(r, np.float32).reshape(-1)
                self._check_dims(v.shape[0])
                self._rows.append(v)
                new_vecs.append(v)
                new_ids.append(rid)
            # NULL-vector rows are live table rows (counted by COUNT(*));
            # they are just absent from the indexes (embedding.c:171-173)
            self._live.append(True)
            ids.append(rid)
        if new_vecs:
            for idx in self._indexes.values():
                idx.add(np.stack(new_vecs), np.asarray(new_ids, np.uint64))
        return ids

    def delete(self, row_ids: Sequence[int]) -> int:
        """DELETE + the VACUUM tombstoning pass (embedding.c:918-932)."""
        dead = []
        for rid in row_ids:
            if 0 <= rid < len(self._rows) and self._live[rid]:
                self._live[rid] = False
                dead.append(rid)
        if dead:
            for idx in self._indexes.values():
                idx.delete(np.asarray(dead, np.uint64))
        return len(dead)

    def vacuum(self) -> Dict[str, int]:
        """Stats only; index space is never reclaimed (embedding.c:867)."""
        stats = {"rows": len(self._rows),
                 "live": int(sum(self._live)),
                 "indexes": len(self._indexes)}
        for metric, idx in self._indexes.items():
            stats[f"index_{metric.name.lower()}"] = idx.vacuum()["num_dead"]
        return stats

    def truncate(self) -> None:
        """TRUNCATE: drops rows and rebuilds every index empty on fresh
        storage (the new-relfilenode semantics, test gh-3)."""
        self._rows = []
        self._live = []
        for metric in list(self._indexes):
            self._indexes[metric] = self._new_index(
                metric, **self._index_opts[metric])

    # ------------------------------------------------------------------ #
    # DDL
    # ------------------------------------------------------------------ #

    def _new_index(self, metric: Metric, **opts) -> HnswIndex:
        return HnswIndex(HnswConfig(dims=self.dims, metric=metric, **opts),
                         device=self.device)

    def create_index(self, metric="<->", *, m: int = 100,
                     ef_construction: int = 16,
                     ef_search: int = 64) -> HnswIndex:
        """CREATE INDEX USING hnsw (val <opclass>) WITH (dims, m, ...);
        builds over existing live rows (ambuild), then stays maintained by
        insert/delete."""
        metric = resolve_metric(metric)
        if metric in self._indexes:
            raise ValueError(f"index for {metric} already exists")
        opts = dict(m=m, ef_construction=ef_construction,
                    ef_search=ef_search)
        idx = self._new_index(metric, **opts)
        vecs, ids = self._live_vectors()
        if len(vecs):
            idx.build(vecs, ids)
        self._indexes[metric] = idx
        self._index_opts[metric] = opts
        return idx

    def drop_index(self, metric) -> None:
        metric = resolve_metric(metric)
        self._indexes.pop(metric, None)
        self._index_opts.pop(metric, None)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #

    def _live_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [(v, i) for i, (v, l) in
                 enumerate(zip(self._rows, self._live)) if l and v is not None]
        if not pairs:
            return (np.zeros((0, self.dims), np.float32),
                    np.zeros((0,), np.uint64))
        vecs = np.stack([p[0] for p in pairs])
        ids = np.asarray([p[1] for p in pairs], np.uint64)
        return vecs, ids

    def _query(self, query) -> np.ndarray:
        q = np.asarray(query, np.float32).reshape(1, -1)
        self._check_dims(q.shape[1])
        return q

    def order_by(self, query, metric="<->", limit: int = 10,
                 use_index: Optional[bool] = None
                 ) -> List[Tuple[int, float]]:
        """SELECT id ORDER BY val <op> q LIMIT k.

        Uses the matching hnsw index when present (the planner's choice,
        embedding.c:393-436); ``use_index=False`` forces the exact seq scan
        (SET enable_seqscan = on). Returns [(row_id, distance)] ascending."""
        metric = resolve_metric(metric)
        q = self._query(query)
        idx = self._indexes.get(metric)
        if use_index is None:
            use_index = idx is not None
        if use_index and idx is not None:
            d, l, v = idx.search(q, limit)
            return [(int(l[0][j]), float(d[0][j]))
                    for j in range(limit) if v[0][j]]
        # seq scan: exact over live rows, on the table's device
        vecs, ids = self._live_vectors()
        if not len(vecs):
            return []
        k = min(limit, len(vecs))
        d, i = fused_exact_search(
            torch.as_tensor(q, device=self.device),
            torch.as_tensor(vecs, device=self.device), k, metric)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        return [(int(ids[i[0][j]]), float(d[0][j]))
                for j in range(k) if i[0][j] >= 0]

    def scan(self, query, metric="<->", batch: int = 1):
        """Pull-model ordered scan — the executor's IndexScan node pulling
        one tuple at a time through amgettuple (embedding.c:284-366).
        Yields (row_id, distance) pairs in pulled order; keeps fetching
        (with the cursor's progressive widening) until the index is
        exhausted.  Requires an index for the metric."""
        metric = resolve_metric(metric)
        idx = self._indexes.get(metric)
        if idx is None:
            raise ValueError(f"no hnsw index exists for {metric}; "
                             "ordered pull scans need one (amgettuple)")
        cursor = idx.open_scan(self._query(query))
        while True:
            d, l = cursor.next(batch)
            for j in range(len(l)):
                yield int(l[j]), float(d[j])
            if len(l) < batch:
                return

    def count(self) -> int:
        """SELECT COUNT(*) — live rows (NULL-vector rows count too)."""
        return int(sum(self._live))

    def __getitem__(self, rid: int) -> Optional[np.ndarray]:
        if not self._live[rid]:
            raise KeyError(rid)
        return self._rows[rid]
