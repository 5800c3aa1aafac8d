"""HnswIndex — the user-facing API, the counterpart of pg_embedding_tpu/api.py.

Maps the reference's lifecycle onto a Python object holding torch tensors
on one device (reference entry points in parentheses):

  HnswIndex(config, device=)   CREATE INDEX ... USING hnsw WITH (...)
  .build(vectors, labels)      ambuild / hnsw_build        (embedding.c:503)
  .add(vectors, labels)        aminsert / hnsw_insert      (embedding.c:556)
  .search(queries, k)          amgettuple + progressive ef-doubling
                                                           (embedding.c:284-366)
  .delete(labels)              ambulkdelete tombstones     (embedding.c:883-944)
  .exact_search(queries, k)    seq-scan ORDER BY oracle    (embedding.c:1022-1038)

Labels are opaque uint64 user ids kept in host numpy (torch's uint64
support is partial); device search returns internal node ids, mapped to
labels at the very end, exactly where searchKnn does (hnswalg.cpp:243-246).
Tombstoned nodes remain graph waypoints but are filtered from results
(hnswalg.cpp:245).

This is the main-path subset of the JAX package's HnswIndex.  The knobs and
methods it does not port yet raise NotImplementedError naming the
ROADMAP.md queue-1 item that ports them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import HnswConfig
from .core.build import build_schedule, insert_batch_core, quantize_rows
from .core.graph import GraphState, empty_graph, grow_graph
from .core.search import search_graph
from .ops.cuda_bruteforce import fused_exact_search
from .utils.locking import RWLock


def _write_locked(fn):
    """Mutator: exclusive section (MURSIW single-writer discipline,
    embedding.c:624-631 — and stricter: inserts update the graph tensors in
    place, so an overlapping read could see half-written links)."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rwlock.write():
            return fn(self, *a, **k)
    return wrapper


def _read_locked(fn):
    """Reader: shared section; any number may overlap, none with a writer."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rwlock.read():
            return fn(self, *a, **k)
    return wrapper


def _unported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to pg_embedding_tpu_torch yet "
        f"(ROADMAP.md queue 1, item {item})")


class HnswIndex:
    """Flat-NSW approximate nearest neighbor index on one torch device.

    ``device`` defaults to "cuda"; the CPU runs only when asked for.
    Thread-safety contract — MURSIW (embedding.c:624-631): any number of
    concurrent readers (search/search_ids/exact_search), at most one writer
    (build/add/delete/delete_where), and reads never overlap writes.  All
    public methods take the right side of an internal reader-writer lock."""

    def __init__(self, config: HnswConfig, *,
                 device="cuda",
                 initial_capacity: int = 1024,
                 max_insert_batch: int = 256,
                 search_expand_width: int = 4,
                 build_expand_width: int = 8,
                 build_candidates: str = "auto",
                 storage_dtype: str = "float32",
                 quantized_traversal: bool = False,
                 packed_traversal: bool = False) -> None:
        if storage_dtype != "float32":
            raise _unported(f"storage_dtype={storage_dtype!r}", 11)
        if quantized_traversal:
            raise _unported("quantized_traversal", 11)
        if packed_traversal:
            raise _unported("packed_traversal", 11)
        if build_candidates not in ("auto", "beam", "exact", "exact8"):
            raise ValueError(
                f"unknown build_candidates: {build_candidates!r}")
        self.config = config
        self.device = torch.device(device)
        self.max_insert_batch = int(max_insert_batch)
        # candidates expanded per beam-search step (T), a serving knob
        self.search_expand_width = int(search_expand_width)
        # beam expansion width for construction searches ("beam" mode)
        self.build_expand_width = int(build_expand_width)
        # construction candidates: "beam" (batched searchBaseLayer, the
        # reference's parity mode), "exact" (full f32 sweep), "exact8"
        # (int8-shadow sweep + f32 rerank), "auto" (exact below
        # exact_build_threshold, exact8 up to exact8_build_threshold, beam
        # beyond — with the defaults, exact8 from row 0)
        self.build_candidates = build_candidates
        self.exact_build_threshold = 0
        self.exact8_build_threshold: Optional[int] = None
        # candidate-pool width (None => ef_construction for beam,
        # 2*ef_construction for the sweeps)
        self.build_cand_cap: Optional[int] = None
        # Router thresholds, inherited from the JAX package so that both
        # route the same calls; they have not been measured on this card.
        # search(mode="auto") sends batches >= 32 over corpora up to
        # exact_threshold rows to the exact sweep, and filters that allow
        # fewer than filter_exact_selectivity of the rows to the masked
        # exact sweep.
        self.exact_threshold = 5_500_000
        self.filter_exact_selectivity = 0.75
        # widening-loop ceiling: beyond it a starved query returns a
        # partial valid mask (a semantic limit shared with the JAX package)
        self.max_widen_ef = 4096
        self._rwlock = RWLock()
        # int8 shadow of the corpus for the exact8 sweep, valid for its
        # first _qvec_rows rows
        self._qvec: Optional[torch.Tensor] = None
        self._qscale: Optional[torch.Tensor] = None
        self._qvec_rows = 0
        self._graph = empty_graph(initial_capacity, config.dims,
                                  config.max_m, device=self.device)
        self._labels = np.zeros(self._graph.capacity, dtype=np.uint64)
        self.counters: Dict[str, int] = {
            "n_inserted": 0, "n_deleted": 0, "n_searches": 0,
            "n_hops": 0, "n_dist_evals": 0, "n_widenings": 0,
        }

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    @property
    def n_nodes(self) -> int:
        return self._graph.n_nodes

    @property
    def graph(self) -> GraphState:
        return self._graph

    @property
    def labels(self) -> np.ndarray:
        return self._labels[: self.n_nodes]

    def __len__(self) -> int:
        return self.n_nodes

    # ------------------------------------------------------------------ #
    # insert paths
    # ------------------------------------------------------------------ #

    def _check_dims(self, vectors) -> np.ndarray:
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.shape[1] != self.config.dims:
            # analog of "Wrong number of dimensions" (embedding.c:179,581)
            raise ValueError(
                f"wrong number of dimensions: {vectors.shape[1]} instead of "
                f"{self.config.dims} expected")
        return vectors

    def _candidate_mode(self, count_at_start: int):
        """Resolve (candidates, cand_cap) for a batch starting at the given
        node count ("auto" switches engines at the build thresholds)."""
        mode = self.build_candidates
        if mode == "auto":
            if count_at_start < self.exact_build_threshold:
                mode = "exact"
            elif (self.exact8_build_threshold is None or
                  count_at_start < self.exact8_build_threshold):
                mode = "exact8"
            else:
                mode = "beam"
        cap = self.build_cand_cap
        if cap is None and mode in ("exact", "exact8"):
            cap = 2 * self.config.ef_construction
        return mode, cap

    def _ensure_capacity(self, n_new: int) -> None:
        # one batch of slack, as in the JAX package (whose staging would
        # clamp into live rows without it), so capacities agree
        need = self.n_nodes + n_new + self.max_insert_batch
        cap = self._graph.capacity
        if need > cap:
            self._graph = grow_graph(self._graph, max(need, cap * 2))
            grown = np.zeros(self._graph.capacity, dtype=np.uint64)
            grown[: len(self._labels)] = self._labels
            self._labels = grown
            # the int8 shadow is capacity-shaped; the next exact8 batch
            # rebuilds it at the new capacity
            self._qvec = None
            self._qvec_rows = 0

    @staticmethod
    def _quantize(vectors: torch.Tensor, n_nodes: int):
        """int8 shadow of the whole capacity; rows past n_nodes quantize
        as zeros (api._quantize in the JAX package)."""
        live = torch.arange(vectors.shape[0], device=vectors.device) < n_nodes
        return quantize_rows(torch.where(live.unsqueeze(1), vectors, 0.0))

    def _stage_shadow(self, rows: torch.Tensor) -> None:
        """Bring the int8 shadow up to n_nodes, then stage ``rows``'
        codes after it (the exact8 batch threading of the JAX package)."""
        base = self.n_nodes
        if self._qvec is None or self._qvec_rows != base:
            self._qvec, self._qscale = self._quantize(self._graph.vectors,
                                                      base)
        q, s = quantize_rows(rows)
        self._qvec[base:base + len(rows)] = q
        self._qscale[base:base + len(rows)] = s
        self._qvec_rows = base + len(rows)

    @_write_locked
    def add(self, vectors, labels=None) -> np.ndarray:
        """Incremental insert (aminsert analog). Returns assigned node ids."""
        vectors = self._check_dims(vectors)
        n = vectors.shape[0]
        if labels is None:
            labels = np.arange(self.n_nodes, self.n_nodes + n,
                               dtype=np.uint64)
        else:
            labels = np.asarray(labels, dtype=np.uint64).reshape(-1)
            if labels.shape[0] != n:
                raise ValueError("labels/vectors length mismatch")
        self._ensure_capacity(n)
        base = self.n_nodes
        cfg = self.config
        pts = torch.as_tensor(vectors, device=self.device)
        for off, cnt in build_schedule(n, self.max_insert_batch):
            mode, cand_cap = self._candidate_mode(base + off)
            chunk = pts[off:off + cnt]
            if mode == "exact8":
                self._stage_shadow(chunk)
            insert_batch_core(
                self._graph, chunk, cnt, ef_construction=cfg.ef_construction,
                m=cfg.m, max_m=cfg.max_m, metric_value=cfg.metric.value,
                cand_cap=cand_cap, expand_width=self.build_expand_width,
                candidates=mode, qvec=self._qvec, qscale=self._qscale)
        self._labels[base: base + n] = labels
        self.counters["n_inserted"] += n
        return np.arange(base, base + n, dtype=np.int64)

    @_write_locked
    def build(self, vectors, labels=None) -> None:
        """Bulk build (ambuild analog): preallocates capacity for the whole
        corpus up front (embedding.c:503-551)."""
        vectors = self._check_dims(vectors)
        if self.n_nodes != 0:
            raise RuntimeError("build() requires an empty index; use add()")
        self._graph = empty_graph(
            max(vectors.shape[0] + self.max_insert_batch, 32),
            self.config.dims, self.config.max_m, device=self.device)
        self._labels = np.zeros(self._graph.capacity, dtype=np.uint64)
        self._qvec = None
        self._qvec_rows = 0
        self.add(vectors, labels)

    # ------------------------------------------------------------------ #
    # search paths
    # ------------------------------------------------------------------ #

    def _bucket_ef(self, ef: int) -> int:
        """Pad ef to a power-of-two multiple of ef_search, as the JAX
        package does, so both widen through the same ef values."""
        b = self.config.ef_search
        while b < max(ef, 1):
            b *= 2
        return b

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(self._check_dims(queries), device=self.device)

    def _graph_search(self, qdev: torch.Tensor, ef: int):
        return search_graph(self._graph, qdev, ef=ef,
                            metric_value=self.config.metric.value,
                            expand_width=self.search_expand_width)

    def _count_walk(self, b: int, stats) -> None:
        self.counters["n_searches"] += b
        self.counters["n_hops"] += int(stats.hops.sum())
        self.counters["n_dist_evals"] += int(stats.dist_evals.sum())

    @_read_locked
    def search_ids(self, queries, ef: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Raw searchBaseLayer results: (dists [B, ef], node ids [B, ef]),
        ascending, -1 padded, tombstones NOT filtered.  ``ef`` is bucketed
        as in search() and the result sliced back to the requested width."""
        qdev = self._queries(queries)
        ef = self.config.ef_search if ef is None else int(ef)
        d, i, stats = self._graph_search(qdev, self._bucket_ef(max(ef, 1)))
        self._count_walk(qdev.shape[0], stats)
        return d[:, :ef].cpu().numpy(), i[:, :ef].cpu().numpy()

    def _use_exact(self, batch: int) -> bool:
        """Cost-based routing between the graph walk and the exact sweep —
        the planner analog (embedding.c:393-436)."""
        return self.n_nodes <= self.exact_threshold and batch >= 32

    def _filter_to_excluded(self, where
                            ) -> Tuple[Optional[torch.Tensor], int]:
        """Normalize a search filter into a device 'excluded' bool[cap]
        tensor plus the allowed-row count.  ``where`` is a bool mask over
        node ids (True = allowed) or an array of allowed labels; filtered
        rows behave like tombstones."""
        if where is None:
            return None, self.n_nodes
        n = self.n_nodes
        where = np.asarray(where)
        if where.dtype == bool:
            allowed = where.reshape(-1)
            if allowed.shape[0] < n:
                raise ValueError(
                    f"filter mask covers {allowed.shape[0]} of {n} nodes")
            allowed = allowed[:n]
        else:
            allowed = np.isin(self._labels[:n], where.astype(np.uint64))
        excluded = np.ones(self._graph.capacity, bool)
        excluded[:n] = ~allowed
        return (torch.as_tensor(excluded, device=self.device),
                int(allowed.sum()))

    @_read_locked
    def search(self, queries, k: int, ef: Optional[int] = None,
               mode: str = "auto", where=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """k-NN search with tombstone filtering and progressive ef-doubling
        (hnsw_gettuple, embedding.c:284-366): run with efSearch; while some
        query lacks k live results and its search filled the beam, double ef
        and search again, up to max_widen_ef.

        ``mode``: "graph" forces the beam walk, "exact" the exact sweep
        (recall 1.0), "auto" routes by ``_use_exact`` and filter
        selectivity.  ``where``: optional filter, a bool mask over node ids
        or an array of allowed labels.

        Returns (dists f32[B, k], labels u64[B, k], valid bool[B, k]); rows
        ascend by distance, invalid slots padded with inf/0/False.
        """
        queries = self._check_dims(queries)
        b = queries.shape[0]
        if mode == "sweep_pq":
            raise _unported('search(mode="sweep_pq")', 12)
        if mode not in ("auto", "graph", "exact"):
            raise ValueError(f"unknown search mode: {mode!r}")
        excluded, n_allowed = self._filter_to_excluded(where)
        selective = (excluded is not None and
                     n_allowed < self.filter_exact_selectivity
                     * max(self.n_nodes, 1))
        if mode == "exact" or (mode == "auto"
                               and (self._use_exact(b) or selective)):
            self.counters["n_searches"] += b
            self.counters["n_exact_routed"] = (
                self.counters.get("n_exact_routed", 0) + b)
            return self.exact_search(queries, k, excluded=excluded)
        ef = self._bucket_ef(max(self.config.ef_search if ef is None
                                 else int(ef), 1))
        qdev = torch.as_tensor(queries, device=self.device)
        dead = (self._graph.deleted if excluded is None
                else self._graph.deleted | excluded)
        while True:
            dd, ii, stats = self._graph_search(qdev, ef)
            self._count_walk(b, stats)
            alive_dev = (ii >= 0) & ~dead[ii.clamp(min=0)]
            d = dd.cpu().numpy()
            i = ii.cpu().numpy()
            alive = alive_dev.cpu().numpy()
            n_alive = alive.sum(axis=1)
            n_found = (i >= 0).sum(axis=1)
            need_more = (n_alive < min(k, n_allowed)) & (n_found >= ef)
            if (not need_more.any()
                    or ef >= min(max(self.n_nodes, 1), self.max_widen_ef)):
                break
            ef = self._bucket_ef(ef * 2)
            self.counters["n_widenings"] += 1

        out_d = np.full((b, k), np.inf, np.float32)
        out_l = np.zeros((b, k), np.uint64)
        out_v = np.zeros((b, k), bool)
        for row in range(b):
            sel = np.nonzero(alive[row])[0][:k]
            m = len(sel)
            out_d[row, :m] = d[row, sel]
            out_l[row, :m] = self._labels[i[row, sel]]
            out_v[row, :m] = True
        return out_d, out_l, out_v

    @_read_locked
    def exact_search(self, queries, k: int, excluded=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Brute-force exact k-NN over live vectors — the seq-scan ground
        truth (embedding.c:1022-1038).  On CUDA, L2 and cosine run the
        fused kernel (ops/cuda_bruteforce); ``excluded`` is an optional
        bool[cap] device mask of further rows to skip."""
        qdev = self._queries(queries)
        if excluded is None:
            # no tombstones: no mask operand at all
            dead = (self._graph.deleted if self.counters["n_deleted"]
                    else None)
        else:
            dead = self._graph.deleted | excluded
        d, i = fused_exact_search(qdev, self._graph.vectors, k,
                                  self.config.metric, n_valid=self.n_nodes,
                                  deleted=dead)
        d = d.cpu().numpy()
        i = i.cpu().numpy()
        valid = i >= 0
        labels = np.where(valid, self._labels[np.maximum(i, 0)], 0)
        return d, labels.astype(np.uint64), valid

    # ------------------------------------------------------------------ #
    # delete (tombstones)
    # ------------------------------------------------------------------ #

    def _tombstone(self, newly: np.ndarray) -> int:
        idxs = np.nonzero(newly)[0]
        if len(idxs):
            self._graph.deleted[torch.as_tensor(idxs, device=self.device)] = True
        self.counters["n_deleted"] += len(idxs)
        return len(idxs)

    @_write_locked
    def delete(self, labels) -> int:
        """Tombstone every node whose label matches (ambulkdelete analog,
        embedding.c:918-932).  Nodes stay as routable waypoints; returns the
        number tombstoned."""
        labels = np.asarray(labels, dtype=np.uint64).reshape(-1)
        n = self.n_nodes
        already = self._graph.deleted[:n].cpu().numpy()
        return self._tombstone(np.isin(self._labels[:n], labels) & ~already)

    @_write_locked
    def delete_where(self, mask) -> int:
        """Tombstone by node-id mask — the callback form of ambulkdelete."""
        mask = np.asarray(mask, bool).reshape(-1)
        n = self.n_nodes
        already = self._graph.deleted[:n].cpu().numpy()
        return self._tombstone(mask[:n] & ~already)

    # ------------------------------------------------------------------ #
    # not ported yet
    # ------------------------------------------------------------------ #

    def save(self, *a, **k):
        raise _unported("save", 9)

    @classmethod
    def load(cls, *a, **k):
        raise _unported("load", 9)

    def open_scan(self, *a, **k):
        raise _unported("open_scan", 9)

    def tune_ef_search(self, *a, **k):
        raise _unported("tune_ef_search", 9)

    def downcast_corpus(self, *a, **k):
        raise _unported("downcast_corpus", 11)

    def pq_sweep_search(self, *a, **k):
        raise _unported("pq_sweep_search", 12)

    def enable_wal(self, *a, **k):
        raise _unported("enable_wal", 13)
