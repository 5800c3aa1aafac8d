"""HnswIndex — the user-facing API, the counterpart of pg_embedding_tpu/api.py.

Maps the reference's lifecycle onto a Python object holding torch tensors
on one device (reference entry points in parentheses):

  HnswIndex(config, device=)   CREATE INDEX ... USING hnsw WITH (...)
  .build(vectors, labels)      ambuild / hnsw_build        (embedding.c:503)
  .add(vectors, labels)        aminsert / hnsw_insert      (embedding.c:556)
  .search(queries, k)          amgettuple + progressive ef-doubling
                                                           (embedding.c:284-366)
  .open_scan(query)            the amgettuple cursor itself
  .delete(labels)              ambulkdelete tombstones     (embedding.c:883-944)
  .vacuum()                    amvacuumcleanup stats       (embedding.c:867-878)
  .exact_search(queries, k)    seq-scan ORDER BY oracle    (embedding.c:1022-1038)
  .save(path) / .load(path)    page durability + metadata guard
                                                           (embedding.c:594-602)
  .enable_wal(path)            GenericXLog per insert/delete (embedding.c:651-686)

Labels are opaque uint64 user ids kept in host numpy (torch's uint64
support is partial); device search returns internal node ids, mapped to
labels at the very end, exactly where searchKnn does (hnswalg.cpp:243-246).
Tombstoned nodes remain graph waypoints but are filtered from results
(hnswalg.cpp:245).

Snapshots are the JAX package's npz format, key for key and dtype for
dtype, and the WAL is the same bytes (wal.py), so either package restores
what the other wrote, a trained PQ codebook (and OPQ rotation) included.

Product quantization (ops/pq.py) serves two engines: the packed PQ walk
(packed_traversal with packed_dtype="pq") and the compressed sweep
(search(mode="sweep_pq") / pq_sweep_search, ops/pq_sweep.py).  Both rerank
what they surface exactly, on the stored rows.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import wal as walmod
from .config import HnswConfig, Metric
from .core.build import build_schedule, insert_batch_core, quantize_rows
from .core.graph import GraphState, empty_graph, grow_graph, pack_records
from .core.search import search_graph, search_graph_pq
from .ops import bruteforce
from .ops.cuda_bruteforce import fused_exact_search
from .ops.pq import pack_pq_records, pq_encode, train_opq, train_pq
from .ops.pq_sweep import pq_sweep_search as _pq_sweep
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
    """Reader: shared section; any number may overlap, none with a writer.
    Reentrant under this thread's own write (auto-checkpoint calls save()
    from inside add())."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rwlock.read():
            return fn(self, *a, **k)
    return wrapper


_SAVE_FORMAT_VERSION = 1

_STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# element type of the packed neighbour records
_PACKED_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                  "float32": torch.float32}
# PQ training: Lloyd iterations, and the live rows of the strided sample
_PQ_TRAIN_ITERS = 12
_PQ_TRAIN_SAMPLE = 131_072


class TuneResult(NamedTuple):
    """tune_ef_search outcome: the chosen ef, the recall it achieved on the
    tuning queries, and whether the target was met."""

    ef: int
    recall: float
    met: bool


class TuneTargetMissed(RuntimeError):
    """Raised by tune_ef_search(strict=True) when even max_ef missed the
    recall target."""


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to suffix-less paths; normalize so
    save(p) / load(p) are symmetric for any p."""
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_savez(path: str, payload: dict, compressed: bool) -> None:
    """Write an .npz durably and atomically: tmp file + flush + fsync +
    rename + directory fsync.  A crash mid-save leaves the previous
    snapshot intact."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compressed else np.savez)(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


class HnswIndex:
    """Flat-NSW approximate nearest neighbor index on one torch device.

    ``device`` defaults to "cuda"; the CPU runs only when asked for.
    Thread-safety contract — MURSIW (embedding.c:624-631): any number of
    concurrent readers (search/search_ids/exact_search/save/scan fetches),
    at most one writer (build/add/delete/delete_where), and reads never
    overlap writes.  All public methods take the right side of an internal
    reader-writer lock."""

    def __init__(self, config: HnswConfig, *,
                 device="cuda",
                 initial_capacity: int = 1024,
                 max_insert_batch: int = 256,
                 search_expand_width: int = 4,
                 build_expand_width: int = 8,
                 build_candidates: str = "auto",
                 storage_dtype: str = "float32",
                 quantized_traversal: bool = False,
                 packed_traversal: bool = False,
                 packed_dtype: str = "int8",
                 pq_groups: int = 16,
                 pq_opq: bool = False) -> None:
        if storage_dtype not in _STORAGE_DTYPES:
            raise ValueError(f"unknown storage_dtype: {storage_dtype!r}")
        if build_candidates not in ("auto", "beam", "exact", "exact8"):
            raise ValueError(
                f"unknown build_candidates: {build_candidates!r}")
        if packed_dtype not in (*_PACKED_DTYPES, "pq"):
            raise ValueError(f"unknown packed_dtype: {packed_dtype!r}")
        if packed_dtype == "pq" and config.dims % int(pq_groups):
            raise ValueError(
                f"dims {config.dims} not divisible by pq_groups {pq_groups}")
        if pq_opq and config.metric == Metric.MANHATTAN:
            raise ValueError(
                "pq_opq requires a rotation-invariant metric (l2/cosine); "
                "manhattan distances change under rotation")
        self.config = config
        self.device = torch.device(device)
        self.max_insert_batch = int(max_insert_batch)
        # "float32" or "bfloat16": the dtype the corpus rows are stored in
        # (a memory knob, persisted on save).  Distances are float32 either
        # way; bf16 rows are upcast where they are read.
        self.storage_dtype = storage_dtype
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
        # exact_threshold rows (exact_threshold_packed under packed
        # traversal) to the exact sweep, and filters that allow fewer than
        # filter_exact_selectivity of the rows to the masked exact sweep.
        self.exact_threshold = 5_500_000
        self.exact_threshold_packed = 2_700_000
        self.filter_exact_selectivity = 0.75
        # widening-loop ceiling: beyond it a starved query returns a
        # partial valid mask (a semantic limit shared with the JAX package)
        self.max_widen_ef = 4096
        # serving knobs: the walk reads int8 rows (quantized_traversal) or
        # per-node neighbour records of packed_dtype (packed_traversal;
        # "int8", "bfloat16", "float32" or "pq": G one-byte codes per
        # neighbour), then reranks exactly (float32 records need no rerank:
        # their walk equals the plain walk).  The shadows are built lazily
        # and dropped by add().
        self.quantized_traversal = bool(quantized_traversal)
        self.packed_traversal = bool(packed_traversal)
        self.packed_dtype = packed_dtype
        # PQ (ops/pq.py): G groups of D/G dims, one byte each; OPQ learns a
        # rotation first (better codebooks on correlated dims, one q @ R per
        # query batch; l2/cosine only).  The codebook f32[G, 256, D/G] (and
        # rotation f32[D, D]) are trained once on a strided sample of
        # _PQ_TRAIN_SAMPLE live rows, kept as the corpus grows and saved;
        # build() resets them.  _pq_codes u8[cap, G] are the per-row codes
        # of the sweep and the source of pq records; add() drops them.
        self.pq_groups = int(pq_groups)
        self.pq_opq = bool(pq_opq)
        self._pq_codebook: Optional[torch.Tensor] = None
        self._pq_rot: Optional[torch.Tensor] = None
        self._pq_codes: Optional[torch.Tensor] = None
        # sweep_pq coarse-pool width: None = per-call default (4k, capped
        # at 256); tune_sweep_pool sets it from a recall target
        self.pq_sweep_pool: Optional[int] = None
        # visited set of the walk: "dense" (no visited memory; "auto" is
        # dense), "bitmap" (the exact per-query bitmap, a cross-check
        # oracle) or "hash" (a fixed-size open-hash table per query)
        self.visited_mode = "dense"
        # write-ahead delta log (see enable_wal); None until enabled
        self._wal: Optional[walmod.WalWriter] = None
        self._wal_replaying = False
        self._wal_auto_bytes: Optional[int] = None
        self._wal_snapshot_path: Optional[str] = None
        self._rwlock = RWLock()
        # int8 shadow of the corpus (exact8 sweep, quantized traversal,
        # int8 records), valid for its first _qvec_rows rows
        self._qvec: Optional[torch.Tensor] = None
        self._qscale: Optional[torch.Tensor] = None
        self._qvec_rows = 0
        # packed neighbour records [cap, maxM, D] and, for int8, scales
        self._pcodes: Optional[torch.Tensor] = None
        self._pscales: Optional[torch.Tensor] = None
        self._graph = empty_graph(initial_capacity, config.dims,
                                  config.max_m, device=self.device,
                                  dtype=_STORAGE_DTYPES[storage_dtype])
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
        # writable, so torch can share it (WAL replay hands in read-only
        # buffers)
        vectors = np.require(vectors, np.float32, ["C", "W"])
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
        if self._wal is not None and not self._wal_replaying:
            # write-ahead: the record is durable before the device mutation
            self._wal.log_insert(vectors, labels)
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
        # the serving shadows are stale, except the int8 rows when the
        # exact8 batches staged every inserted row (rows are append-only)
        if self._qvec_rows != base + n:
            self._qvec = None
            self._qvec_rows = 0
        self._pcodes = None
        self._pscales = None
        self._pq_codes = None
        self._maybe_auto_checkpoint()
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
            self.config.dims, self.config.max_m, device=self.device,
            dtype=_STORAGE_DTYPES[self.storage_dtype])
        self._labels = np.zeros(self._graph.capacity, dtype=np.uint64)
        self._qvec = None
        self._qvec_rows = 0
        self._pq_codebook = self._pq_rot = self._pq_codes = None
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

    def _visited_slots(self, ef: int) -> int:
        """-1 = dense dedupe (the default), 0 = exact bitmap, else the
        hash-table slot count (a power of two, ~4x the expected unique
        visits ef * maxM)."""
        if self.visited_mode in ("dense", "auto"):
            return -1
        if self.visited_mode == "bitmap":
            return 0
        return 1 << max(13, (4 * ef * self.config.max_m - 1).bit_length())

    def _ensure_quantized(self):
        if self._qvec is None:
            self._qvec, self._qscale = self._quantize(self._graph.vectors,
                                                      self.n_nodes)
            self._qvec_rows = self.n_nodes
        return self._qvec, self._qscale

    def _ensure_pq_codebook(self) -> torch.Tensor:
        """Train the PQ codebook (and, with pq_opq, the rotation) once, on
        a strided sample of the live rows."""
        if self._pq_codebook is None:
            n = max(self.n_nodes, 1)
            stride = max(1, n // _PQ_TRAIN_SAMPLE)
            sample = self._graph.vectors[:n:stride].to(torch.float32)
            if self.pq_opq:
                self._pq_rot, self._pq_codebook = train_opq(
                    sample, groups=self.pq_groups,
                    pq_iters=_PQ_TRAIN_ITERS)
            else:
                self._pq_codebook = train_pq(sample, groups=self.pq_groups,
                                             iters=_PQ_TRAIN_ITERS)
        return self._pq_codebook

    def _ensure_pq_codes(self) -> torch.Tensor:
        """Per-row PQ codes u8[cap, G] of every stored row, the OPQ
        rotation applied inside the chunked encode."""
        if self._pq_codes is None:
            cb = self._ensure_pq_codebook()
            self._pq_codes = pq_encode(self._graph.vectors, cb, self._pq_rot)
        return self._pq_codes

    def _ensure_packed(self):
        """The packed records of packed_dtype, (re)built when missing or of
        another element type."""
        want = _PACKED_DTYPES.get(self.packed_dtype, torch.uint8)
        if self._pcodes is None or self._pcodes.dtype != want:
            self._pcodes = self._pscales = None      # free before packing
            links = self._graph.links
            if self.packed_dtype == "pq":
                self._pcodes = pack_pq_records(self._ensure_pq_codes(),
                                               links)
            elif want == torch.int8:
                qv, qs = self._ensure_quantized()
                self._pcodes = pack_records(qv, links)
                self._pscales = qs[links.clamp(min=0)]
            else:
                self._pcodes = pack_records(self._graph.vectors, links, want)
        return self._pcodes, self._pscales

    def _graph_search(self, qdev: torch.Tensor, ef: int):
        kw = {}
        if self.packed_traversal and self.packed_dtype == "pq":
            pc, _ = self._ensure_packed()
            return search_graph_pq(self._graph, qdev, pc, self._pq_codebook,
                                   self._pq_rot, ef=ef,
                                   metric_value=self.config.metric.value,
                                   expand_width=self.search_expand_width,
                                   visited_slots=self._visited_slots(ef))
        if self.packed_traversal:
            pc, ps = self._ensure_packed()
            kw = dict(pcodes=pc, pscales=ps)
        elif self.quantized_traversal:
            qv, qs = self._ensure_quantized()
            kw = dict(qvectors=qv, qscale=qs)
        return search_graph(self._graph, qdev, ef=ef,
                            metric_value=self.config.metric.value,
                            expand_width=self.search_expand_width,
                            visited_slots=self._visited_slots(ef), **kw)

    @staticmethod
    def _alive(dead: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Which result ids are real and not dead (device bool)."""
        return (ids >= 0) & ~dead[ids.clamp(min=0)]

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
        the planner analog (embedding.c:393-436).  Packed traversal serves
        a faster walk, so its crossover is lower."""
        threshold = (self.exact_threshold_packed if self.packed_traversal
                     else self.exact_threshold)
        return self.n_nodes <= threshold and batch >= 32

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
        (recall 1.0), "sweep_pq" the compressed sweep (pq_sweep_search),
        "auto" routes between graph and exact by ``_use_exact`` and filter
        selectivity.  ``where``: optional filter, a bool mask over node ids
        or an array of allowed labels.

        Returns (dists f32[B, k], labels u64[B, k], valid bool[B, k]); rows
        ascend by distance, invalid slots padded with inf/0/False.
        """
        queries = self._check_dims(queries)
        b = queries.shape[0]
        if mode not in ("auto", "graph", "exact", "sweep_pq"):
            raise ValueError(f"unknown search mode: {mode!r}")
        excluded, n_allowed = self._filter_to_excluded(where)
        if mode == "sweep_pq":
            self.counters["n_searches"] += b
            return self.pq_sweep_search(queries, k, excluded=excluded)
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
            alive_dev = self._alive(dead, ii)
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

    def open_scan(self, query, ef: Optional[int] = None,
                  where=None) -> "HnswScan":
        """Open a pull-model cursor over one query — the amgettuple analog
        (embedding.c:284-366).  ``scan.next(n)`` returns the next n
        not-yet-returned live results, re-searching with doubled ef when
        the cache is exhausted and deduping rows already handed out.

        Like the reference (comment embedding.c:345-351), rows appended by
        a widened re-search may be CLOSER than rows already returned."""
        query = self._check_dims(query)
        if query.shape[0] != 1:
            raise ValueError("open_scan takes exactly one query vector")
        ef = self.config.ef_search if ef is None else int(ef)
        return HnswScan(self, query, self._bucket_ef(max(ef, 1)), where)

    def _answers(self, d: torch.Tensor, i: torch.Tensor
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(dists, node ids) of a sweep as host (dists, labels, valid)."""
        d = d.cpu().numpy()
        i = i.cpu().numpy()
        valid = i >= 0
        labels = np.where(valid, self._labels[np.maximum(i, 0)], 0)
        return d, labels.astype(np.uint64), valid

    @_read_locked
    def exact_search(self, queries, k: int, engine: str = "auto",
                     excluded=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Brute-force exact k-NN over live vectors — the seq-scan ground
        truth (embedding.c:1022-1038).

        ``engine``: "auto" and "pallas" take the fused entry
        (ops/cuda_bruteforce.fused_exact_search: on CUDA, L2 and cosine run
        the kernel at the corpus's storage dtype), "jnp" the chunked torch
        top-k (ops/bruteforce.exact_search); the names are the JAX
        package's.  ``excluded`` is an optional bool[cap] device mask of
        further rows to skip."""
        if engine not in ("auto", "jnp", "pallas"):
            raise ValueError(f"unknown exact engine: {engine!r}")
        qdev = self._queries(queries)
        if excluded is None:
            # no tombstones: no mask operand at all
            dead = (self._graph.deleted if self.counters["n_deleted"]
                    else None)
        else:
            dead = self._graph.deleted | excluded
        sweep = (bruteforce.exact_search if engine == "jnp"
                 else fused_exact_search)
        d, i = sweep(qdev, self._graph.vectors, k, self.config.metric,
                     n_valid=self.n_nodes, deleted=dead)
        return self._answers(d, i)

    @_read_locked
    def pq_sweep_search(self, queries, k: int, pool: Optional[int] = None,
                        excluded=None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compressed brute-force k-NN (ops/pq_sweep.py): a sweep over the
        rows' PQ codes keeps the ``pool`` best per query by the decoded
        distance, and the exact distance on the stored rows reranks them.
        Approximate (PQ distortion can keep a true neighbour out of the
        pool), but every returned distance is exact; ``pool`` prices
        recall.  It needs no graph.  ``pool`` defaults to pq_sweep_pool,
        else min(max(4k, k + 28), 256), and is rounded up to a power of
        two >= k.  Tombstones and ``excluded`` rows are skipped.  Returns
        (dists, labels, valid) like search()."""
        qdev = self._queries(queries)
        codes = self._ensure_pq_codes()
        dead = (self._graph.deleted if excluded is None
                else self._graph.deleted | excluded)
        if pool is None:
            pool = (self.pq_sweep_pool if self.pq_sweep_pool
                    else min(max(4 * k, k + 28), 256))
        pool = 1 << (max(int(pool), int(k)) - 1).bit_length()
        d, i = _pq_sweep(qdev, codes, self._pq_codebook, self._pq_rot,
                         self._graph.vectors, k, self.config.metric,
                         n_valid=self.n_nodes, deleted=dead, pool=pool)
        return self._answers(d, i)

    # ------------------------------------------------------------------ #
    # delete / vacuum (tombstones)
    # ------------------------------------------------------------------ #

    def _tombstone(self, newly: np.ndarray) -> int:
        idxs = np.nonzero(newly)[0]
        if len(idxs):
            if self._wal is not None and not self._wal_replaying:
                # canonical WAL form is labels (the TID analog)
                self._wal.log_delete(self._labels[idxs])
            self._graph.deleted[torch.as_tensor(idxs, device=self.device)] = True
        self.counters["n_deleted"] += len(idxs)
        self._maybe_auto_checkpoint()
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

    def tune_ef_search(self, queries, target_recall: float = 0.95,
                       k: int = 10, max_ef: int = 4096,
                       strict: bool = False) -> TuneResult:
        """Find (and set) the smallest power-of-two efSearch whose graph-mode
        recall@k on ``queries`` meets ``target_recall`` against the exact
        oracle — the ef/beam autotuner.

        Returns TuneResult(ef, recall, met); config.ef_search is set to the
        chosen ef either way (the best available if the target was missed).
        ``strict=True`` raises TuneTargetMissed instead of returning an
        unmet result."""
        queries = self._check_dims(queries)

        def probe(ef):
            _, i = self.search_ids(queries, ef)
            it = torch.as_tensor(i, device=self.device)
            alive = self._alive(self._graph.deleted, it).cpu().numpy()
            return self._labels[np.maximum(i, 0)], alive

        res = self._tune_pow2(queries, k, target_recall,
                              max(self.config.ef_search, k),
                              min(max_ef, max(self.n_nodes, 1)), probe,
                              strict, f"ef (max_ef={max_ef})")
        self.set_ef_search(res.ef)
        return res

    def _tune_pow2(self, queries, k: int, target_recall: float, start: int,
                   stop: int, probe, strict: bool, what: str) -> TuneResult:
        """The shared loop of the tuners: powers of two p from the one at
        or above ``start`` while p <= ``stop``, until recall@k of
        ``probe(p)`` -> (labels [B, *], valid [B, *]) against the exact
        route meets ``target_recall``.  Returns TuneResult(p, recall, met)
        for the last p tried; ``strict`` raises TuneTargetMissed on a
        miss, naming ``what``."""
        _, ol, ov = self.exact_search(queries, k)
        p = 1 << (int(start) - 1).bit_length()
        best, achieved = p, 0.0
        while p <= stop:
            labels, valid = probe(p)
            recs = []
            for r in range(queries.shape[0]):
                want = set(ol[r][ov[r]][:k].tolist())
                got = set(labels[r][valid[r]][:k].tolist())
                recs.append(len(got & want) / max(len(want), 1))
            best, achieved = p, float(np.mean(recs))
            if achieved >= target_recall:
                break
            p *= 2
        met = achieved >= target_recall
        if strict and not met:
            raise TuneTargetMissed(
                f"recall {achieved:.4f} at {best} misses target "
                f"{target_recall}: {what}")
        return TuneResult(best, achieved, met)

    def tune_sweep_pool(self, queries, target_recall: float = 0.95,
                        k: int = 10, max_pool: int = 1024,
                        strict: bool = False) -> TuneResult:
        """Find (and set) the smallest power-of-two sweep_pq pool whose
        recall@k on ``queries`` meets ``target_recall`` against the exact
        oracle — the pool analog of tune_ef_search.  Sets pq_sweep_pool
        and returns TuneResult(pool, recall, met); ``strict=True`` raises
        TuneTargetMissed on a miss."""
        queries = self._check_dims(queries)

        def probe(pool):
            return self.pq_sweep_search(queries, k, pool=pool)[1:]

        res = self._tune_pow2(queries, k, target_recall, max(2 * k, 16),
                              max_pool, probe, strict,
                              f"pool (max_pool={max_pool})")
        self.pq_sweep_pool = res.ef
        return res

    @_write_locked
    def downcast_corpus(self, dtype: str = "bfloat16") -> None:
        """Cast the resident corpus to a narrower storage dtype in place —
        the footprint transition for a built index.  Equivalent to
        ``storage_dtype="bfloat16"`` at construction, except that the graph
        and the derived shadows (int8 rows, packed records, the PQ
        codebook, rotation and codes) were computed from full-precision
        rows and are kept.  Lossy and one-way; later
        inserts and the exact sweep work in the narrow dtype (on CUDA the
        exact route runs the kernel's bf16 instantiation), and save()
        persists it."""
        if dtype != "bfloat16":
            if dtype == "float32":
                raise ValueError(
                    "cannot widen a downcast corpus back to float32 — "
                    "the dropped mantissa bits are gone; rebuild from "
                    "the source vectors")
            raise ValueError(f"unknown downcast dtype: {dtype!r}")
        if self.storage_dtype == dtype:
            return
        self.storage_dtype = dtype
        self._graph.vectors = self._graph.vectors.to(_STORAGE_DTYPES[dtype])

    @_read_locked
    def compact(self) -> "HnswIndex":
        """Rebuild the index over live (non-tombstoned) vectors only,
        reclaiming dead space — a capability the reference lacks entirely
        (space is never reclaimed, embedding.c:867-878).  Returns a NEW
        index on the same device with every knob carried over; self is
        untouched."""
        n = self.n_nodes
        alive = ~self._graph.deleted[:n].cpu().numpy()
        vecs = self._to_host(self._graph.vectors, n)[alive]
        labels = self._labels[:n][alive]
        fresh = HnswIndex(self.config, device=self.device,
                          max_insert_batch=self.max_insert_batch,
                          search_expand_width=self.search_expand_width,
                          build_expand_width=self.build_expand_width,
                          build_candidates=self.build_candidates,
                          storage_dtype=self.storage_dtype,
                          quantized_traversal=self.quantized_traversal,
                          packed_traversal=self.packed_traversal,
                          packed_dtype=self.packed_dtype,
                          pq_groups=self.pq_groups, pq_opq=self.pq_opq)
        for knob in ("exact_build_threshold", "exact8_build_threshold",
                     "build_cand_cap", "exact_threshold",
                     "exact_threshold_packed", "filter_exact_selectivity",
                     "max_widen_ef", "visited_mode", "pq_sweep_pool"):
            setattr(fresh, knob, getattr(self, knob))
        if len(vecs):
            fresh.build(vecs, labels)
        return fresh

    @_read_locked
    def check_integrity(self, raise_on_error: bool = True) -> Dict[str, int]:
        """Validate graph invariants — the debug-mode analog of the
        reference's runtime asserts: blank-slot / self-link / link-count
        bounds (hnswalg.cpp:170-177, 183-184, 190-191) plus id-range,
        duplicate-link and -1-padding discipline.  Returns violation
        counts."""
        n = self.n_nodes
        links = self._graph.links[:n].long()
        cnts = self._graph.link_counts[:n].long()
        slot = torch.arange(self.config.max_m, device=links.device)
        in_range = slot < cnts.unsqueeze(1)
        node = torch.arange(n, device=links.device).unsqueeze(1)
        # duplicates among a row's first cnt links: out-of-range slots get
        # distinct sentinels below every id, then equal neighbours after a
        # sort are duplicates
        keyed = torch.where(in_range, links, -(1 << 40) - slot)
        srt = torch.sort(keyed, dim=1).values
        viol = {
            "count_over_maxm": int((cnts > self.config.max_m).sum()),
            "self_links": int(((links == node) & in_range).sum()),
            "bad_ids": int((((links < 0) | (links >= n)) & in_range).sum()),
            "dup_links": int((srt[:, 1:] == srt[:, :-1]).sum()),
            "pad_violations": int(((links != -1) & ~in_range).sum()),
        }
        if raise_on_error and any(viol.values()):
            raise AssertionError(f"graph integrity violations: {viol}")
        return viol

    @_read_locked
    def vacuum(self) -> Dict[str, int]:
        """Stats only — space is never reclaimed (amvacuumcleanup,
        embedding.c:867-878)."""
        n = self.n_nodes
        dead = int(self._graph.deleted[:n].sum())
        return {"num_nodes": n, "num_live": n - dead, "num_dead": dead,
                "capacity": self._graph.capacity}

    # ------------------------------------------------------------------ #
    # durability (save/load, WAL)
    # ------------------------------------------------------------------ #

    def enable_wal(self, path: str,
                   auto_checkpoint_bytes: Optional[int] = None,
                   snapshot_path: Optional[str] = None) -> None:
        """Enable the write-ahead delta log — the GenericXLog analog
        (embedding.c:651-686): every add()/delete() is appended and fsync'd
        BEFORE the device mutation, so a crash between save() snapshots
        loses nothing acknowledged.  load(snapshot, wal=path) replays the
        records appended after the snapshot (see wal.py).

        ``auto_checkpoint_bytes``: once the log passes this size, the next
        completed add()/delete() snapshots to ``snapshot_path`` (default
        ``path + ".ckpt.npz"``), which truncates the log.  Recovery after a
        crash: ``load(snapshot_path, wal=path)``.  None keeps checkpoints
        manual."""
        self._wal = walmod.WalWriter(path, self.config)
        self._wal_auto_bytes = (int(auto_checkpoint_bytes)
                                if auto_checkpoint_bytes else None)
        self._wal_snapshot_path = snapshot_path or (path + ".ckpt.npz")

    def _maybe_auto_checkpoint(self) -> None:
        """Called AFTER a mutation is applied on the device: every logged
        record is covered by device state, so the snapshot+truncate pair
        is loss-free."""
        if (self._wal is not None and not self._wal_replaying
                and self._wal_auto_bytes is not None
                and self._wal.tell() >= self._wal_auto_bytes):
            self.save(self._wal_snapshot_path)

    @staticmethod
    def _to_host(t: torch.Tensor, n: int, rows: int = 1 << 20) -> np.ndarray:
        """The first n rows of a device tensor as host numpy, copied in
        bounded chunks; bf16 rows widen (losslessly) to float32, which
        numpy can hold."""
        dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        out = torch.empty((n,) + tuple(t.shape[1:]), dtype=dt)
        for off in range(0, n, rows):
            hi = min(off + rows, n)
            out[off:hi] = t[off:hi]
        return out.numpy()

    @_read_locked
    def save(self, path: str, compressed: Optional[bool] = None,
             truncate_wal: bool = True) -> None:
        """Serialize the full index state in the JAX package's npz format.
        Like the reference, everything except the arrays is re-derived from
        config on load (embedding.c:58-64).  The snapshot is written
        atomically (tmp + fsync + rename).

        With a WAL enabled, the snapshot records the WAL (epoch, offset) so
        load(wal=...) replays only the tail; with ``truncate_wal`` the log
        is then truncated to a new epoch, and the snapshot also records the
        predicted post-truncation position, so a crash on either side of
        the truncation replays exactly the un-snapshotted tail.

        ``compressed``: None compresses only indexes under ~1 GB."""
        path = _npz_path(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        n = self.n_nodes
        g = self._graph
        do_truncate = truncate_wal and self._wal is not None
        payload = dict(
            format_version=np.int64(_SAVE_FORMAT_VERSION),
            wal_offset=np.int64(self._wal.tell() if self._wal is not None
                                else -1),
            wal_epoch=np.int64(self._wal.epoch if self._wal is not None
                               else -1),
            storage_dtype=np.frombuffer(
                self.storage_dtype.encode(), dtype=np.uint8),
            config=np.frombuffer(
                json.dumps(self.config.to_dict()).encode(), dtype=np.uint8),
            vectors=self._to_host(g.vectors, n),
            links=self._to_host(g.links, n),
            link_counts=self._to_host(g.link_counts, n),
            deleted=self._to_host(g.deleted, n),
            labels=self._labels[:n],
        )
        if do_truncate:
            nxt = self._wal.epoch + 1
            payload["wal_epoch_next"] = np.int64(nxt)
            payload["wal_offset_next"] = np.int64(self._wal.header_len(nxt))
        if self._pq_codebook is not None:
            # the trained dictionary, so load() serves PQ without a retrain
            # and with the same codes
            payload["pq_codebook"] = self._pq_codebook.cpu().numpy()
            payload["pq_groups_trained"] = np.int64(
                self._pq_codebook.shape[0])
            if self._pq_rot is not None:
                payload["pq_rot"] = self._pq_rot.cpu().numpy()
        if compressed is None:
            compressed = payload["vectors"].nbytes < (1 << 30)
        _atomic_savez(path, payload, compressed)
        if do_truncate:
            # the covering snapshot is durable; reclaim the replayed prefix
            self._wal.truncate(self._wal.epoch + 1)

    @classmethod
    def load(cls, path: str, config: Optional[HnswConfig] = None,
             wal: Optional[str] = None, device="cuda") -> "HnswIndex":
        """Restore an index onto ``device``.  If ``config`` is given, its
        frozen fields {dims, maxM, metric} must match the stored ones — the
        metadata-guard analog (embedding.c:594-602); ef* knobs may differ
        freely.

        ``wal``: path of the write-ahead delta log; records appended after
        the snapshot's stored position are replayed (crash recovery), then
        the log stays enabled on the restored index."""
        with np.load(_npz_path(path)) as z:
            wal_offset = int(z["wal_offset"]) if "wal_offset" in z else -1
            wal_epoch = int(z["wal_epoch"]) if "wal_epoch" in z else None
            wal_next = (int(z["wal_epoch_next"]),
                        int(z["wal_offset_next"])) \
                if "wal_epoch_next" in z else None
            if int(z["format_version"]) != _SAVE_FORMAT_VERSION:
                raise ValueError("unsupported index format version")
            stored = HnswConfig.from_dict(
                json.loads(bytes(z["config"]).decode()))
            if config is not None:
                if config.frozen_fields() != stored.frozen_fields():
                    raise ValueError(
                        "index was built with different options "
                        "(dims/m/metric are frozen; only ef* may change)")
                cfg = config
            else:
                cfg = stored
            storage_dtype = (bytes(z["storage_dtype"]).decode()
                             if "storage_dtype" in z else "float32")
            arrays = {key: z[key] for key in ("vectors", "links",
                                              "link_counts", "deleted",
                                              "labels")}
            pq = {key: z[key] for key in ("pq_codebook", "pq_groups_trained",
                                          "pq_rot") if key in z}

        n = arrays["vectors"].shape[0]
        idx = cls(cfg, device=device, initial_capacity=max(n, 32),
                  storage_dtype=storage_dtype)
        cap = idx._graph.capacity
        # free the constructor's empty graph before uploading the real one
        idx._graph = None

        def upload(key, fill, dtype):
            host = torch.full((cap,) + arrays[key].shape[1:], fill,
                              dtype=dtype)
            host[:n] = torch.from_numpy(np.asarray(arrays[key]))
            return host.to(idx.device)

        deleted = upload("deleted", False, torch.bool)
        idx._graph = GraphState(
            vectors=upload("vectors", 0.0, _STORAGE_DTYPES[storage_dtype]),
            links=upload("links", -1, torch.int32),
            link_counts=upload("link_counts", 0, torch.int32),
            deleted=deleted, n_nodes=n)
        idx._labels[:n] = arrays["labels"]
        idx.counters["n_inserted"] = n
        # live tombstone count (exact_search drops the mask operand when
        # it is zero)
        idx.counters["n_deleted"] = int(arrays["deleted"].sum())
        if "pq_codebook" in pq:
            idx._pq_codebook = torch.as_tensor(
                pq["pq_codebook"], dtype=torch.float32, device=idx.device)
            idx.pq_groups = int(pq["pq_groups_trained"])
            if "pq_rot" in pq:
                idx._pq_rot = torch.as_tensor(
                    pq["pq_rot"], dtype=torch.float32, device=idx.device)
                idx.pq_opq = True
        if wal is not None:
            idx._replay_wal(wal, wal_offset, wal_epoch, wal_next)
        return idx

    @staticmethod
    def _wal_replay_start(wal_path: str, from_offset: int,
                          snap_epoch, snap_next) -> Optional[int]:
        """Pick the replay start by comparing the WAL file's actual epoch
        with the snapshot's recorded pre-/post-truncation positions (see
        wal.py module doc).  Returns a byte offset or None (= whole log)."""
        if not os.path.exists(wal_path):
            return None
        file_epoch = int(walmod.read_header(wal_path).get("epoch", 0))
        if snap_next is not None and file_epoch == snap_next[0]:
            return snap_next[1]       # truncation completed before the crash
        if snap_epoch is None or snap_epoch < 0:
            # legacy snapshot (no epoch recorded): offsets are only valid
            # against a never-truncated (epoch-0) log
            if file_epoch != 0:
                raise ValueError(
                    f"WAL {wal_path} is at epoch {file_epoch} but the "
                    f"snapshot predates WAL epochs; the tail this snapshot "
                    f"needs was truncated by a later save()")
            return from_offset if from_offset >= 0 else None
        if file_epoch == snap_epoch:
            return from_offset        # crash before the truncation (or none)
        raise ValueError(
            f"WAL {wal_path} is at epoch {file_epoch} but the snapshot "
            f"recorded epoch {snap_epoch}: the log was truncated by a "
            f"LATER snapshot — load that snapshot instead")

    def _replay_wal(self, wal_path: str, from_offset: int,
                    snap_epoch=None, snap_next=None) -> None:
        """Apply WAL records past the snapshot position, then reopen the log
        for appending (the recovered index keeps journaling)."""
        start = self._wal_replay_start(wal_path, from_offset, snap_epoch,
                                       snap_next)
        self._wal_replaying = True
        try:
            for op, labels, vectors in walmod.replay(
                    wal_path, self.config.dims, start):
                if op == walmod.OP_INSERT:
                    self.add(vectors, labels)
                elif op == walmod.OP_DELETE:
                    self.delete(labels)
        finally:
            self._wal_replaying = False
        self.enable_wal(wal_path)

    # ------------------------------------------------------------------ #
    # knobs
    # ------------------------------------------------------------------ #

    def set_ef_search(self, ef_search: int) -> None:
        """ALTER INDEX ... SET (efsearch=...) — the only legal live
        mutation besides ef_construction (embedding.c:594-602)."""
        self.config = self.config.with_ef(ef_search=ef_search)

    def set_ef_construction(self, ef_construction: int) -> None:
        self.config = self.config.with_ef(ef_construction=ef_construction)


class HnswScan:
    """Pull-model scan cursor over one query — HnswScanOpaqueData + the
    hnsw_gettuple state machine (embedding.c:100-107, 284-366).

    State: the current result cache, the set of node ids already returned
    (the sorted-TID dedup array analog), the current ef, and the
    ``no_more_results`` flag (embedding.c:322, 338-343).  Created via
    HnswIndex.open_scan()."""

    def __init__(self, index: HnswIndex, query: np.ndarray, ef: int,
                 where) -> None:
        self._idx = index
        self._q = torch.as_tensor(query, device=index.device)   # [1, D]
        self._ef = ef
        # the where-filter is snapshotted at open (rescan to refresh);
        # tombstones are re-read per fetch so concurrent deletes are seen
        self._excluded, _ = index._filter_to_excluded(where)
        self._buf_d: list = []                          # undelivered rows
        self._buf_l: list = []
        self._seen: set = set()                         # returned node ids
        self._no_more = False
        self._first = True

    def _dead_mask(self) -> torch.Tensor:
        """Current tombstone|filter mask, padded to the CURRENT capacity:
        rows inserted after open were never evaluated by the where-filter,
        so they stay excluded (snapshot semantics) while fresh tombstones
        are honored."""
        dead = self._idx._graph.deleted
        exc = self._excluded
        if exc is None:
            return dead
        if exc.shape[0] != dead.shape[0]:
            exc = torch.cat([exc, exc.new_ones(dead.shape[0] - exc.shape[0])])
            self._excluded = exc
        return dead | exc

    @property
    def exhausted(self) -> bool:
        """True once the graph can produce no further rows (the cache may
        still hold undelivered ones)."""
        return self._no_more and not self._buf_d

    def _fetch(self) -> None:
        """Run (or widen + re-run) the search, appending only new live rows
        to the cache — one iteration of the embedding.c:297-366 machine."""
        with self._idx._rwlock.read():
            self._fetch_locked()

    def _fetch_locked(self) -> None:
        idx = self._idx
        if not self._first:
            if self._ef >= min(max(idx.n_nodes, 1), idx.max_widen_ef):
                self._no_more = True
                return
            self._ef = idx._bucket_ef(self._ef * 2)
            idx.counters["n_widenings"] += 1
        dd, ii, stats = idx._graph_search(self._q, self._ef)
        alive = idx._alive(self._dead_mask(), ii)[0].cpu().numpy()
        d = dd[0].cpu().numpy()
        i = ii[0].cpu().numpy()
        idx._count_walk(1, stats)
        for pos in range(len(i)):
            node = int(i[pos])
            if node < 0 or not alive[pos] or node in self._seen:
                continue
            self._seen.add(node)
            self._buf_d.append(float(d[pos]))
            self._buf_l.append(idx._labels[node])
        # the graph is exhausted once a search cannot fill its RAW beam
        # (embedding.c:322's rule, applied before the filter, so a scan
        # starved by tombstones keeps widening — as the JAX package does)
        if int((i >= 0).sum()) < self._ef:
            self._no_more = True
        self._first = False

    def next(self, n: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Return up to ``n`` further (dists f32[m], labels u64[m]) rows,
        m <= n; m < n means the scan is exhausted.  Each row is returned
        exactly once across the scan's lifetime."""
        if n < 1:
            raise ValueError("next() needs n >= 1")
        while len(self._buf_d) < n and not self._no_more:
            self._fetch()
        m = min(n, len(self._buf_d))
        out_d = np.asarray(self._buf_d[:m], np.float32)
        out_l = np.asarray(self._buf_l[:m], np.uint64)
        del self._buf_d[:m], self._buf_l[:m]
        return out_d, out_l
