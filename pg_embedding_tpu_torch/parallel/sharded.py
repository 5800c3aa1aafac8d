"""Sharded index — the counterpart of pg_embedding_tpu/parallel/sharded.py.

The JAX package partitions the corpus round-robin over a 1-D device mesh:
each shard holds an independent flat-NSW sub-graph over its slice, a build
runs the batched insert on every shard, queries are replicated, and the
per-shard candidate sets are gathered and reduced to a global top-k.

Here the S shards live on ONE torch device.  The state keeps the JAX
package's stacked form — vectors [S, cap, D], links [S, cap, maxM],
link_counts [S, cap], deleted [S, cap] — and shard i is a ``GraphState``
whose tensors are the views ``stack[i]`` (contiguous, so the exact
kernel's wrapper takes them as they are).  What the JAX package compiles
as one ``shard_map`` program per step is a Python loop over the shards that
calls the single-index core functions (core/build.insert_batch_core,
core/search.search_graph, ops/cuda_bruteforce.fused_exact_search,
ops/pq_sweep.pq_sweep_search); its all-gather is a ``torch.stack`` and its
merge (``_topk_merge`` / ``_gather_merge``) a stable sort.  On a CUDA
device the exact route therefore launches the sweep kernel once per shard
and page.

Everything a user can observe follows the JAX class: round-robin
assignment continuing from the global count, default labels from
``counters["n_inserted"]``, per-shard capacities (``_pad_cap``), global
handles ``gid = shard * cap + idx``, filters by label or by global insert
position, tombstones filtered on the shard before the merge, widening
gated by the max over shards of the live result counts, one logical WAL,
and the monolithic / per-shard npz snapshots, which either package reads.
Labels, insert positions and per-shard counts stay in host numpy.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import wal as walmod
from ..api import (_STORAGE_DTYPES, HnswIndex, _atomic_savez,
                   _graph_violations, _IndexBase, _npz_path, _read_locked,
                   _ScanBase, _tune_pow2, _write_locked)
from ..config import HnswConfig, Metric
from ..core.build import insert_batch_core, quantize_rows
from ..core.graph import GraphState, pack_records
from ..core.search import search_graph, search_graph_pq
from ..ops.bruteforce import min_k
from ..ops.cuda_bruteforce import fused_exact_search
from ..ops.pq import pack_pq_records, pq_encode, train_opq, train_pq
from ..ops.pq_sweep import pq_sweep_search as _pq_sweep
from ..utils.locking import RWLock

_INF = float("inf")


def _topk_merge(all_d: torch.Tensor, all_g: torch.Tensor, k: int):
    """Reduce per-shard candidate sets [S, B, w] to [B, k], padded with
    +inf/-1 when fewer than k candidates exist.  The sets are flattened
    shard-major and the k smallest taken with a stable sort, so ties keep
    the lower (shard, slot) — the order ``lax.top_k`` gives."""
    s, b, w = all_d.shape
    flat_d = all_d.movedim(0, 1).reshape(b, s * w)
    flat_g = all_g.movedim(0, 1).reshape(b, s * w)
    kk = min(k, s * w)
    d, sel = min_k(flat_d, kk)
    g = torch.gather(flat_g, 1, sel)
    if kk < k:
        d = torch.cat([d, d.new_full((b, k - kk), _INF)], dim=1)
        g = torch.cat([g, g.new_full((b, k - kk), -1)], dim=1)
    return d, g


def _gather_merge(d: torch.Tensor, gid: torch.Tensor, k: int, n_shards: int,
                  dcn_slices: Optional[int] = None):
    """Reduce the stacked per-shard sets (d, gid) [S, B, w] to the global
    top-k [B, k].  Flat (``dcn_slices`` None or 1): one merge over all
    shards.  Hierarchical (``dcn_slices`` > 1, the JAX package's
    multi-slice layout): the groups of S / dcn_slices consecutive shards
    reduce to k first, then the group results merge in slice order."""
    if not dcn_slices or dcn_slices <= 1:
        return _topk_merge(d, gid, k)
    per = n_shards // dcn_slices
    firsts = [_topk_merge(d[s * per:(s + 1) * per],
                          gid[s * per:(s + 1) * per], k)
              for s in range(dcn_slices)]
    return _topk_merge(torch.stack([f[0] for f in firsts]),
                       torch.stack([f[1] for f in firsts]), k)


class ShardedHnswIndex(_IndexBase):
    """Data-parallel sharded flat-NSW index: ``n_shards`` independent
    sub-graphs on one torch device, searched together.

    ``device`` defaults to "cuda"; the CPU runs only when asked for.  The
    thread-safety contract is HnswIndex's (MURSIW)."""

    def __init__(self, config: HnswConfig, n_shards: int = 1, *,
                 device="cuda",
                 initial_capacity: int = 1024,
                 max_insert_batch: int = 128,
                 search_expand_width: int = 4,
                 build_expand_width: int = 8,
                 build_candidates: str = "auto",
                 storage_dtype: str = "float32",
                 quantized_traversal: bool = False,
                 packed_traversal: bool = False,
                 packed_dtype: str = "int8",
                 pq_groups: int = 16,
                 pq_opq: bool = False,
                 dcn_slices: Optional[int] = None) -> None:
        self.config = config
        self.device = torch.device(device)
        self.search_expand_width = int(search_expand_width)
        # beam expansion width for construction searches ("beam" mode)
        self.build_expand_width = int(build_expand_width)
        # construction candidates as in HnswIndex; every threshold is PER
        # SHARD: each shard sweeps only its slice
        if build_candidates not in ("auto", "beam", "exact", "exact8"):
            raise ValueError(
                f"unknown build_candidates: {build_candidates!r}")
        self.build_candidates = build_candidates
        self.exact_build_threshold = 0
        self.exact8_build_threshold: Optional[int] = None
        self.build_cand_cap: Optional[int] = None
        # slab grains (batches per slab) of the JAX package's bulk insert.
        # Batches are dispatched one by one here, but the candidate mode is
        # still resolved once per slab of this schedule, so both packages
        # switch engines at the same rows.
        self.slab_batches = (128, 16)
        # per-shard routing crossovers (see _use_exact), inherited from the
        # JAX package so that both route the same calls
        self.exact_threshold = 5_500_000
        self.exact_threshold_packed = 2_700_000
        # below this allowed fraction, auto mode serves ``where=`` through
        # the masked exact sweep
        self.filter_exact_selectivity = 0.75
        # widening-loop ceiling (see HnswIndex.max_widen_ef)
        self.max_widen_ef = 4096
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be at least 1")
        # merge topology: groups of S / dcn_slices shards reduce first (see
        # _gather_merge); None/1 = flat.  The answers do not depend on it.
        if dcn_slices is not None and (
                dcn_slices < 1 or self.n_shards % dcn_slices):
            raise ValueError(
                f"dcn_slices={dcn_slices} must divide the mesh's "
                f"{self.n_shards} devices")
        self.dcn_slices = dcn_slices
        self.max_insert_batch = int(max_insert_batch)
        if storage_dtype not in _STORAGE_DTYPES:
            raise ValueError(f"unknown storage_dtype: {storage_dtype!r}")
        self.storage_dtype = storage_dtype
        # serving variants as in HnswIndex, with per-shard shadows: int8
        # rows (quantized_traversal) or packed neighbour records
        # (packed_traversal) of packed_dtype "int8", "bfloat16", "float32"
        # (no rerank: the walk equals the plain walk) or "pq".  The PQ
        # codebook is GLOBAL: trained once on a cross-shard sample, so every
        # shard compresses against one dictionary.
        self.quantized_traversal = bool(quantized_traversal)
        self._quant = None   # (qvec i8[S, cap, D], qscale f32[S, cap])
        self.packed_traversal = bool(packed_traversal)
        if packed_dtype not in ("int8", "bfloat16", "float32", "pq"):
            raise ValueError(f"unknown packed_dtype: {packed_dtype!r}")
        if packed_dtype == "pq" and config.dims % int(pq_groups):
            raise ValueError(
                f"dims {config.dims} not divisible by pq_groups {pq_groups}")
        self.packed_dtype = packed_dtype
        self.pq_groups = int(pq_groups)
        if pq_opq and config.metric == Metric.MANHATTAN:
            raise ValueError(
                "pq_opq requires a rotation-invariant metric (l2/cosine); "
                "manhattan distances change under rotation")
        self.pq_opq = bool(pq_opq)
        self._pq_rot: Optional[torch.Tensor] = None
        self.pq_train_sample = 131_072
        self.pq_train_iters = 12
        self._pq_codebook: Optional[torch.Tensor] = None
        # (records [S, cap, maxM, W], scales f32[S, cap, maxM] or None)
        self._packed = None
        self._pq_codes: Optional[torch.Tensor] = None   # u8[S, cap, G]
        # sweep_pq coarse-pool width per shard: None = per-call default;
        # tune_sweep_pool sets it from a recall target
        self.pq_sweep_pool: Optional[int] = None
        # int8 row shadow of the exact8 candidate engine, stacked per
        # shard: valid iff _qvec_counts equals the counts it describes
        self._qvec: Optional[torch.Tensor] = None       # i8[S, cap, D]
        self._qscale: Optional[torch.Tensor] = None     # f32[S, cap]
        self._qvec_counts: Optional[np.ndarray] = None

        cap = self._pad_cap(initial_capacity)
        s = self.n_shards
        self._set_stack(
            torch.zeros((s, cap, config.dims),
                        dtype=_STORAGE_DTYPES[storage_dtype],
                        device=self.device),
            torch.full((s, cap, config.max_m), -1, dtype=torch.int32,
                       device=self.device),
            torch.zeros((s, cap), dtype=torch.int32, device=self.device),
            torch.zeros((s, cap), dtype=torch.bool, device=self.device),
            np.zeros((s,), np.int64))
        self._labels = np.zeros((s, cap), np.uint64)
        # global insert position of each (shard, slot): lets position-mask
        # filters (the single index's bool ``where``) address sharded rows
        self._positions = np.full((s, cap), -1, np.int64)
        self.counters: Dict[str, int] = {"n_inserted": 0, "n_deleted": 0,
                                         "n_searches": 0, "n_widenings": 0}
        # ONE logical write-ahead log for the whole index: records are
        # logical (vectors + labels) and replay re-runs the deterministic
        # round-robin partitioning
        self._wal: Optional[walmod.WalWriter] = None
        self._wal_replaying = False
        self._wal_auto_bytes: Optional[int] = None
        self._wal_snapshot_path: Optional[str] = None
        self._rwlock = RWLock()

    def _set_stack(self, vectors, links, link_counts, deleted,
                   counts) -> None:
        """Install the stacked tensors and the host counts, and cut the
        per-shard GraphState views over them."""
        self._vectors = vectors
        self._links = links
        self._link_counts = link_counts
        self._deleted = deleted
        self._counts = np.asarray(counts, np.int64).copy()
        self._graphs: List[GraphState] = [
            GraphState(vectors=vectors[i], links=links[i],
                       link_counts=link_counts[i], deleted=deleted[i],
                       n_nodes=int(self._counts[i]))
            for i in range(self.n_shards)]

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    @staticmethod
    def _pad_cap(cap: int) -> int:
        # multiples of 32 for the visited bitmap; above 8192, multiples of
        # 8192 (the JAX package's exact-sweep tiling), so both packages
        # hold the same capacities
        cap = max(int(cap), 32)
        if cap > 8192:
            return ((cap + 8191) // 8192) * 8192
        return ((cap + 31) // 32) * 32

    @property
    def capacity_per_shard(self) -> int:
        return self._vectors.shape[1]

    @property
    def shard_counts(self) -> np.ndarray:
        return self._counts.copy()

    @property
    def n_nodes(self) -> int:
        return int(self._counts.sum())

    def __len__(self) -> int:
        return self.n_nodes

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #

    def _quantize_stack(self, counts: np.ndarray):
        """int8 rows and scales of every shard, (i8[S, cap, D], f32[S,
        cap]); rows past a shard's count quantize as zeros."""
        s, cap, dims = self._vectors.shape
        live = (torch.arange(cap, device=self.device).unsqueeze(0) <
                torch.as_tensor(counts, device=self.device).unsqueeze(1))
        v = torch.where(live.unsqueeze(2), self._vectors.to(torch.float32),
                        0.0)
        q, scale = quantize_rows(v.view(s * cap, dims))
        return q.view(s, cap, dims), scale.view(s, cap)

    def _sync_shadow(self, counts_now: np.ndarray) -> None:
        """Bring the int8 row shadow up to the current rows if it is
        missing or stale (one full quantize pass — at the first exact8 slab
        or after growth / other slabs; appended rows never change, so
        incremental staging equals a full requantization thereafter)."""
        if self._qvec is None or not np.array_equal(self._qvec_counts,
                                                    counts_now):
            self._qvec, self._qscale = self._quantize_stack(counts_now)
            self._qvec_counts = counts_now.copy()

    @_write_locked
    def add(self, vectors, labels=None) -> None:
        """Round-robin partition, then batched inserts into every shard.

        Each shard's row stream is cut into batches of max_insert_batch;
        a ragged tail is inserted as a shorter batch (the JAX package pads
        it with masked zero rows, which no candidate set ever sees), and a
        shard with no row left in a batch is skipped."""
        vectors = self._check_dims(vectors)
        n = vectors.shape[0]
        if labels is None:
            base_label = self.counters["n_inserted"]
            labels = np.arange(base_label, base_label + n, dtype=np.uint64)
        else:
            labels = np.asarray(labels, np.uint64).reshape(-1)
            if labels.shape[0] != n:
                raise ValueError("labels/vectors length mismatch")
        if self._wal is not None and not self._wal_replaying:
            # write-ahead: durable before any device mutation
            self._wal.log_insert(vectors, labels)

        s = self.n_shards
        counts = self.shard_counts
        # round-robin over shards, continuing from the global position
        start = int(counts.sum())
        assign = (start + np.arange(n)) % s
        per_shard = [np.nonzero(assign == i)[0] for i in range(s)]
        per_n = np.array([len(p) for p in per_shard])

        # capacity check / growth, with one batch of slack per shard (the
        # JAX package stages full-width batches), so capacities agree
        need = counts + per_n + self.max_insert_batch
        if need.max() > self.capacity_per_shard:
            self._grow(int(need.max()))

        for i in range(s):
            self._labels[i, counts[i]: counts[i] + per_n[i]] = \
                labels[per_shard[i]]
            self._positions[i, counts[i]: counts[i] + per_n[i]] = \
                start + per_shard[i]

        # slab schedule over the longest per-shard stream: (offset, batches)
        max_off = int(per_n.max())
        b = self.max_insert_batch
        big, small = self.slab_batches
        schedule = []
        off = 0
        while max_off - off >= big * b:
            schedule.append((off, big))
            off += big * b
        while off < max_off:
            schedule.append((off, small))
            off += min(small * b, max_off - off)

        # the serving shadows are stale from the first inserted row on
        self._packed = None
        self._quant = None
        self._pq_codes = None
        cfg = self.config
        pts = torch.as_tensor(vectors, device=self.device)
        for soff, nb in schedule:
            mode, cap = self._candidate_mode(int(counts.min()) + soff)
            if mode == "exact8":
                self._sync_shadow(counts + np.minimum(soff, per_n))
            for i, graph in enumerate(self._graphs):
                take = per_shard[i][soff: soff + nb * b]
                rows = pts[torch.as_tensor(take, device=self.device)]
                for boff in range(0, len(take), b):
                    chunk = rows[boff: boff + b]
                    qvec = qscale = None
                    if mode == "exact8":
                        # stage the batch's codes before its sweep, so
                        # later batches see them as candidates
                        base = graph.n_nodes
                        qvec, qscale = self._qvec[i], self._qscale[i]
                        q, sc = quantize_rows(chunk)
                        qvec[base: base + len(chunk)] = q
                        qscale[base: base + len(chunk)] = sc
                    insert_batch_core(
                        graph, chunk, len(chunk),
                        ef_construction=cfg.ef_construction, m=cfg.m,
                        max_m=cfg.max_m, metric_value=cfg.metric.value,
                        cand_cap=cap, expand_width=self.build_expand_width,
                        candidates=mode, qvec=qvec, qscale=qscale)
            if mode == "exact8":
                self._qvec_counts = counts + np.minimum(soff + nb * b,
                                                        per_n)
        self._counts = counts + per_n
        self.counters["n_inserted"] += n
        # the int8 row shadow survives the add iff exact8 slabs staged
        # every inserted row
        if self._qvec is not None and not np.array_equal(self._qvec_counts,
                                                         self._counts):
            self._qvec = None
            self._qscale = None
            self._qvec_counts = None
        self._maybe_auto_checkpoint()

    @_write_locked
    def build(self, vectors, labels=None) -> None:
        vectors = self._check_dims(vectors)
        if self.n_nodes != 0:
            raise RuntimeError("build() requires an empty index; use add()")
        per = -(-vectors.shape[0] // self.n_shards) + self.max_insert_batch
        if per > self.capacity_per_shard:
            self._grow(per)
        self.add(vectors, labels)

    def _grow(self, new_cap: int) -> None:
        new_cap = self._pad_cap(max(new_cap, self.capacity_per_shard * 2))
        s = self.n_shards
        old = self.capacity_per_shard

        def padded(t: torch.Tensor, fill) -> torch.Tensor:
            out = torch.full((s, new_cap) + tuple(t.shape[2:]), fill,
                             dtype=t.dtype, device=t.device)
            out[:, :old] = t
            return out

        self._set_stack(padded(self._vectors, 0), padded(self._links, -1),
                        padded(self._link_counts, 0),
                        padded(self._deleted, False), self._counts)
        nlab = np.zeros((s, new_cap), np.uint64)
        nlab[:, :old] = self._labels
        self._labels = nlab
        npos = np.full((s, new_cap), -1, np.int64)
        npos[:, :old] = self._positions
        self._positions = npos
        self._packed = None
        self._quant = None
        self._pq_codes = None
        # capacity-shaped shadow: rebuilt at the new capacity by the next
        # exact8 slab (or quantized search)
        self._qvec = None
        self._qscale = None
        self._qvec_counts = None

    # ------------------------------------------------------------------ #
    # serving shadows
    # ------------------------------------------------------------------ #

    def _ensure_pq_codebook(self) -> torch.Tensor:
        """Train the global PQ codebook (and, with pq_opq, the rotation)
        once, on a strided sample of pq_train_sample / S rows of each
        shard, concatenated in shard order."""
        if self._pq_codebook is None:
            per = max(1, self.pq_train_sample // max(self.n_shards, 1))
            rows = []
            for i in range(self.n_shards):
                n_i = int(self._counts[i])
                if n_i:
                    stride = max(1, n_i // per)
                    rows.append(
                        self._vectors[i, :n_i:stride].to(torch.float32))
            sample = (torch.cat(rows) if rows
                      else torch.zeros((1, self.config.dims),
                                       device=self.device))
            if self.pq_opq:
                self._pq_rot, self._pq_codebook = train_opq(
                    sample, groups=self.pq_groups,
                    pq_iters=self.pq_train_iters)
            else:
                self._pq_codebook = train_pq(sample, groups=self.pq_groups,
                                             iters=self.pq_train_iters)
        return self._pq_codebook

    def _ensure_pq_codes(self) -> torch.Tensor:
        """Per-row PQ codes u8[S, cap, G] against the global codebook (and
        rotation): what the compressed sweep streams and the PQ records
        are packed from."""
        if self._pq_codes is None:
            cb = self._ensure_pq_codebook()
            s, cap, dims = self._vectors.shape
            self._pq_codes = pq_encode(self._vectors.view(s * cap, dims),
                                       cb, self._pq_rot).view(s, cap, -1)
        return self._pq_codes

    def _ensure_packed(self):
        """(records [S, cap, maxM, W], scales or None) of packed_dtype."""
        if self._packed is None:
            links = self._links
            scales = None
            if self.packed_dtype == "pq":
                codes = self._ensure_pq_codes()
                recs = [pack_pq_records(codes[i], links[i])
                        for i in range(self.n_shards)]
            elif self.packed_dtype == "int8":
                qv, qs = self._ensure_quant()
                recs = [pack_records(qv[i], links[i])
                        for i in range(self.n_shards)]
                scales = torch.stack([qs[i][links[i].clamp(min=0)]
                                      for i in range(self.n_shards)])
            else:
                recs = [pack_records(self._vectors[i], links[i],
                                     _STORAGE_DTYPES[self.packed_dtype])
                        for i in range(self.n_shards)]
            self._packed = (torch.stack(recs), scales)
        return self._packed

    @_write_locked
    def downcast_corpus(self, dtype: str = "bfloat16") -> None:
        """Cast the stacked corpus to a narrower storage dtype in place
        AFTER building (and after any PQ training/encoding), keeping the
        graph and the derived shadows (see HnswIndex.downcast_corpus).
        Lossy and one-way."""
        if dtype not in ("bfloat16",):
            if dtype == "float32":
                raise ValueError(
                    "cannot widen a downcast corpus back to float32 — "
                    "the dropped mantissa bits are gone; rebuild from "
                    "the source vectors")
            raise ValueError(f"unknown downcast dtype: {dtype!r}")
        if self.storage_dtype == dtype:
            return
        self.storage_dtype = dtype
        self._set_stack(self._vectors.to(_STORAGE_DTYPES[dtype]),
                        self._links, self._link_counts, self._deleted,
                        self._counts)

    def _ensure_quant(self):
        if self._quant is None:
            # the exact8 build shadow IS the quantized-traversal shadow:
            # reuse it when it covers every live row
            if self._qvec is not None and np.array_equal(self._qvec_counts,
                                                         self._counts):
                self._quant = (self._qvec, self._qscale)
            else:
                self._quant = self._quantize_stack(self._counts)
        return self._quant

    def _traversal_variant(self) -> str:
        if self.packed_traversal:
            if self.packed_dtype == "pq":
                return "pq"
            if self.packed_dtype in ("float32", "bfloat16"):
                return "cast"
            return "packed"
        if self.quantized_traversal:
            return "quant"
        return "plain"

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #

    def _search_step(self, qdev: torch.Tensor,
                     excluded: Optional[torch.Tensor], ef: int, k_total: int):
        """One walk of every shard at beam ``ef`` plus the merge: (d f32[B,
        k_total], gid i64[B, k_total], found i64[B]) on the host.  Dead rows
        (tombstones | ``excluded``) are filtered on the shard before the
        merge.  ``found`` is the max over shards of the results each shard
        has left AFTER that filter, as the JAX package computes it (its
        comment says before): the widening gate continues while ANY shard
        filled its beam with live rows."""
        cfg = self.config
        cap = self.capacity_per_shard
        variant = self._traversal_variant()
        if variant in ("packed", "pq", "cast"):
            recs, scales = self._ensure_packed()
        elif variant == "quant":
            qv, qs = self._ensure_quant()
        dead_all = (self._deleted if excluded is None
                    else self._deleted | excluded)
        ds, gs, founds = [], [], []
        for i, graph in enumerate(self._graphs):
            kw = dict(ef=ef, metric_value=cfg.metric.value,
                      expand_width=self.search_expand_width)
            if variant == "pq":
                d, ids, _ = search_graph_pq(graph, qdev, recs[i],
                                            self._pq_codebook, self._pq_rot,
                                            **kw)
            else:
                if variant == "packed":
                    kw.update(pcodes=recs[i], pscales=scales[i])
                elif variant == "cast":
                    kw.update(pcodes=recs[i])
                elif variant == "quant":
                    kw.update(qvectors=qv[i], qscale=qs[i])
                d, ids, _ = search_graph(graph, qdev, **kw)
            ids = ids.long()
            real = ids >= 0
            dead = dead_all[i][ids.clamp(min=0)] & real
            ds.append(torch.where(dead, _INF, d))
            # local idx -> global handle: shard * cap + idx
            live = real & ~dead
            gs.append(torch.where(live, i * cap + ids, -1))
            founds.append(live.sum(dim=1))
        out_d, out_g = _gather_merge(torch.stack(ds), torch.stack(gs),
                                     k_total, self.n_shards, self.dcn_slices)
        found = torch.stack(founds).amax(dim=0)
        return (out_d.cpu().numpy(), out_g.cpu().numpy(),
                found.cpu().numpy())

    def _answers(self, d: torch.Tensor, g: torch.Tensor
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Merged (dists, gids) of a sweep as host (dists, labels, valid)."""
        d = d.cpu().numpy()
        g = g.cpu().numpy()
        cap = self.capacity_per_shard
        valid = (g >= 0) & np.isfinite(d)
        safe = np.maximum(g, 0)
        labels = np.where(valid, self._labels[safe // cap, safe % cap], 0)
        return d, labels.astype(np.uint64), valid

    def _sweep_shards(self, sweep, k: int, excluded):
        """Run ``sweep(shard, graph, dead bool[cap])`` -> (d, ids) [B, k] on
        every shard and merge to the global top-k.  ``excluded`` is the
        filter's device mask bool[S, cap], or None."""
        cap = self.capacity_per_shard
        dead_all = (self._deleted if excluded is None
                    else self._deleted | excluded)
        ds, gs = [], []
        for i, graph in enumerate(self._graphs):
            d, ids = sweep(i, graph, dead_all[i])
            ids = ids.long()
            ds.append(d)
            gs.append(torch.where(ids >= 0, i * cap + ids, -1))
        return self._answers(*_gather_merge(
            torch.stack(ds), torch.stack(gs), k, self.n_shards,
            self.dcn_slices))

    @_read_locked
    def pq_sweep_search(self, queries, k: int, pool: Optional[int] = None,
                        where=None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sharded compressed brute-force k-NN (see
        HnswIndex.pq_sweep_search): every shard sweeps its own codes and
        reranks its pool exactly, and the merge keeps the global top-k —
        approximate through the coarse pool, exact in the returned
        distances.  ``pool`` is per shard, rounded up to a power of two."""
        qdev = torch.as_tensor(self._check_dims(queries), device=self.device)
        codes = self._ensure_pq_codes()
        if pool is None:
            pool = (self.pq_sweep_pool if self.pq_sweep_pool
                    else min(max(4 * k, k + 28), 256))
        pool = 1 << (max(int(pool), int(k)) - 1).bit_length()
        k = int(k)

        def sweep(i, graph, dead):
            return _pq_sweep(qdev, codes[i], self._pq_codebook, self._pq_rot,
                             graph.vectors, k, self.config.metric,
                             n_valid=graph.n_nodes, deleted=dead, pool=pool)

        return self._sweep_shards(sweep, k, self._filter_to_excluded(where))

    def _filter_to_excluded(self, where) -> Optional[torch.Tensor]:
        """Search filter -> per-shard excluded bool[S, cap] on the device
        (None without a filter).  ``where`` is an array of allowed labels,
        or a bool mask over global INSERT POSITIONS (the single index's
        node-id mask form; positions are tracked per slot in
        self._positions)."""
        if where is None:
            return None
        return torch.as_tensor(self._filter_mask(where), device=self.device)

    def _filter_mask(self, where) -> np.ndarray:
        """Host form of _filter_to_excluded (the scan cursor snapshots
        it)."""
        cap = self.capacity_per_shard
        excluded = np.zeros((self.n_shards, cap), bool)
        if where is not None:
            where = np.asarray(where)
            counts = self._counts
            if where.dtype == bool:
                allowed_pos = where.reshape(-1)
                n = self.n_nodes
                if allowed_pos.shape[0] < n:
                    raise ValueError(
                        f"filter mask covers {allowed_pos.shape[0]} of {n} "
                        f"nodes")
                for i in range(self.n_shards):
                    pos = self._positions[i, : counts[i]]
                    excluded[i, : counts[i]] = ~allowed_pos[pos]
            else:
                allowed = where.astype(np.uint64)
                for i in range(self.n_shards):
                    excluded[i, : counts[i]] = ~np.isin(
                        self._labels[i, : counts[i]], allowed)
        return excluded

    @_read_locked
    def exact_search(self, queries, k: int, where=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sharded brute-force exact k-NN (the seq-scan ground truth,
        embedding.c:1022-1038), tombstones and filtered rows excluded: the
        fused sweep of every shard's rows (on CUDA the kernel, once per
        shard and page), then the merge."""
        return self._exact(queries, k, self._filter_to_excluded(where))

    def _exact(self, queries, k: int, excluded):
        """exact_search with the filter already a device mask (or None)."""
        qdev = torch.as_tensor(self._check_dims(queries), device=self.device)
        k = int(k)

        def sweep(i, graph, dead):
            return fused_exact_search(qdev, graph.vectors, k,
                                      self.config.metric,
                                      n_valid=graph.n_nodes, deleted=dead)

        return self._sweep_shards(sweep, k, excluded)

    def _use_exact(self, batch: int) -> bool:
        """Cost-based routing (see HnswIndex._use_exact): the exact sweep
        costs O(rows per shard), so the crossover applies per shard;
        packed traversal serves a faster walk and lowers it."""
        threshold = (self.exact_threshold_packed if self.packed_traversal
                     else self.exact_threshold)
        per_shard = self.n_nodes / max(self.n_shards, 1)
        return per_shard <= threshold and batch >= 32

    @_read_locked
    def search(self, queries, k: int, ef: Optional[int] = None,
               mode: str = "auto", where=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Global k-NN: per-shard beam search, merge, progressive
        ef-doubling when tombstones or a small ef starve a query (the
        hnsw_gettuple widening loop, embedding.c:329-366, applied to the
        merged result).  ``mode`` and ``where`` as in HnswIndex.search;
        a bool ``where`` is a mask over global insert positions."""
        queries = self._check_dims(queries)
        bq = queries.shape[0]
        if mode not in ("auto", "graph", "exact", "sweep_pq"):
            raise ValueError(f"unknown search mode: {mode!r}")
        if mode == "sweep_pq":
            self.counters["n_searches"] += bq
            return self.pq_sweep_search(queries, k, where=where)
        # selective filters route to the masked exact sweep (filtered
        # waypoints fill beam slots without surfacing; the sweep's cost does
        # not depend on selectivity)
        excluded = None
        n_allowed = self.n_nodes
        if where is not None:
            host_mask = self._filter_mask(where)
            n_allowed -= int(host_mask.sum())
            excluded = torch.as_tensor(host_mask, device=self.device)
        selective = (where is not None and
                     n_allowed < self.filter_exact_selectivity
                     * max(self.n_nodes, 1))
        if mode == "exact" or (mode == "auto"
                               and (self._use_exact(bq) or selective)):
            self.counters["n_searches"] += bq
            self.counters["n_exact_routed"] = (
                self.counters.get("n_exact_routed", 0) + bq)
            return self._exact(queries, k, excluded)
        ef = self.config.ef_search if ef is None else int(ef)
        ef = self._bucket_ef(ef)
        qdev = torch.as_tensor(queries, device=self.device)

        while True:
            d, g, found = self._search_step(qdev, excluded, ef,
                                            min(k, ef * self.n_shards))
            alive = (g >= 0) & np.isfinite(d)
            n_alive = alive.sum(axis=1)
            # per query: some shard filled its whole beam => more graph may
            # remain there; one exhausted shard never blocks widening
            need_more = (n_alive < min(k, n_allowed)) & (found >= ef)
            if (not need_more.any()
                    or ef >= min(max(self.n_nodes, 1), self.max_widen_ef)):
                break
            ef = self._bucket_ef(ef * 2)
            self.counters["n_widenings"] += 1
        self.counters["n_searches"] += bq

        cap = self.capacity_per_shard
        out_d = np.full((bq, k), np.inf, np.float32)
        out_l = np.zeros((bq, k), np.uint64)
        out_v = np.zeros((bq, k), bool)
        for row in range(bq):
            sel = np.nonzero(alive[row])[0][:k]
            m = len(sel)
            out_d[row, :m] = d[row, sel]
            gids = g[row, sel]
            out_l[row, :m] = self._labels[gids // cap, gids % cap]
            out_v[row, :m] = True
        return out_d, out_l, out_v

    # ------------------------------------------------------------------ #
    # tuners, knobs, cursors
    # ------------------------------------------------------------------ #

    def tune_ef_search(self, queries, target_recall: float = 0.95,
                       k: int = 10, max_ef: int = 4096,
                       strict: bool = False):
        """Smallest power-of-two efSearch meeting ``target_recall`` on
        ``queries`` against the sharded exact route; sets config.ef_search
        to it (the best tried if the target was missed).  Returns
        TuneResult(ef, recall, met); strict=True raises TuneTargetMissed
        on a miss."""
        queries = self._check_dims(queries)

        def probe(ef):
            return self.search(queries, k, ef=ef, mode="graph")[1:]

        res = _tune_pow2(self, queries, k, target_recall,
                         max(self.config.ef_search, k),
                         min(max_ef, max(self.n_nodes, 1)), probe, strict,
                         f"ef (max_ef={max_ef})")
        self.set_ef_search(res.ef)
        return res

    def tune_sweep_pool(self, queries, target_recall: float = 0.95,
                        k: int = 10, max_pool: int = 1024,
                        strict: bool = False):
        """Smallest power-of-two sweep_pq pool (PER SHARD) meeting
        ``target_recall`` against the sharded exact route; sets
        pq_sweep_pool.  Returns TuneResult(pool, recall, met)."""
        queries = self._check_dims(queries)

        def probe(pool):
            return self.pq_sweep_search(queries, k, pool=pool)[1:]

        res = _tune_pow2(self, queries, k, target_recall, max(2 * k, 16),
                         max_pool, probe, strict,
                         f"pool (max_pool={max_pool})")
        self.pq_sweep_pool = res.ef
        return res

    def open_scan(self, query, ef: Optional[int] = None,
                  where=None) -> "ShardedScan":
        """Pull-model cursor over one query (see HnswIndex.open_scan):
        result cache, dedup by global handle across fetches, progressive
        ef-doubling on exhaustion, per-shard raw-beam termination."""
        query = self._check_dims(query)
        if query.shape[0] != 1:
            raise ValueError("open_scan takes exactly one query vector")
        ef = self.config.ef_search if ef is None else int(ef)
        return ShardedScan(self, query, self._bucket_ef(max(ef, 1)), where)

    # ------------------------------------------------------------------ #
    # delete / stats
    # ------------------------------------------------------------------ #

    def _tombstone(self, dead_of_shard) -> int:
        """Tombstone the rows ``dead_of_shard(i, already bool[n_i])`` ->
        bool[n_i] marks in every shard; logs the newly dead labels first."""
        dlt = self._deleted.cpu().numpy().copy()
        counts = self._counts
        n_new = 0
        newly: list = []
        for i in range(self.n_shards):
            already = dlt[i, : counts[i]]
            dead = dead_of_shard(i, already) & ~already
            n_new += int(dead.sum())
            newly.append(self._labels[i, : counts[i]][dead])
            dlt[i, : counts[i]] |= dead
        if n_new and self._wal is not None and not self._wal_replaying:
            # canonical WAL form is labels (the TID analog)
            self._wal.log_delete(np.concatenate(newly))
        # in place: the shards' views stay valid
        self._deleted.copy_(torch.from_numpy(dlt))
        self.counters["n_deleted"] += n_new
        self._maybe_auto_checkpoint()
        return n_new

    @_write_locked
    def delete(self, labels) -> int:
        """Tombstone every row whose label matches; returns how many."""
        labels = np.asarray(labels, np.uint64).reshape(-1)
        return self._tombstone(lambda i, already: np.isin(
            self._labels[i, : len(already)], labels))

    @_write_locked
    def delete_where(self, mask) -> int:
        """Tombstone by a mask over global insert positions — the callback
        form of ambulkdelete (see HnswIndex.delete_where)."""
        mask = np.asarray(mask, bool).reshape(-1)

        def dead_of_shard(i, already):
            pos = self._positions[i, : len(already)]
            hit = (pos >= 0) & (pos < len(mask))
            dead = np.zeros(len(already), bool)
            dead[hit] = mask[pos[hit]]
            return dead

        return self._tombstone(dead_of_shard)

    def _live_masks(self) -> List[np.ndarray]:
        """Per shard, which of its rows are not tombstoned (host bool)."""
        dlt = self._deleted.cpu().numpy()
        return [~dlt[i, : self._counts[i]] for i in range(self.n_shards)]

    @_read_locked
    def vacuum(self) -> Dict[str, int]:
        n = self.n_nodes
        live = int(sum(m.sum() for m in self._live_masks()))
        return {"num_nodes": n, "num_live": live, "num_dead": n - live,
                "capacity": self.capacity_per_shard * self.n_shards,
                "n_shards": self.n_shards}

    @_read_locked
    def compact(self) -> "ShardedHnswIndex":
        """Rebuild over live vectors only (see HnswIndex.compact): a NEW
        sharded index of as many shards on the same device, made from the
        constructor's arguments."""
        vecs, labels = [], []
        for i, alive in enumerate(self._live_masks()):
            n_i = len(alive)
            vecs.append(HnswIndex._to_host(self._vectors[i], n_i)[alive])
            labels.append(self._labels[i, :n_i][alive])
        fresh = ShardedHnswIndex(
            self.config, self.n_shards, device=self.device,
            max_insert_batch=self.max_insert_batch,
            search_expand_width=self.search_expand_width,
            build_expand_width=self.build_expand_width,
            build_candidates=self.build_candidates,
            storage_dtype=self.storage_dtype,
            quantized_traversal=self.quantized_traversal,
            packed_traversal=self.packed_traversal,
            packed_dtype=self.packed_dtype,
            pq_groups=self.pq_groups,
            pq_opq=self.pq_opq,
            dcn_slices=self.dcn_slices)
        if sum(len(v) for v in vecs):
            fresh.build(np.concatenate(vecs), np.concatenate(labels))
        return fresh

    @_read_locked
    def check_integrity(self, raise_on_error: bool = True) -> Dict[str, int]:
        """Per-shard graph invariant validation (see HnswIndex), summed."""
        viol: Dict[str, int] = {}
        for graph in self._graphs:
            for key, count in _graph_violations(
                    graph, self.config.max_m).items():
                viol[key] = viol.get(key, 0) + count
        if raise_on_error and any(viol.values()):
            raise AssertionError(f"graph integrity violations: {viol}")
        return viol

    # ------------------------------------------------------------------ #
    # durability: snapshots
    # ------------------------------------------------------------------ #

    def _shard_file(self, path: str, i: int) -> str:
        return path[:-4] + f".shard{i}.npz"

    @_read_locked
    def save(self, path: str, per_shard: bool = False,
             truncate_wal: bool = True) -> None:
        """Serialize all shards in the JAX package's npz format (arrays +
        config; everything else re-derived on load; atomic tmp + rename
        writes; the WAL (epoch, offset) recorded and the replayed prefix
        truncated — see HnswIndex.save).

        ``per_shard=True`` splits the payload into one file per shard
        (``<path>.shard<i>.npz``) plus a small manifest at ``path``: each
        shard's arrays leave the device and reach the disk on their own, so
        the host holds one shard at a time."""
        path = _npz_path(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        hi = int(self._counts.max()) if self.n_nodes else 0
        do_truncate = truncate_wal and self._wal is not None
        manifest = dict(
            format_version=np.int64(1),
            config=np.frombuffer(
                json.dumps(self.config.to_dict()).encode(), dtype=np.uint8),
            storage_dtype=np.frombuffer(
                self.storage_dtype.encode(), dtype=np.uint8),
            n_shards=np.int64(self.n_shards),
            shard_counts=self._counts.astype(np.int64),
            wal_offset=np.int64(self._wal.tell() if self._wal is not None
                                else -1),
            wal_epoch=np.int64(self._wal.epoch if self._wal is not None
                               else -1),
        )
        if do_truncate:
            nxt = self._wal.epoch + 1
            manifest["wal_epoch_next"] = np.int64(nxt)
            manifest["wal_offset_next"] = np.int64(
                self._wal.header_len(nxt))
        if self._pq_codebook is not None:
            # the trained global dictionary, so load() serves PQ without a
            # retrain; per-shard codes and records re-derive from it
            manifest["pq_codebook"] = self._pq_codebook.cpu().numpy()
            manifest["pq_groups_trained"] = np.int64(self.pq_groups)
            if self._pq_rot is not None:
                manifest["pq_rot"] = self._pq_rot.cpu().numpy()

        def host(t: torch.Tensor) -> np.ndarray:
            # bf16 widens (losslessly) to float32, which numpy can hold
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            return t.cpu().numpy()

        if per_shard:
            for i in range(self.n_shards):
                n_i = int(self._counts[i])
                shard_payload = dict(
                    shard=np.int64(i),
                    vectors=host(self._vectors[i, :n_i]),
                    links=host(self._links[i, :n_i]),
                    link_counts=host(self._link_counts[i, :n_i]),
                    deleted=host(self._deleted[i, :n_i]),
                    labels=self._labels[i, :n_i],
                    positions=self._positions[i, :n_i],
                )
                compressed = shard_payload["vectors"].nbytes < (1 << 30)
                _atomic_savez(self._shard_file(path, i), shard_payload,
                              compressed)
            manifest["per_shard"] = np.int64(1)
            _atomic_savez(path, manifest, True)
        else:
            manifest.update(
                vectors=host(self._vectors[:, :hi]),
                links=host(self._links[:, :hi]),
                link_counts=host(self._link_counts[:, :hi]),
                deleted=host(self._deleted[:, :hi]),
                labels=self._labels[:, :hi],
                positions=self._positions[:, :hi],
            )
            _atomic_savez(path, manifest,
                          manifest["vectors"].nbytes < (1 << 30))
        if do_truncate:
            self._wal.truncate(self._wal.epoch + 1)

    @classmethod
    def load(cls, path: str, n_shards: Optional[int] = None,
             config: Optional[HnswConfig] = None,
             wal: Optional[str] = None,
             dcn_slices: Optional[int] = None,
             device="cuda") -> "ShardedHnswIndex":
        """Restore a sharded index onto ``device``.  The shard count is the
        file's; an explicit ``n_shards`` that differs raises (resharding is
        a rebuild).  Frozen-field guard as in HnswIndex.load.  Reads
        monolithic and per-shard snapshots of either package, and legacy
        files without insert positions; ``wal`` replays the delta-log tail
        appended after the snapshot.  ``dcn_slices`` is a merge-topology
        hint, not index state."""
        path = _npz_path(path)
        with np.load(path) as z:
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
            s = int(z["n_shards"])
            counts = z["shard_counts"]
            storage_dtype = (bytes(z["storage_dtype"]).decode()
                             if "storage_dtype" in z else "float32")
            wal_offset = int(z["wal_offset"]) if "wal_offset" in z else -1
            wal_epoch = int(z["wal_epoch"]) if "wal_epoch" in z else None
            wal_next = (int(z["wal_epoch_next"]),
                        int(z["wal_offset_next"])) \
                if "wal_epoch_next" in z else None
            split = bool(int(z["per_shard"])) if "per_shard" in z else False
            pq_codebook = z["pq_codebook"] if "pq_codebook" in z else None
            pq_groups_trained = (int(z["pq_groups_trained"])
                                 if "pq_groups_trained" in z else None)
            pq_rot = z["pq_rot"] if "pq_rot" in z else None
            if split:
                vec = lnk = cnt = dlt = lab = pos = None
            else:
                vec, lnk, cnt = z["vectors"], z["links"], z["link_counts"]
                dlt, lab = z["deleted"], z["labels"]
                pos = z["positions"] if "positions" in z else None
        if n_shards is not None and int(n_shards) != s:
            raise ValueError(
                f"saved index has {s} shards but the mesh has "
                f"{int(n_shards)} devices; resharding requires a rebuild")

        if split:
            # assemble padded per-shard stacks one shard file at a time
            hi = int(counts.max()) if counts.max() else 0
            vec = np.zeros((s, hi, cfg.dims), np.float32)
            lnk = np.full((s, hi, cfg.max_m), -1, np.int32)
            cnt = np.zeros((s, hi), np.int32)
            dlt = np.zeros((s, hi), bool)
            lab = np.zeros((s, hi), np.uint64)
            pos = np.full((s, hi), -1, np.int64)
            for i in range(s):
                with np.load(path[:-4] + f".shard{i}.npz") as zi:
                    n_i = int(counts[i])
                    vec[i, :n_i] = zi["vectors"]
                    lnk[i, :n_i] = zi["links"]
                    cnt[i, :n_i] = zi["link_counts"]
                    dlt[i, :n_i] = zi["deleted"]
                    lab[i, :n_i] = zi["labels"]
                    pos[i, :n_i] = zi["positions"]

        idx = cls(cfg, s, device=device,
                  initial_capacity=max(int(counts.max()), 32),
                  storage_dtype=storage_dtype, dcn_slices=dcn_slices)
        hi = vec.shape[1]
        idx._vectors[:, :hi] = torch.from_numpy(np.asarray(vec, np.float32))
        idx._links[:, :hi] = torch.from_numpy(np.asarray(lnk, np.int32))
        idx._link_counts[:, :hi] = torch.from_numpy(
            np.asarray(cnt, np.int32))
        idx._deleted[:, :hi] = torch.from_numpy(np.asarray(dlt, bool))
        idx._set_stack(idx._vectors, idx._links, idx._link_counts,
                       idx._deleted, counts)
        idx._labels[:, :hi] = lab
        if pos is not None:
            idx._positions[:, :hi] = pos
        else:
            # legacy files (no positions): reconstruct assuming the
            # round-robin-from-zero build order (position = slot*S + shard)
            for i in range(s):
                idx._positions[i, : counts[i]] = (
                    np.arange(counts[i]) * s + i)
        idx.counters["n_inserted"] = int(counts.sum())
        if pq_codebook is not None:
            idx._pq_codebook = torch.as_tensor(
                pq_codebook, dtype=torch.float32, device=idx.device)
            idx.pq_groups = pq_groups_trained
            if pq_rot is not None:
                idx._pq_rot = torch.as_tensor(
                    pq_rot, dtype=torch.float32, device=idx.device)
                idx.pq_opq = True
        if wal is not None:
            idx._replay_wal(wal, wal_offset, wal_epoch, wal_next)
        return idx

class ShardedScan(_ScanBase):
    """Pull-model scan cursor over one query on the sharded index — the
    amgettuple state machine (embedding.c:100-107, 284-366) applied to the
    merged per-shard results (see HnswScan for the single-index form).

    Rows are deduplicated by GLOBAL handle (so two rows with equal labels
    are still returned once each).  Tombstones are re-read per fetch
    (concurrent deletes are seen); the where-filter is snapshotted at open
    over the rows present then, and capacity added after open is excluded
    (as in the JAX scan, a later row in a slot the snapshot already had is
    not).  Widening stops once NO shard fills its beam (the max over shards
    of the per-shard result counts, as in the merged search's widening
    gate) or ef reaches the index's size or max_widen_ef."""

    def __init__(self, index: ShardedHnswIndex, query: np.ndarray, ef: int,
                 where=None) -> None:
        super().__init__(index, ef)
        self._q = torch.as_tensor(np.asarray(query, np.float32),
                                  device=index.device)
        self._excluded = index._filter_mask(where)

    def _excluded_now(self) -> torch.Tensor:
        """The snapshot filter padded to the CURRENT per-shard capacity
        (the index may have grown mid-scan; the new slots are excluded)."""
        exc = self._excluded
        cap = self._idx.capacity_per_shard
        if exc.shape[1] != cap:
            exc = np.pad(exc, ((0, 0), (0, cap - exc.shape[1])),
                         constant_values=True)
            self._excluded = exc
        return torch.as_tensor(exc, device=self._idx.device)

    def _fetch_locked(self) -> None:
        idx = self._idx
        if not self._first:
            if self._ef >= min(max(idx.n_nodes, 1), idx.max_widen_ef):
                self._no_more = True
                return
            self._ef = idx._bucket_ef(self._ef * 2)
            idx.counters["n_widenings"] += 1
        # the merge keeps ALL gathered candidates (k_total = S * ef): the
        # exhaustion rule below ("no shard filled its beam") is only
        # sound if the merge never drops rows the shards produced
        d, g, found = idx._search_step(self._q, self._excluded_now(),
                                       self._ef, self._ef * idx.n_shards)
        d, g = d[0], g[0]
        idx.counters["n_searches"] += 1
        cap = idx.capacity_per_shard
        alive = (g >= 0) & np.isfinite(d)
        for pos in range(len(g)):
            gid = int(g[pos])
            if gid < 0 or not alive[pos] or gid in self._seen:
                continue
            self._seen.add(gid)
            self._buf_d.append(float(d[pos]))
            self._buf_l.append(idx._labels[gid // cap, gid % cap])
        if int(found[0]) < self._ef:
            self._no_more = True
        self._first = False
