"""Batched ef-bounded best-first graph search — the counterpart of
pg_embedding_tpu/core/search.py (searchBaseLayer, hnswalg.cpp:42-114).

Same algorithm as the JAX package's ``_search_one``:

  * priority queues -> fixed-width distance-sorted tensors maintained by
    concat + stable sort ("masked merge"), inf/-1 padded;
  * the loop stops when the best candidate is farther than the worst kept
    result (hnswalg.cpp:69-71); a neighbour is admitted if it beats the
    worst kept result or results are not full (hnswalg.cpp:99);
  * beam widening: each step pops the best T = ``expand_width`` candidates.

Visited set (``visited_slots``, as in the JAX package):
  * -1, dense dedupe (the API default): no visited memory; a neighbour is
    skipped iff it sits in either queue or was popped this step; anything
    else seen before is >= the current worst and dies at the admit gate
    (proof in the JAX module);
  * 0, the exact per-query bitmap (32 ids per word, the hnswalg.cpp:45-64
    layout; words are int64 so the set bits never reach a sign bit) — the
    cross-check oracle, with the same results as dense;
  * 2^s, a fixed-size open-hash table of 4-slot buckets with overwrite.
    Overwritten entries may let a node be re-expanded, so the loop also
    stops at 2^s hops and a final pass drops duplicate ids.  The hash is
    uint32 arithmetic; torch has no full uint32, so it runs in int64 and
    masks to 32 bits, which gives the same buckets and slots.

Neighbour rows come from one of four sources:
  * the corpus rows (``graph.vectors``, float32 or bf16);
  * quantized traversal: int8 rows ``qvectors`` x per-row ``qscale``;
  * packed traversal: per-node records ``pcodes`` [cap, maxM, D] holding
    the rows of each node's neighbours in link order — int8 (x ``pscales``
    [cap, maxM]), bf16 or float32 — so a step gathers T records instead of
    T*maxM rows.  (The JAX package picks flat or 3-D records by the TPU's
    tiles; here records are always [cap, maxM, D].)
  * PQ traversal: records ``pcodes`` uint8[cap, maxM, G] of the
    neighbours' PQ codes, decoded through ``pq_codebook`` (ops/pq); with
    an OPQ rotation the decoded rows live in the rotated space, so the
    walk scores them against ``query_t`` = q @ R while the entry distance
    and the rerank keep the original query (search_graph_pq).
Any approximate source (int8, bf16 or PQ records, int8 rows) is followed
by an exact rerank of the ef results against the corpus rows.  float32
records skip it: their distances are the plain walk's, so the ids, order
and distances equal the plain walk's.  The rerank and the hash set's
duplicate drop run after the walk, in ``finish_walk``, whichever route
walked.

The JAX package runs ``vmap(while_loop)`` as one device program.  Here
``search_graph`` routes each call (``walk_route``, a pure function of the
device): on the card every variant above — each row source, OPQ, each
visited set, any queue width — runs as one kernel launch
(ops/cuda_graph.beam_walk, which launches or raises); every walk on the
CPU runs ``_search_batch``, the kernel's plain twin.  There the batch is
explicit and the loop is a Python loop over steps.  A query whose loop
condition fails freezes — its queues, hop and distance-evaluation counts
stop changing — exactly as vmap's per-lane select does.  Each step runs only the active queries and
costs one host sync (reading which queries are still active).
``PLAIN_WALKS_ON_CARD`` counts the twin's calls on CUDA tensors, so a run
can show that a path's walks all went through the kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.bruteforce import merge_min_k, min_k
from ..ops.cuda_graph import beam_walk
from ..ops.distance import _matmul, dist_one_to_many
from ..ops.pq import pq_decode
from .graph import GraphState

_INF = float("inf")
# hash-mode constants (uint32 multiplicative hashes of the JAX package)
_HASH_PRIME = 2654435761
_HASH_SLOT_MULT = 0x9E3779B1
_U32 = 0xFFFFFFFF

# Calls of the plain walk (_search_batch) on CUDA tensors since import (or
# since a caller reset it).
PLAIN_WALKS_ON_CARD = 0


class SearchStats(NamedTuple):
    hops: torch.Tensor        # i32[B] — loop steps per query
    dist_evals: torch.Tensor  # i32[B] — distance computations per query


def _merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two (dist, idx) sets per row, keep the k smallest; ties go to
    the lower concatenated position, i.e. incumbents (set a) win — what
    ``lax.top_k`` gives the JAX package."""
    return merge_min_k(d_a, i_a, d_b, i_b, k)


def _hash_buckets(ids: torch.Tensor, slots: int) -> torch.Tensor:
    """The 4 consecutive table slots of each id's bucket (hash mode):
    Knuth's multiplicative hash in uint32, masked to a 4-aligned slot.
    Returns int64 [..., 4]."""
    h = (ids.to(torch.int64) * _HASH_PRIME) & ((slots - 1) & ~3)
    return h.unsqueeze(-1) + torch.arange(4, device=ids.device)


def _hash_slot_choice(ids: torch.Tensor) -> torch.Tensor:
    """The slot within its bucket that an id overwrites (hash mode): the
    top two bits of a second uint32 multiplicative hash.  int64 [...]."""
    return ((ids.to(torch.int64) * _HASH_SLOT_MULT) & _U32) >> 30


def _search_batch(graph: GraphState, queries: torch.Tensor, *, ef: int,
                  metric_value: int, cand_cap: int, expand_width: int = 1,
                  qvectors=None, qscale=None, pcodes=None, pscales=None,
                  pq_codebook=None, query_t=None, visited_slots: int = -1):
    """searchBaseLayer for a batch of queries f32[B, D]: the walk of
    ops/cuda_graph.beam_walk in torch ops.  Returns (res_d f32[B, ef],
    res_i i32[B, ef], hops i32[B], dist_evals i32[B]); results ascending,
    -1/inf padded, before finish_walk.  ``query_t`` f32[B, D], when given,
    replaces the queries in the walk's distances only (the OPQ hook)."""
    global PLAIN_WALKS_ON_CARD
    b, dims = queries.shape
    dev = queries.device
    if queries.is_cuda:
        PLAIN_WALKS_ON_CARD += 1
    max_m = graph.max_m
    t = expand_width
    tm = t * max_m
    use_dense = visited_slots < 0
    use_hash = visited_slots > 0
    if use_hash and visited_slots & (visited_slots - 1):
        raise ValueError(f"visited_slots={visited_slots} is not a power of 2")

    def full(width, value, dtype):
        return torch.full((b, width), value, dtype=dtype, device=dev)

    # --- entry point: node 0, hardwired (embedding.c:235) -----------------
    res_d = full(ef, _INF, torch.float32)
    res_i = full(ef, -1, torch.int32)
    cand_d = full(cand_cap, _INF, torch.float32)
    cand_i = full(cand_cap, -1, torch.int32)
    has_nodes = graph.n_nodes > 0
    if has_nodes:
        d0 = dist_one_to_many(queries, graph.vectors[:1].expand(b, 1, dims),
                              metric_value)[:, 0]
        res_d[:, 0] = d0
        cand_d[:, 0] = d0
        res_i[:, 0] = 0
        cand_i[:, 0] = 0
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    evals = torch.zeros(b, dtype=torch.int32, device=dev)

    if use_hash:
        # node 0's bucket is slots 0-3 and it overwrites slot 0
        visited = full(visited_slots, -1, torch.int32)
        if has_nodes:
            visited[:, 0] = 0
    elif not use_dense:
        n_words = graph.capacity // 32
        visited = torch.zeros((b, n_words), dtype=torch.int64, device=dev)
        if has_nodes:
            visited[:, 0] = 1

    slot_ids = torch.arange(tm, device=dev)
    slot_in_row = slot_ids % max_m
    earlier_slot = slot_ids.unsqueeze(0) < slot_ids.unsqueeze(1)  # [tm, tm]
    pre = min(max(ef, cand_cap), tm)
    walk_q = queries if query_t is None else query_t

    while True:
        go = (cand_d[:, 0] < _INF) & ~(cand_d[:, 0] > res_d[:, ef - 1])
        if use_hash:
            # overwritten entries can re-admit expanded nodes; the hop cap
            # guarantees termination
            go &= hops < visited_slots
        idx = go.nonzero().squeeze(1)           # the step's host sync
        if idx.numel() == 0:
            break
        a = idx.numel()
        q = walk_q[idx]
        rd, ri, cd, ci = res_d[idx], res_i[idx], cand_d[idx], cand_i[idx]
        lower = rd[:, ef - 1:ef]

        # --- pop the best T candidates (hnswalg.cpp:73); expansion masked
        # where d > lowerBound (a superset of the reference's expansions)
        pop_d, pop_i = cd[:, :t], ci[:, :t]
        expand = ~(pop_d > lower) & (pop_i >= 0)
        cd = torch.cat([cd[:, t:], torch.full_like(pop_d, _INF)], dim=1)
        ci = torch.cat([ci[:, t:], torch.full_like(pop_i, -1)], dim=1)

        safe_cur = pop_i.clamp(min=0)
        nbrs = graph.links[safe_cur].reshape(a, tm)            # [a, T*maxM]
        cnts = graph.link_counts[safe_cur]                     # [a, T]
        valid = ((slot_in_row < cnts.repeat_interleave(max_m, dim=1)) &
                 (nbrs >= 0) & expand.repeat_interleave(max_m, dim=1))
        safe_nbrs = torch.where(valid, nbrs, 0)
        sn = safe_nbrs.unsqueeze(2)

        if use_dense:
            # skip ids in either queue or popped this step
            unvisited = ~((sn == ci.unsqueeze(1)).any(2) |
                          (sn == ri.unsqueeze(1)).any(2) |
                          (sn == pop_i.unsqueeze(1)).any(2))
        elif use_hash:
            buckets = _hash_buckets(safe_nbrs, visited_slots)  # [a, tm, 4]
            held = visited[idx.view(a, 1, 1), buckets]
            unvisited = ~(held == sn).any(2)
        else:
            flat = idx.unsqueeze(1) * n_words + (safe_nbrs >> 5).long()
            bits = torch.ones_like(flat) << (safe_nbrs & 31).long()
            unvisited = (visited.view(-1)[flat] & bits) == 0

        # first-occurrence dedupe across the expanded rows
        dup = ((safe_nbrs.unsqueeze(1) == sn) & earlier_slot &
               valid.unsqueeze(1)).any(2)
        process = valid & unvisited & ~dup

        if use_hash:
            # write each processed id into its chosen slot; colliding ids
            # overwrite (an older entry may be lost: re-expansion, see above)
            ins = torch.gather(buckets, 2,
                               _hash_slot_choice(safe_nbrs).unsqueeze(2))
            rows = idx.unsqueeze(1).expand(a, tm)
            r, c = rows[process], ins.squeeze(2)[process]
            # where two ids of a step choose one slot, the later expansion
            # slot's write wins (the mask lists them in slot order);
            # index_put with repeated indices leaves the winner unspecified
            key, perm = torch.sort(r * visited_slots + c, stable=True)
            last = perm[torch.cat([key[1:] != key[:-1],
                                   key.new_ones(min(key.numel(), 1),
                                                dtype=torch.bool)])]
            visited[r[last], c[last]] = safe_nbrs[process][last]
        elif not use_dense:
            # the processed ids are distinct, so their bits are disjoint
            # within a word and adding them sets them
            visited.view(-1).index_add_(
                0, flat.reshape(-1),
                torch.where(process, bits, 0).reshape(-1))

        if pq_codebook is not None:
            nvecs = pq_decode(pcodes[safe_cur].reshape(a, tm, -1),
                              pq_codebook)
        elif pcodes is not None:
            nvecs = pcodes[safe_cur].reshape(a, tm, dims).to(torch.float32)
            if pscales is not None:
                nvecs = nvecs * pscales[safe_cur].reshape(a, tm, 1)
        elif qvectors is not None:
            nvecs = (qvectors[safe_nbrs].to(torch.float32) *
                     qscale[safe_nbrs].unsqueeze(2))
        else:
            nvecs = graph.vectors[safe_nbrs]                   # [a, tm, D]
        dists = dist_one_to_many(q, nvecs, metric_value)
        admit = process & (dists < lower)
        new_d = torch.where(admit, dists, _INF)
        new_i = torch.where(admit, nbrs, -1)
        # pre-reduce the T*maxM new entries to the best that can matter
        if tm > pre:
            new_d, sel = min_k(new_d, pre)
            new_i = torch.gather(new_i, 1, sel)

        res_d[idx], res_i[idx] = _merge_topk(rd, ri, new_d, new_i, ef)
        cand_d[idx], cand_i[idx] = _merge_topk(cd, ci, new_d, new_i,
                                               cand_cap)
        hops[idx] += 1
        evals[idx] += process.sum(dim=1, dtype=torch.int32)

    return res_d, res_i, hops, evals


def finish_walk(graph: GraphState, queries: torch.Tensor,
                res_d: torch.Tensor, res_i: torch.Tensor, *,
                metric_value: int, hashed: bool, rerank: bool):
    """What follows the walk on either route, once a batch: the hash set's
    duplicate drop (``hashed``) and the exact rerank of an approximate
    source's ef results against the corpus rows (``rerank``).  Returns
    (res_d, res_i)."""
    ef = res_i.shape[1]
    if hashed:
        # overwrites can put an id into the results twice (with the same
        # distance): drop the later copies, then restore ascending order
        order = torch.argsort(res_i, dim=1, stable=True)
        si = torch.gather(res_i, 1, order)
        sd = torch.gather(res_d, 1, order)
        prev = torch.cat([torch.full_like(si[:, :1], -2), si[:, :-1]], dim=1)
        dupe = (si == prev) & (si >= 0)
        res_d, sel = min_k(torch.where(dupe, _INF, sd), ef)
        res_i = torch.gather(torch.where(dupe, -1, si), 1, sel)
    if rerank:
        # exact rerank of the ef results against the corpus rows
        fvecs = graph.vectors[res_i.clamp(min=0)]
        rd = torch.where(res_i >= 0,
                         dist_one_to_many(queries, fvecs, metric_value), _INF)
        res_d, sel = min_k(rd, ef)
        res_i = torch.gather(res_i, 1, sel)
    return res_d, res_i


def walk_route(device_type: str) -> str:
    """Which walk serves a call: "kernel" (ops/cuda_graph.beam_walk, which
    launches or raises) for every walk on the card, whatever its row
    source, visited set and queue widths; "plain" (_search_batch) off the
    card."""
    return "kernel" if device_type == "cuda" else "plain"


def search_graph(graph: GraphState, queries: torch.Tensor, *, ef: int,
                 metric_value: int, cand_cap: int | None = None,
                 expand_width: int = 1, qvectors=None, qscale=None,
                 pcodes=None, pscales=None, pq_codebook=None, query_t=None,
                 visited_slots: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Batched searchBaseLayer; the counterpart of the JAX package's
    search_graph, search_graph_quantized and search_graph_packed.  The
    walk runs as one kernel launch or as torch ops, as walk_route says;
    finish_walk follows either.

    Args:
      graph:   GraphState.
      queries: f32[B, D] query batch on the graph's device.
      ef:      beam width (efSearch / efConstruction).
      metric_value: Metric.value.
      cand_cap: candidate-queue width (default ef).
      expand_width: candidates expanded per loop step (T).
      qvectors, qscale: int8[cap, D] rows and f32[cap] scales (quantized
               traversal).
      pcodes, pscales: [cap, maxM, D] neighbour records (int8, bf16 or f32)
               and, for int8, f32[cap, maxM] scales (packed traversal).
      pq_codebook: f32[G, 256, D/G]; ``pcodes`` then holds PQ codes
               uint8[cap, maxM, G] (PQ traversal).
      query_t: f32[B, D] queries for the walk's distances (OPQ: q @ R).
      visited_slots: -1 dense dedupe, 0 bitmap, 2^s hash-table slots.

    Returns:
      (dists f32[B, ef] ascending, node ids i32[B, ef] (-1 past end),
       SearchStats).
    """
    if cand_cap is None:
        cand_cap = ef
    kw = dict(ef=ef, metric_value=metric_value, cand_cap=cand_cap,
              expand_width=expand_width, qvectors=qvectors, qscale=qscale,
              pscales=pscales, pq_codebook=pq_codebook, query_t=query_t,
              visited_slots=visited_slots)
    if walk_route(queries.device.type) == "kernel":
        res_d, res_i, hops, evals = beam_walk(graph, queries, records=pcodes,
                                              **kw)
    else:
        res_d, res_i, hops, evals = _search_batch(graph, queries,
                                                  pcodes=pcodes, **kw)
    res_d, res_i = finish_walk(
        graph, queries, res_d, res_i, metric_value=metric_value,
        hashed=visited_slots > 0,
        rerank=qvectors is not None or (pcodes is not None
                                        and pcodes.dtype != torch.float32))
    return res_d, res_i, SearchStats(hops=hops, dist_evals=evals)


def search_graph_pq(graph: GraphState, queries: torch.Tensor,
                    pcodes: torch.Tensor, codebook: torch.Tensor,
                    rotation=None, *, ef: int, metric_value: int,
                    cand_cap: int | None = None, expand_width: int = 1,
                    visited_slots: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Batched searchBaseLayer over packed PQ records uint8[cap, maxM, G]
    with codebook f32[G, 256, D/G], then the exact rerank; with an OPQ
    ``rotation`` f32[D, D] the walk scores against q @ R (the counterpart
    of the JAX package's search_graph_pq)."""
    query_t = None if rotation is None else _matmul(queries, rotation)
    return search_graph(graph, queries, ef=ef, metric_value=metric_value,
                        cand_cap=cand_cap, expand_width=expand_width,
                        pcodes=pcodes, pq_codebook=codebook,
                        query_t=query_t, visited_slots=visited_slots)
