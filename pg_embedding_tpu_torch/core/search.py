"""Batched ef-bounded best-first graph search — the counterpart of
pg_embedding_tpu/core/search.py (searchBaseLayer, hnswalg.cpp:42-114).

Same algorithm as the JAX package's ``_search_one`` in its dense-dedupe
mode (``visited_slots=-1``, the API default):

  * priority queues -> fixed-width distance-sorted tensors maintained by
    concat + stable sort ("masked merge"), inf/-1 padded;
  * the loop stops when the best candidate is farther than the worst kept
    result (hnswalg.cpp:69-71); a neighbour is admitted if it beats the
    worst kept result or results are not full (hnswalg.cpp:99);
  * beam widening: each step pops the best T = ``expand_width`` candidates;
  * no visited memory: a neighbour is skipped iff it sits in either queue
    or was popped this step; anything else seen before is >= the current
    worst and dies at the admit gate (proof in the JAX module).

The JAX package runs ``vmap(while_loop)``; here the batch is explicit and
the loop is a Python loop over steps.  A query whose loop condition fails
freezes — its queues, hop and distance-evaluation counts stop changing —
exactly as vmap's per-lane select does.  Each step runs only the active
queries and costs one host sync (reading which queries are still active).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.bruteforce import merge_min_k, min_k
from ..ops.distance import dist_one_to_many
from .graph import GraphState

_INF = float("inf")


class SearchStats(NamedTuple):
    hops: torch.Tensor        # i32[B] — loop steps per query
    dist_evals: torch.Tensor  # i32[B] — distance computations per query


def _merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two (dist, idx) sets per row, keep the k smallest; ties go to
    the lower concatenated position, i.e. incumbents (set a) win — what
    ``lax.top_k`` gives the JAX package."""
    return merge_min_k(d_a, i_a, d_b, i_b, k)


def _search_batch(graph: GraphState, queries: torch.Tensor, *, ef: int,
                  metric_value: int, cand_cap: int, expand_width: int = 1):
    """searchBaseLayer for a batch of queries f32[B, D].  Returns (res_d
    f32[B, ef], res_i i32[B, ef], hops i32[B], dist_evals i32[B]); results
    ascending, -1/inf padded."""
    b, dims = queries.shape
    dev = queries.device
    max_m = graph.max_m
    t = expand_width
    tm = t * max_m

    def full(width, value, dtype):
        return torch.full((b, width), value, dtype=dtype, device=dev)

    # --- entry point: node 0, hardwired (embedding.c:235) -----------------
    res_d = full(ef, _INF, torch.float32)
    res_i = full(ef, -1, torch.int32)
    cand_d = full(cand_cap, _INF, torch.float32)
    cand_i = full(cand_cap, -1, torch.int32)
    if graph.n_nodes > 0:
        d0 = dist_one_to_many(queries, graph.vectors[:1].expand(b, 1, dims),
                              metric_value)[:, 0]
        res_d[:, 0] = d0
        cand_d[:, 0] = d0
        res_i[:, 0] = 0
        cand_i[:, 0] = 0
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    evals = torch.zeros(b, dtype=torch.int32, device=dev)

    slot_ids = torch.arange(tm, device=dev)
    slot_in_row = slot_ids % max_m
    earlier_slot = slot_ids.unsqueeze(0) < slot_ids.unsqueeze(1)  # [tm, tm]
    pre = min(max(ef, cand_cap), tm)

    while True:
        go = (cand_d[:, 0] < _INF) & ~(cand_d[:, 0] > res_d[:, ef - 1])
        idx = go.nonzero().squeeze(1)           # the step's host sync
        if idx.numel() == 0:
            break
        a = idx.numel()
        q = queries[idx]
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

        # dense dedupe: skip ids in either queue or popped this step
        sn = safe_nbrs.unsqueeze(2)
        seen = ((sn == ci.unsqueeze(1)).any(2) |
                (sn == ri.unsqueeze(1)).any(2) |
                (sn == pop_i.unsqueeze(1)).any(2))
        # first-occurrence dedupe across the expanded rows
        dup = ((safe_nbrs.unsqueeze(1) == sn) & earlier_slot &
               valid.unsqueeze(1)).any(2)
        process = valid & ~seen & ~dup

        dists = dist_one_to_many(q, graph.vectors[safe_nbrs], metric_value)
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


def search_graph(graph: GraphState, queries: torch.Tensor, *, ef: int,
                 metric_value: int, cand_cap: int | None = None,
                 expand_width: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Batched searchBaseLayer.

    Args:
      graph:   GraphState.
      queries: f32[B, D] query batch on the graph's device.
      ef:      beam width (efSearch / efConstruction).
      metric_value: Metric.value.
      cand_cap: candidate-queue width (default ef).
      expand_width: candidates expanded per loop step (T).

    Returns:
      (dists f32[B, ef] ascending, node ids i32[B, ef] (-1 past end),
       SearchStats).
    """
    if cand_cap is None:
        cand_cap = ef
    res_d, res_i, hops, evals = _search_batch(
        graph, queries, ef=ef, metric_value=metric_value, cand_cap=cand_cap,
        expand_width=expand_width)
    return res_d, res_i, SearchStats(hops=hops, dist_evals=evals)
