"""Batched graph construction — the counterpart of pg_embedding_tpu/core/build.py
(bindPoint / mutuallyConnectNewElement, hnswalg.cpp:155-232).

Reference semantics: node 0 is inserted with no links and is the entry
point; every later node searches the graph with efConstruction, prunes the
result to M with the Malkov diversity heuristic, writes its link list, and
back-links into each chosen neighbour (append if there is room, else
re-select that neighbour's maxM best with the same heuristic).

As in the JAX package, a batch of points is inserted together: candidates
come from a full corpus sweep (``exact``/``exact8``) or a batched beam
search (``beam``), earlier members of the batch are merged in as
brute-force candidates, the heuristic prunes each set, and the wiring
replays the serial back-link order per target in rounds.  Differences of
form, not of result:

  * the JAX ``lax.fori_loop``/``while_loop`` loops are Python loops; the
    graph tensors are updated in place (the API's write lock covers it);
  * ``approx_min_k`` in the sweep is an exact top-k (so is the JAX
    package's on the CPU, where its tests run);
  * ``jnp.lexsort`` is two stable sorts, ``lax.top_k`` a stable sort.

Host syncs per inserted batch: one per back-link round plus one per round
with overflowing targets, and one for the round count (see PERF.md).
"""

from __future__ import annotations

import torch

from ..ops.bruteforce import merge_min_k, min_k
from ..ops.distance import dist_one_to_many, pairwise_dist
from .graph import GraphState
from .search import _search_batch

_INF = float("inf")
# rows per exact8 sweep step: int8 rows are cheap to score, so the sweep
# takes few wide steps (a [256, 1M] float32 score tile is 1 GB)
_EXACT8_CHUNK = 1_048_576


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Per-row order by (primary asc, secondary asc), stable: the
    ``jnp.lexsort((secondary, primary))`` of each row."""
    o1 = torch.argsort(secondary, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(primary, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def _prune_heuristic(cand_d: torch.Tensor, cand_i: torch.Tensor,
                     pair_d: torch.Tensor, nn: int):
    """getNeighborsByHeuristic (hnswalg.cpp:117-153) for a batch of
    candidate sets.

    Args:
      cand_d: f32[B, C] distances candidate -> query point (inf = invalid).
      cand_i: i32[B, C] candidate node ids (-1 = invalid).
      pair_d: f32[B, C, C] pairwise candidate distances (same order).
      nn:     max neighbors to keep (M, or maxM for back-link re-prunes).

    Returns (kept_i i32[B, nn] in selection order, -1 padded; kept_count
    i32[B]).

    Candidates are scanned nearest-first (ties: larger id first); c is kept
    iff no already-kept r has dist(c, r) < dist(c, query).  With fewer than
    nn valid candidates the heuristic is skipped and all are kept in
    farthest-first order with ties larger-id-first — the reference's
    link-list order quirk (see the JAX function).
    """
    bsz, c = cand_d.shape
    dev = cand_d.device
    valid = (cand_i >= 0) & torch.isfinite(cand_d)
    do_prune = valid.sum(dim=1) >= nn

    # nearest-first scan order, ties larger-id-first; invalid entries last
    key_d = torch.where(valid, cand_d, _INF)
    order = _lexsort2(key_d, -cand_i)
    d_s = torch.gather(key_d, 1, order)
    i_s = torch.gather(cand_i, 1, order)
    valid_s = torch.gather(valid, 1, order)
    pair_s = torch.gather(pair_d, 1, order.unsqueeze(2).expand(bsz, c, c))
    pair_s = torch.gather(pair_s, 2, order.unsqueeze(1).expand(bsz, c, c))
    # closer[b, j, r]: kept candidate r would reject candidate j
    closer = pair_s < d_s.unsqueeze(2)

    kept_mask = torch.zeros((bsz, c), dtype=torch.bool, device=dev)
    kept_count = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for j in range(c):
        conflict = (kept_mask & closer[:, j]).any(dim=1)
        take = valid_s[:, j] & (~conflict | ~do_prune) & (kept_count < nn)
        kept_mask[:, j] = take
        kept_count += take

    # compact kept ids into [nn] in selection (ascending-distance) order;
    # the overflow slot nn is dropped
    pos = torch.cumsum(kept_mask, dim=1) - 1
    scatter_to = torch.where(kept_mask, pos, nn)
    kept_i = torch.full((bsz, nn + 1), -1, dtype=torch.int32, device=dev)
    kept_i = kept_i.scatter(1, scatter_to, i_s)[:, :nn]

    # unpruned lists are written farthest-first, ties larger-id-first: the
    # reverse of a (d asc, id ASC) order
    i_asc = torch.gather(cand_i, 1, _lexsort2(key_d, cand_i))
    slot = torch.arange(nn, device=dev)
    cnt = kept_count.unsqueeze(1).long()
    rev_idx = (cnt - 1 - slot).clamp(0, c - 1)
    kept_rev = torch.where(slot < cnt, torch.gather(i_asc, 1, rev_idx), -1)
    kept_i = torch.where(do_prune.unsqueeze(1), kept_i, kept_rev)
    return kept_i, kept_count


def _reprune(vectors, rows, targets, cur, *, max_m: int, metric_value: int):
    """Overflow re-prune (hnswalg.cpp:196-220): each target's maxM best of
    {its links + cur}, by distance to the target."""
    cand_ids = torch.cat([rows, cur.unsqueeze(1)], dim=1)     # [L, maxM+1]
    cvecs = vectors[cand_ids.clamp(min=0)]                    # [L, maxM+1, D]
    d = dist_one_to_many(vectors[targets], cvecs, metric_value)
    d = torch.where(cand_ids >= 0, d, _INF)
    pair = pairwise_dist(cvecs, cvecs, metric_value)
    return _prune_heuristic(d, cand_ids, pair, max_m)


def _connect_batch(vectors, links, link_counts, base: int, kept_i, kept_cnt,
                   n_insert: int, *, m: int, max_m: int, metric_value: int):
    """Wire a whole batch: the result of running mutuallyConnectNewElement
    (hnswalg.cpp:155-223) serially over the batch, updating ``links`` and
    ``link_counts`` in place.

    Back-link state depends only on the sequence of operations applied to
    each target, so the serial schedule splits into per-target chains:
    forward rows commit at once, then round r applies every target's r-th
    back-link op (targets within a round are distinct)."""
    b = kept_i.shape[0]
    dev = kept_i.device
    bm = b * m
    member = torch.arange(b, device=dev)
    enable = member < n_insert
    kept_cnt = torch.where(enable, kept_cnt, 0)

    # --- 1. forward links (hnswalg.cpp:168-181) ---------------------------
    valid_f = ((torch.arange(m, device=dev) < kept_cnt.unsqueeze(1)) &
               (kept_i >= 0))                                   # [b, m]
    fwd = torch.full((b, max_m), -1, dtype=torch.int32, device=dev)
    fwd[:, :m] = torch.where(valid_f, kept_i, -1)
    links[base:base + n_insert] = fwd[:n_insert]
    link_counts[base:base + n_insert] = kept_cnt[:n_insert]

    # --- 2. back-link ops, rounds by per-target occurrence rank ----------
    tgt = torch.where(valid_f, kept_i, -1).reshape(bm)
    cur = (base + member).to(torch.int32).repeat_interleave(m)
    valid = tgt >= 0
    op = torch.arange(bm, device=dev)
    same_earlier = ((tgt.unsqueeze(0) == tgt.unsqueeze(1)) &
                    valid.unsqueeze(0) & (op.unsqueeze(0) < op.unsqueeze(1)))
    rank = torch.where(valid, same_earlier.sum(dim=1), -1)
    n_rounds = int(rank.max()) + 1 if bm else 0
    slot_mm = torch.arange(max_m, device=dev)

    for r in range(n_rounds):
        lanes = (rank == r).nonzero().squeeze(1)
        t = tgt[lanes]
        c = cur[lanes]
        rows = links[t]
        cnts = link_counts[t]
        # append path (hnswalg.cpp:193-195)
        new_rows = torch.where(slot_mm == cnts.unsqueeze(1), c.unsqueeze(1),
                               rows)
        new_cnts = cnts + 1
        ov = (cnts >= max_m).nonzero().squeeze(1)
        if ov.numel():
            rep_rows, rep_cnts = _reprune(vectors, rows[ov], t[ov], c[ov],
                                          max_m=max_m,
                                          metric_value=metric_value)
            new_rows[ov] = rep_rows
            new_cnts[ov] = rep_cnts
        links[t] = new_rows
        link_counts[t] = new_cnts
    return links, link_counts


def _exact_candidates(vectors, points, base: int, *, cand_cap: int,
                      metric_value: int, chunk: int = 32768,
                      qvec=None, qscale=None):
    """Construction candidates from a full sweep of rows [0, base) instead
    of the beam walk (HnswIndex(build_candidates="exact"/"exact8")).

    COARSE mode (``qvec``/``qscale`` given, the "exact8" engine) scores the
    int8 shadow rows dequantized in bf16 — the product ``q.bf16 * s.bf16``
    rounds exactly as the JAX package's does — against float32 points in a
    float32 matmul, keeps a 2x-widened pool, and reranks it with the exact
    float32 difference form.  Plain mode sweeps the float32 rows and keeps
    cand_cap + 2 before the same rerank.

    Returns (cand_d [B, cand_cap], cand_i [B, cand_cap]) ascending,
    -1-padded (tombstones stay candidates: deletes filter results, not
    waypoints, hnswalg.cpp:245)."""
    b = points.shape[0]
    dev = points.device
    coarse = qvec is not None
    keep = 2 * cand_cap if coarse else cand_cap + 2
    pts32 = points.to(torch.float32)
    run_d = torch.full((b, keep), _INF, dtype=torch.float32, device=dev)
    run_i = torch.full((b, keep), -1, dtype=torch.int32, device=dev)
    for start in range(0, base, chunk):
        end = min(start + chunk, base)
        if coarse:
            rows = (qvec[start:end].to(torch.bfloat16) *
                    qscale[start:end].to(torch.bfloat16).unsqueeze(1)
                    ).to(torch.float32)
        else:
            rows = vectors[start:end]
        d = pairwise_dist(pts32, rows, metric_value)               # [B, n]
        ids = torch.arange(start, end, dtype=torch.int32,
                           device=dev).expand(b, -1)
        if end - start > keep:
            # exact stand-in for approx_min_k: the keep smallest, put back
            # in id order so the stable merge breaks ties by id
            _, sel = torch.topk(d, keep, dim=1, largest=False, sorted=False)
            sel = torch.sort(sel, dim=1).values
            d = torch.gather(d, 1, sel)
            ids = torch.gather(ids, 1, sel)
        run_d, run_i = merge_min_k(run_d, run_i, d, ids, keep)

    # exact rerank with the reference's elementwise forms
    rrows = vectors[run_i.clamp(min=0)].to(torch.float32)
    rd = dist_one_to_many(pts32, rrows, metric_value)
    rd = torch.where(run_i >= 0, rd, _INF)
    vals, sel = min_k(rd, cand_cap)
    return vals, torch.gather(run_i, 1, sel)


def quantize_rows(points: torch.Tensor):
    """Per-row symmetric int8 quantization: scale = max|v|/127,
    q = clip(round(v/scale)).  Appended rows never change, so incremental
    staging reproduces a full re-quantization.  The scale is max|v| times
    float32(1/127): the JAX package always runs this compiled, and XLA
    folds a division by a constant into that product, which differs from
    the true quotient by an ulp in ~5% of rows (and then moves codes that
    sit at x.5)."""
    v = points.to(torch.float32)
    scale = torch.clamp(v.abs().amax(dim=1), min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(v / scale.unsqueeze(1)), -127, 127)
    return q.to(torch.int8), scale


def insert_batch_core(graph: GraphState, points: torch.Tensor,
                      n_insert: int, *, ef_construction: int, m: int,
                      max_m: int, metric_value: int,
                      cand_cap: int | None = None,
                      expand_width: int = 1,
                      candidates: str = "beam",
                      qvec=None, qscale=None) -> GraphState:
    """Insert the first ``n_insert`` rows of ``points`` (the aminsert /
    ambuild hot path, embedding.c:606-701 + hnswalg.cpp:225-232), updating
    ``graph`` in place; returns it.

    Stages all rows of ``points`` at n_nodes (they are unreachable until
    links exist), finds candidates, merges earlier batch members as
    brute-force candidates, prunes to M, and wires the links.  For
    "exact8" the caller has already staged the batch's int8 rows into
    ``qvec``/``qscale``.
    """
    b = points.shape[0]
    base = graph.n_nodes
    if base + b > graph.capacity:
        # the JAX package's dynamic_update_slice would clamp the staging
        # INTO live rows here; the API keeps a batch of slack
        raise ValueError(f"staging {b} rows at {base} overruns capacity "
                         f"{graph.capacity}")
    if cand_cap is None:
        cand_cap = ef_construction
    points = points.to(torch.float32)
    # stored in the graph's dtype (bf16 rounds to nearest even, as jnp's
    # astype does); the batch's own distances below use the f32 points
    graph.vectors[base:base + b] = points
    vectors = graph.vectors

    if candidates == "exact":
        cand_d, cand_i = _exact_candidates(
            vectors, points, base, cand_cap=cand_cap,
            metric_value=metric_value)
    elif candidates == "exact8":
        cand_d, cand_i = _exact_candidates(
            vectors, points, base, cand_cap=cand_cap,
            metric_value=metric_value, chunk=_EXACT8_CHUNK,
            qvec=qvec, qscale=qscale)
    elif candidates == "beam":
        # batched searchBaseLayer(point, efConstruction) (hnswalg.cpp:229)
        # over the pre-batch graph (n_nodes is still base)
        cand_d, cand_i, _, _ = _search_batch(
            graph, points, ef=ef_construction, metric_value=metric_value,
            cand_cap=cand_cap, expand_width=expand_width)
    else:
        raise ValueError(f"unknown candidates: {candidates!r}")

    # intra-batch candidates: earlier members of this batch, by exact
    # distance (serial insertion would have reached them)
    dev = points.device
    bi = torch.arange(b, device=dev)
    intra = pairwise_dist(points, points, metric_value)          # [B, B]
    earlier = (bi.unsqueeze(0) < bi.unsqueeze(1)) & (bi < n_insert)
    intra_d = torch.where(earlier, intra, _INF)
    intra_i = torch.where(earlier, (base + bi).to(torch.int32), -1)
    cand_d, cand_i = merge_min_k(cand_d, cand_i, intra_d, intra_i,
                                 cand_d.shape[1])

    # batched heuristic prune to M (hnswalg.cpp:158)
    cvecs = vectors[cand_i.clamp(min=0)]                         # [B, W, D]
    pair = pairwise_dist(cvecs, cvecs, metric_value)
    kept_i, kept_cnt = _prune_heuristic(cand_d, cand_i, pair, m)

    # node 0 binds with no links (hnswalg.cpp:227-228): an empty graph
    # yields no candidates, so its kept count is 0
    _connect_batch(vectors, graph.links, graph.link_counts, base, kept_i,
                   kept_cnt, n_insert, m=m, max_m=max_m,
                   metric_value=metric_value)
    graph.n_nodes = base + n_insert
    return graph


def build_schedule(n: int, max_batch: int):
    """Batch schedule: (offset, count) pairs of at most max_batch rows."""
    return [(off, min(max_batch, n - off)) for off in range(0, n, max_batch)]
