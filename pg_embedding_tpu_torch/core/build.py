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

  * the JAX ``lax.fori_loop``/``while_loop`` loops are Python loops, except
    the prune's scan, the beam walk and the wiring's back-link rounds,
    which run as one kernel launch each on the card (ops/cuda_graph), and
    the candidate sweep, one launch of the sweep kernel a batch on the
    card (ops/cuda_bruteforce.sweep_pool); the graph tensors are updated in
    place (the API's write lock covers it);
  * the wiring's rounds follow a stable sort of the back-link targets
    instead of the JAX package's [bm, bm] occurrence-rank matrix (the same
    per-target order);
  * ``approx_min_k`` in the sweep is an exact top-k (so is the JAX
    package's on the CPU, where its tests run, though its order among
    equal scores is its own);
  * ``jnp.lexsort`` is two stable sorts, ``lax.top_k`` a stable sort.

Host syncs per inserted batch on the card: none in the wiring (one kernel
launch); the CPU's rounds sync once a round, once a round with
overflowing targets and once for the round count (see PERF.md).
"""

from __future__ import annotations

import functools

import torch

from ..ops.bruteforce import _rerank_exact, merge_min_k
from ..ops.cuda_bruteforce import dequantize_rows, sweep_pool
from ..ops.distance import dist_one_to_many, pairwise_dist
from ..ops.cuda_graph import connect_batch, prune_scan
from .graph import GraphState
from .search import search_graph

_INF = float("inf")
# default rows per step of the torch-op candidate sweep (the index's
# exact8_chunk knob, see HnswIndex.tune_exact8_chunk; the card's sweep
# kernel takes no chunk): int8 rows are cheap to score, so the loop takes
# few wide steps (a [256, 1M] float32 score tile is 1 GB)
EXACT8_CHUNK = 1_048_576

# Candidate sweeps run as the torch-op loop on a CUDA tensor: none on the
# main path, which launches the sweep kernel for every metric; a run reads
# it to show that no sweep left the kernel.
PLAIN_SWEEPS_ON_CARD = 0
# Back-link replays run in torch ops on a CUDA tensor (_replay_chains): none
# on the main path, which launches ops/cuda_graph.connect_batch; a run reads
# it to show that no wiring left the kernel.
PLAIN_CONNECTS_ON_CARD = 0
# the chain order's sort key of an invalid back-link op (after every node)
NO_TARGET = torch.iinfo(torch.int32).max


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Per-row order by (primary asc, secondary asc), stable: the
    ``jnp.lexsort((secondary, primary))`` of each row."""
    o1 = torch.argsort(secondary, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(primary, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def _prune_order(cand_d: torch.Tensor, cand_i: torch.Tensor, nn: int):
    """The prune's scan order: (key_d f32[B, C], the distances with invalid
    entries at inf; order i64[B, C], nearest-first with ties larger-id-first
    and invalid entries last; d_s f32[B, C] and valid_s bool[B, C] in that
    order; do_prune bool[B], whether at least nn candidates are valid)."""
    valid = (cand_i >= 0) & torch.isfinite(cand_d)
    do_prune = valid.sum(dim=1) >= nn
    key_d = torch.where(valid, cand_d, _INF)
    order = _lexsort2(key_d, -cand_i)
    return (key_d, order, torch.gather(key_d, 1, order),
            torch.gather(valid, 1, order), do_prune)


def _prune_scan_plain(d_s: torch.Tensor, valid_s: torch.Tensor,
                      order: torch.Tensor, pair_d: torch.Tensor,
                      do_prune: torch.Tensor, nn: int):
    """The prune's keep/reject scan in torch ops, the plain twin of
    ops/cuda_graph.prune_scan: candidate j (in scan order) is kept iff it
    is valid, fewer than nn are kept, and, where the set is pruned, no
    kept r has pair_d[order[j], order[r]] < d_s[j].  ``pair_d`` is in the
    original candidate order.  Returns (kept_mask bool[B, C], kept_count
    i32[B])."""
    bsz, c = d_s.shape
    dev = d_s.device
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
    return kept_mask, kept_count


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
    key_d, order, d_s, valid_s, do_prune = _prune_order(cand_d, cand_i, nn)
    i_s = torch.gather(cand_i, 1, order)
    # the scan: the kernel on a CUDA tensor, _prune_scan_plain on the CPU.
    # Re-prune distances of bf16 rows come in bf16; the scan compares them
    # with float32 pair distances, so widening them first (exactly) gives
    # the same comparisons
    kept_mask, kept_count = prune_scan(d_s.to(torch.float32), valid_s, order,
                                       pair_d.contiguous(), do_prune, nn)

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


def _forward_valid(kept_i, kept_cnt, n_insert: int, *, m: int):
    """(valid_f bool[b, m], kept_cnt i32[b]): which kept slots hold a link
    (slot below the kept count, an id, member before n_insert) and the kept
    counts with members at or past n_insert at 0."""
    b = kept_i.shape[0]
    dev = kept_i.device
    kept_cnt = torch.where(torch.arange(b, device=dev) < n_insert, kept_cnt,
                           0)
    valid_f = ((torch.arange(m, device=dev) < kept_cnt.unsqueeze(1)) &
               (kept_i >= 0))
    return valid_f, kept_cnt


def _back_link_targets(kept_i, kept_cnt, n_insert: int, *,
                       m: int) -> torch.Tensor:
    """The batch's back-link targets i32[b * m]: op ``member * m + slot``
    targets kept_i[member, slot], -1 where the op is invalid (slot past the
    kept count, no id, or member at or past n_insert).  Writes nothing."""
    valid_f, _ = _forward_valid(kept_i, kept_cnt, n_insert, m=m)
    return torch.where(valid_f, kept_i, -1).reshape(-1)


def _forward_links(links, link_counts, base: int, kept_i, kept_cnt,
                   n_insert: int, *, m: int, max_m: int) -> None:
    """Commit every member's forward row (hnswalg.cpp:168-181) in place."""
    valid_f, kept_cnt = _forward_valid(kept_i, kept_cnt, n_insert, m=m)
    fwd = torch.full((kept_i.shape[0], max_m), -1, dtype=torch.int32,
                     device=kept_i.device)
    fwd[:, :m] = torch.where(valid_f, kept_i, -1)
    links[base:base + n_insert] = fwd[:n_insert]
    link_counts[base:base + n_insert] = kept_cnt[:n_insert]


def _chain_order(tgt: torch.Tensor):
    """The back-link ops grouped into per-target chains in op order: a
    stable sort of the targets, invalid ops (-1) last at NO_TARGET.
    Returns (keys i32[bm] sorted, perm i64[bm], the ops' indices)."""
    keys = torch.where(tgt >= 0, tgt, NO_TARGET)
    return torch.sort(keys, stable=True)


def _chain_rank(keys: torch.Tensor) -> torch.Tensor:
    """Each sorted op's place in its chain (0 at the chain's head), -1 for
    invalid ops: the JAX package's per-target occurrence rank, read off the
    sorted keys."""
    pos = torch.arange(keys.shape[0], device=keys.device)
    head = torch.searchsorted(keys, keys)                # leftmost equal key
    return torch.where(keys != NO_TARGET, pos - head, -1)


def _replay_chains(vectors, links, link_counts, keys, perm, *, base: int,
                   m: int, max_m: int, metric_value: int):
    """Apply the sorted back-link ops (_chain_order) to ``links`` and
    ``link_counts`` in place, each target's in op order: append where the
    target has room (hnswalg.cpp:193-195), else re-prune it (_reprune).
    The chains of ops/cuda_graph.connect_batch's plain twin
    (_connect_sorted_plain, after the forward rows): round r applies every
    chain's r-th op (targets within a round are distinct), with a host
    sync a round and one for the round count."""
    global PLAIN_CONNECTS_ON_CARD
    if links.is_cuda:
        PLAIN_CONNECTS_ON_CARD += 1
    rank = _chain_rank(keys)
    n_rounds = int(rank.max()) + 1 if keys.numel() else 0
    cur = (base + torch.div(perm, m, rounding_mode="floor")).to(torch.int32)
    slot_mm = torch.arange(max_m, device=keys.device)
    for r in range(n_rounds):
        lanes = (rank == r).nonzero().squeeze(1)
        t = keys[lanes]
        c = cur[lanes]
        rows = links[t]
        cnts = link_counts[t]
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


def _connect_sorted_plain(vectors, links, link_counts, keys, perm, kept_i,
                          kept_cnt, *, base: int, n_insert: int, m: int,
                          max_m: int, metric_value: int):
    """The plain twin of ops/cuda_graph.connect_batch, on its operands: the
    forward rows (_forward_links), then the sorted back-link ops
    (_replay_chains)."""
    _forward_links(links, link_counts, base, kept_i, kept_cnt, n_insert, m=m,
                   max_m=max_m)
    return _replay_chains(vectors, links, link_counts, keys, perm, base=base,
                          m=m, max_m=max_m, metric_value=metric_value)


def _connect_batch(vectors, links, link_counts, base: int, kept_i, kept_cnt,
                   n_insert: int, *, m: int, max_m: int, metric_value: int,
                   replay=connect_batch):
    """Wire a whole batch: the result of running mutuallyConnectNewElement
    (hnswalg.cpp:155-223) serially over the batch, updating ``links`` and
    ``link_counts`` in place.

    Back-link state depends only on the sequence of operations applied to
    each target, so the serial schedule splits into per-target chains:
    forward rows commit at once (a member's row exists before a later
    member's back-link can target it), then each target replays its own
    back-link ops in op order.  Here the back-link targets and their chain
    order are torch ops that write nothing; ``replay`` writes the forward
    rows and replays the chains.  On the card that is one launch of
    ops/cuda_graph.connect_batch and the batch makes no host sync; on the
    CPU, and for the twin (_connect_batch_plain), _connect_sorted_plain."""
    keys, perm = _chain_order(_back_link_targets(kept_i, kept_cnt, n_insert,
                                                 m=m))
    return replay(vectors, links, link_counts, keys, perm, kept_i, kept_cnt,
                  base=base, n_insert=n_insert, m=m, max_m=max_m,
                  metric_value=metric_value)


# _connect_batch in torch ops: the chain order, the forward rows and the
# rounds of _replay_chains.  The CPU's route; on the card only the smoke's
# and the tests' comparisons call it (counted in PLAIN_CONNECTS_ON_CARD).
_connect_batch_plain = functools.partial(_connect_batch,
                                         replay=_connect_sorted_plain)


def _sweep_loop(vectors, pts32, base: int, keep: int, metric_value: int,
                chunk: int, qvec=None, qscale=None):
    """The candidate pool in torch ops, ``chunk`` rows a step: each chunk
    scored by pairwise_dist, cut to its ``keep`` smallest, merged into the
    running pool (the JAX package's fori_loop).  The CPU's route and the
    sweep kernel's twin; on the card only comparisons call it (counted in
    PLAIN_SWEEPS_ON_CARD).  Returns (d f32[B, keep], ids i32[B, keep])
    ascending, -1 padded."""
    global PLAIN_SWEEPS_ON_CARD
    if pts32.is_cuda:
        PLAIN_SWEEPS_ON_CARD += 1
    b = pts32.shape[0]
    dev = pts32.device
    run_d = torch.full((b, keep), _INF, dtype=torch.float32, device=dev)
    run_i = torch.full((b, keep), -1, dtype=torch.int32, device=dev)
    for start in range(0, base, chunk):
        end = min(start + chunk, base)
        if qvec is not None:
            rows = dequantize_rows(qvec[start:end], qscale[start:end]).to(
                torch.float32)
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
    return run_d, run_i


def _exact_candidates(vectors, points, base: int, *, cand_cap: int,
                      metric_value: int, chunk: int = 32768,
                      qvec=None, qscale=None):
    """Construction candidates from a full sweep of rows [0, base) instead
    of the beam walk (HnswIndex(build_candidates="exact"/"exact8")).

    COARSE mode (``qvec``/``qscale`` given, the "exact8" engine) scores the
    int8 shadow rows dequantized in bf16 — the product ``q.bf16 * s.bf16``
    rounds exactly as the JAX package's does — against the float32 points,
    keeps a 2x-widened pool, and reranks it with the exact float32
    difference form.  Plain mode sweeps the stored rows and keeps
    cand_cap + 2 before the same rerank.

    The pool: on the card one launch of the sweep kernel over [0, base),
    every metric (ops/cuda_bruteforce.sweep_pool; Manhattan summed on the
    CUDA cores; ``chunk`` is not used); on the CPU the torch-op loop,
    ``chunk`` rows a step (_sweep_loop).

    Returns (cand_d [B, cand_cap], cand_i [B, cand_cap]) ascending,
    -1-padded (tombstones stay candidates: deletes filter results, not
    waypoints, hnswalg.cpp:245)."""
    coarse = qvec is not None
    keep = 2 * cand_cap if coarse else cand_cap + 2
    pts32 = points.to(torch.float32).contiguous()
    if pts32.device.type == "cpu":
        _, run_i = _sweep_loop(vectors, pts32, base, keep, metric_value,
                               chunk, qvec, qscale)
    else:
        _, run_i = sweep_pool(pts32, (qvec, qscale) if coarse else vectors,
                              keep, metric_value, base)
    # exact rerank with the reference's elementwise forms
    return _rerank_exact(pts32, vectors, run_i, k=cand_cap,
                         metric_value=metric_value)


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
                      qvec=None, qscale=None,
                      exact8_chunk: int = EXACT8_CHUNK) -> GraphState:
    """Insert the first ``n_insert`` rows of ``points`` (the aminsert /
    ambuild hot path, embedding.c:606-701 + hnswalg.cpp:225-232), updating
    ``graph`` in place; returns it.

    Stages all rows of ``points`` at n_nodes (they are unreachable until
    links exist), finds candidates, merges earlier batch members as
    brute-force candidates, prunes to M, and wires the links.  For
    "exact8" the caller has already staged the batch's int8 rows into
    ``qvec``/``qscale``, and the sweep scores ``exact8_chunk`` rows a step.
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
            metric_value=metric_value, chunk=exact8_chunk,
            qvec=qvec, qscale=qscale)
    elif candidates == "beam":
        # batched searchBaseLayer(point, efConstruction) (hnswalg.cpp:229)
        # over the pre-batch graph (n_nodes is still base)
        cand_d, cand_i, _ = search_graph(
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
