"""Exact (brute-force) k-NN — the seq-scan ground-truth path.

In the reference, exact ordering comes from a sequential scan + Sort using
the row-at-a-time distance operators (embedding.c:1022-1062).  Here it is a
chunked distance-matrix sweep with a running top-k merge, in plain torch
ops.  It is (a) the recall oracle for every ANN test, (b) the Manhattan
route of the exact entry (ops/cuda_bruteforce.fused_exact_search), which
has no matmul form for the hand kernel.

Ordering contract, shared by every top-k in the package: results ascend by
(distance, position), i.e. ties keep the lower id / the incumbent.  The JAX
package gets that from ``lax.top_k``; ``torch.topk`` promises no order
among ties, so selections here are stable sorts (:func:`min_k`).
"""

from __future__ import annotations

import torch

from ..config import Metric, resolve_metric
from .distance import dist_one_to_many, pairwise_dist

# Extra candidates fetched by the matmul-form sweep before the exact
# elementwise rerank.  The L2 matmul expansion |p|^2+|q|^2-2pq cancels in
# f32 when |p|^2 >> d^2, which can sink a true top-k item a rank or two;
# the sweep over-fetches and the final top-k is re-scored with the exact
# difference form (distfunc.c:121-130 semantics) on the gathered rows.
_RERANK_PAD = 2

_INF = float("inf")


def min_k(d: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ascending; ties keep the
    lower position.  Returns (values, positions int64)."""
    vals, sel = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], sel[..., :k]


def merge_min_k(d_a, i_a, d_b, i_b, k: int):
    """Merge two (dist, id) sets along the last axis, keep the k smallest;
    on ties set a (the incumbents) wins."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    vals, sel = min_k(d, k)
    return vals, torch.gather(i, -1, sel)


def as_corpus(points) -> torch.Tensor:
    """A corpus tensor keeps its storage dtype (float32 or bfloat16, which
    the sweeps upcast one chunk at a time); anything else becomes float32."""
    if isinstance(points, torch.Tensor) and points.dtype == torch.bfloat16:
        return points
    return torch.as_tensor(points, dtype=torch.float32)


def _rerank_exact(queries, points, i_run, *, k: int, metric_value: int):
    """Re-score [B, k_run] candidate ids with the exact elementwise
    distance form and keep the k best (ascending; -1 ids stay last)."""
    rows = points[i_run.clamp(min=0)].to(torch.float32)       # [B, k_run, D]
    d = dist_one_to_many(queries, rows, metric_value)
    d = torch.where(i_run >= 0, d, _INF)
    vals, sel = min_k(d, k)
    return vals, torch.gather(i_run, 1, sel)


def sweep_min_k(queries, points, k: int, n_valid: int, deleted, score,
                chunk: int, after=None):
    """Running top-k of ``score(queries, rows)`` over rows [0, n_valid),
    ``chunk`` rows at a time.  Masked rows (tombstones, and everything past
    n_valid) come back as (inf, -1) when fewer than k rows qualify.  With
    ``after`` (d f32[B], ids i32[B]) a row qualifies only if it follows
    (d[q], ids[q]) in (score, id) order; id -1 follows every row.
    Returns (d f32[B, k], ids i32[B, k]) ascending by (score, id)."""
    if after is not None:
        floor_d = after[0].unsqueeze(1)
        floor_i = torch.where(after[1] < 0, torch.iinfo(torch.int32).max,
                              after[1]).unsqueeze(1)
    b = queries.shape[0]
    dev = queries.device
    run_d = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    run_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n_valid, chunk):
        end = min(start + chunk, n_valid)
        d = score(queries, points[start:end])                # [B, end-start]
        ids = torch.arange(start, end, dtype=torch.int32, device=dev)
        ids = ids.unsqueeze(0).expand(b, -1)
        if deleted is not None:
            dead = deleted[start:end].unsqueeze(0)
            d = d.masked_fill(dead, _INF)
            ids = ids.masked_fill(dead, -1)
        if after is not None:
            before = (d < floor_d) | ((d == floor_d) & (ids <= floor_i))
            d = d.masked_fill(before, _INF)
            ids = ids.masked_fill(before, -1)
        run_d, run_i = merge_min_k(run_d, run_i, d, ids, k)
    return run_d, run_i


def exact_search(queries, points, k: int, metric=Metric.L2,
                 n_valid=None, deleted=None, chunk: int = 15360):
    """Exact top-k nearest neighbors.

    Args:
      queries: [B, D] float32 (tensor or array; moved to ``points``' device).
      points:  [N, D] float32 or bfloat16 (may be padded; pass n_valid).
      k:       results per query.
      metric:  Metric / operator string.
      n_valid: number of valid rows in ``points`` (default: all).
      deleted: optional bool[N] tombstone mask; True rows are excluded.
      chunk:   corpus rows per sweep step.

    Returns (dists f32[B, k] ascending, idxs i32[B, k]; idx == -1 => no
    such neighbor).
    """
    metric = resolve_metric(metric)
    points = as_corpus(points)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=points.device)
    n = points.shape[0] if n_valid is None else min(int(n_valid),
                                                    points.shape[0])
    if deleted is not None:
        deleted = torch.as_tensor(deleted, dtype=torch.bool,
                                  device=points.device)
    k = int(k)

    def score(q, p):
        return pairwise_dist(q, p, metric.value)

    if metric is Metric.L2:
        # over-fetch + exact rerank: the matmul form's f32 cancellation can
        # sink true top-k items a few ranks down (see _RERANK_PAD)
        _, i_run = sweep_min_k(queries, points, k + _RERANK_PAD, n,
                               deleted, score, chunk)
        return _rerank_exact(queries, points, i_run, k=k,
                             metric_value=metric.value)
    return sweep_min_k(queries, points, k, n, deleted, score, chunk)
