"""Compressed brute-force sweep — the counterpart of
pg_embedding_tpu/ops/pq_sweep.py.

The exact sweep reads every stored row; this one reads the rows' PQ codes
(G bytes a row instead of 4*D), decodes each chunk through the codebook
(ops/pq.pq_decode), keeps a running top-``pool`` per query by the decoded
distance (ops/bruteforce.sweep_min_k), then reranks the pool with the exact
elementwise distance on the stored rows (ops/bruteforce._rerank_exact).
Returned distances are exact; the pool is approximate, so recall < 1.0 and
``pool`` prices it.

As in the JAX package, the decoded rows are rounded to bf16 before they
are scored; the score then follows the JAX package's CPU semantics
(ops/distance.pairwise_dist upcasts bf16 rows to float32).  Ties keep the
lower id, which is what ``lax.top_k`` over incumbents + chunk gives.
"""

from __future__ import annotations

import torch

from ..config import Metric, resolve_metric
from .bruteforce import _rerank_exact, sweep_min_k
from .distance import _matmul, pairwise_dist
from .pq import pq_decode


def _pq_pool(queries, codes, codebook, rotation, n_valid: int, deleted, *,
             pool: int, metric_value: int, chunk: int):
    """Chunked coarse sweep over codes u8[N, G]: (dists f32[B, pool], ids
    i32[B, pool]) ascending by the decoded distance, rows >= n_valid and
    ``deleted`` rows skipped.  ``queries`` are in the original space and
    rotated here under OPQ."""
    q = queries if rotation is None else _matmul(queries, rotation)

    def score(qq, cblk):
        rows = pq_decode(cblk, codebook).to(torch.bfloat16)
        return pairwise_dist(qq, rows, metric_value)

    return sweep_min_k(q, codes, pool, n_valid, deleted, score, chunk)


def pq_sweep_search(queries, codes, codebook, rotation, points, k: int,
                    metric=Metric.L2, *, n_valid=None, deleted=None,
                    pool: int | None = None, chunk: int = 16384):
    """Top-k by compressed sweep + exact rerank.

    Args:
      queries:  f32[B, D] in the original space (moved to ``codes``'
                device).
      codes:    u8[N, G] per-row PQ codes (rotated space under OPQ).
      codebook: f32[G, 256, D/G].
      rotation: f32[D, D] OPQ rotation or None.
      points:   [N_pts, D] stored rows (float32 or bf16) for the rerank.
      k:        results per query.
      metric:   Metric / operator string (the rerank uses its exact form).
      n_valid:  live-row count (default: all of ``codes``).
      deleted:  optional bool[N] mask; True rows are skipped.
      pool:     coarse candidates per query before the rerank (default
                min(max(4k, k + 28), 256); never below k).
      chunk:    code rows per sweep step.

    Returns (dists f32[B, k] ascending exact distances, ids i32[B, k];
    -1 => fewer than k live rows).
    """
    metric = resolve_metric(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=codes.device)
    n = codes.shape[0] if n_valid is None else min(int(n_valid),
                                                   codes.shape[0])
    if pool is None:
        pool = min(max(4 * k, k + 28), 256)
    pool = max(int(pool), int(k))
    if deleted is not None:
        deleted = torch.as_tensor(deleted, dtype=torch.bool,
                                  device=codes.device)
    _, i_pool = _pq_pool(queries, codes, codebook, rotation, n, deleted,
                         pool=pool, metric_value=metric.value, chunk=chunk)
    return _rerank_exact(queries, points, i_pool, k=int(k),
                         metric_value=metric.value)
