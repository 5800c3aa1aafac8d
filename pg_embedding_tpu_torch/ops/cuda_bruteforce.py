"""Fused exact k-NN: the hand-written CUDA kernel and its plain twin.

The counterpart of pg_embedding_tpu/ops/pallas_bruteforce.py.  The kernel
(``csrc/bruteforce_topk.cu``) scores a query batch against the corpus with
float32 FMA and keeps a running per-query top-k on chip, so the [B, N]
distance matrix is never written out.  Its note says what bounds it on the
card and how the design answers that.  It has two instantiations, one per
corpus dtype: ``bruteforce_topk`` (float32 rows) and
``bruteforce_topk_bf16`` (bfloat16 rows, widened to float32 on load).

``bruteforce_topk`` is the wrapper: on a CPU tensor it runs
``_bruteforce_topk_plain`` (the same function in plain torch), on a CUDA
tensor it launches the instantiation for the corpus dtype or raises.
``fused_exact_search`` is the entry with the contract of
``pallas_exact_search``: Manhattan goes to ops/bruteforce, L2 fetches
k + _RERANK_PAD and reranks with the difference form.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import Metric, resolve_metric
from .bruteforce import (_RERANK_PAD, _rerank_exact, as_corpus,
                         exact_search, sweep_min_k)
from .distance import _matmul

# Launches of each instantiation since import (or since a caller reset
# them); a run reads them to show that a path went through the kernel.
LAUNCHES = {"bruteforce_topk": 0, "bruteforce_topk_bf16": 0}

# Running lists live in shared memory: 8 bytes x k_run x 16 queries fit
# a block up to here.
MAX_K_RUN = 1024

_PLAIN_CHUNK = 16384

# the kernel instantiation for each corpus dtype
_KERNELS = {torch.float32: "bruteforce_topk",
            torch.bfloat16: "bruteforce_topk_bf16"}


def _scores(queries, rows, metric_value: int) -> torch.Tensor:
    """The kernel's score in matmul form: squared L2 (before the sqrt) or
    cosine distance, [B, n]; bf16 rows are upcast first."""
    rows = rows.to(torch.float32)
    qp = _matmul(queries, rows.T)
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    pn = torch.sum(rows * rows, dim=1).unsqueeze(0)
    if metric_value == Metric.L2.value:
        return torch.clamp(pn + qn - 2.0 * qp, min=0.0)
    return 1.0 - qp * torch.rsqrt(torch.clamp(pn * qn, min=1e-30))


def _bruteforce_topk_plain(queries, points, k_run: int, metric_value: int,
                           n_valid: int, deleted=None):
    """The kernel's function in plain torch: (d f32[B, k_run], ids
    i32[B, k_run]) ascending by (score, id), masked rows never admitted,
    L2 sqrt'd."""
    d, i = sweep_min_k(queries, points, k_run, min(n_valid, len(points)),
                       deleted,
                       lambda q, p: _scores(q, p, metric_value),
                       _PLAIN_CHUNK)
    if metric_value == Metric.L2.value:
        d = torch.sqrt(d)
    return d, i


def _check_args(queries, points, k_run, metric_value, deleted) -> None:
    if metric_value not in (Metric.L2.value, Metric.COSINE.value):
        raise ValueError(f"the fused kernel takes L2 or cosine, not metric "
                         f"{metric_value}")
    if not 1 <= k_run <= MAX_K_RUN:
        raise ValueError(f"k_run={k_run} outside [1, {MAX_K_RUN}]")
    if queries.dim() != 2 or points.dim() != 2 or (
            queries.shape[1] != points.shape[1]):
        raise ValueError(f"shapes {tuple(queries.shape)} and "
                         f"{tuple(points.shape)} are not [B, D] and [N, D]")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if points.dtype not in _KERNELS:
        raise ValueError(f"points must be float32 or bfloat16, got "
                         f"{points.dtype}")
    for name, t in (("queries", queries), ("points", points)):
        if t.device != points.device:
            raise ValueError(f"{name} on {t.device}, points on "
                             f"{points.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if deleted is not None:
        if (deleted.dtype != torch.bool or deleted.shape != points.shape[:1]
                or deleted.device != points.device
                or not deleted.is_contiguous()):
            raise ValueError("deleted must be a contiguous bool[N] tensor "
                             "on the points' device")


def bruteforce_topk(queries, points, k_run: int, metric_value: int,
                    n_valid: int, deleted=None):
    """Exact top-k_run of queries f32[B, D] against points f32 or bf16
    [N, D] rows [0, n_valid), skipping ``deleted`` rows.  Returns (d
    f32[B, k_run], ids i32[B, k_run]), ascending by (score, id), -1/+inf
    padded, L2 sqrt'd."""
    _check_args(queries, points, k_run, metric_value, deleted)
    if points.device.type == "cpu":
        return _bruteforce_topk_plain(queries, points, k_run, metric_value,
                                      n_valid, deleted)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    b, dims = queries.shape
    n_rows = max(0, min(int(n_valid), points.shape[0]))
    dev = points.device
    out_d = torch.empty((b, k_run), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_run), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = _kernels.load_library()
    name = _KERNELS[points.dtype]
    with torch.cuda.device(dev):
        splits = lib.bruteforce_topk_splits(b, n_rows, k_run)
        part_d = torch.empty((splits, b, k_run), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((splits, b, k_run), dtype=torch.int32,
                             device=dev)
        err = getattr(lib, name)(
            queries.data_ptr(), points.data_ptr(),
            None if deleted is None else deleted.data_ptr(),
            b, n_rows, dims, k_run, metric_value, splits,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def fused_exact_search(queries, points, k: int, metric=Metric.L2,
                       n_valid=None, deleted=None):
    """Exact top-k — the counterpart of ``pallas_exact_search``, with the
    contract of ops.bruteforce.exact_search.

    L2/cosine run the fused kernel (its plain twin on CPU tensors);
    Manhattan has no matmul form and routes to ops.bruteforce.  For L2 the
    kernel fetches k + _RERANK_PAD and the difference form reranks them.
    ``points`` may be float32 or bfloat16 (a bf16-storage corpus).
    Returns (dists f32[B, k] ascending, ids i32[B, k]; -1 => none)."""
    metric = resolve_metric(metric)
    if metric is Metric.MANHATTAN:
        return exact_search(queries, points, k, metric, n_valid=n_valid,
                            deleted=deleted)
    points = as_corpus(points)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=points.device).contiguous()
    n = points.shape[0] if n_valid is None else int(n_valid)
    if deleted is not None:
        deleted = torch.as_tensor(deleted, dtype=torch.bool,
                                  device=points.device)
    k = int(k)
    k_run = k + _RERANK_PAD if metric is Metric.L2 else k
    d, i = bruteforce_topk(queries, points, k_run, metric.value, n, deleted)
    if k_run != k:
        return _rerank_exact(queries, points, i, k=k,
                             metric_value=metric.value)
    return d, i
