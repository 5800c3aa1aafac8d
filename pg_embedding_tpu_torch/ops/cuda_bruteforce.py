"""Fused exact k-NN: the hand-written CUDA kernel and its plain twin.

The counterpart of pg_embedding_tpu/ops/pallas_bruteforce.py.  The kernel
(``csrc/bruteforce_topk.cu``) scores a query batch against the corpus on
the tensor cores (TF32 ``mma.sync`` with a hi/lo split: three passes for
float32 rows, two for bf16 rows) and keeps a running per-query top-k on
chip, so the [B, N] distance matrix is never written out.  Its note says
what bounds it on the card and how the design answers that.  It has two
instantiations, one per corpus dtype: ``bruteforce_topk`` (float32 rows)
and ``bruteforce_topk_bf16`` (bfloat16 rows, exact in TF32).
``_launch_shape`` chooses each launch's query tile, corpus splits and
shared memory here, where the CPU tests reach it.

``bruteforce_topk`` is the wrapper: on a CPU tensor it runs
``_bruteforce_topk_plain`` (the same function in plain torch), on a CUDA
tensor it launches the instantiation for the corpus dtype or raises.  One
launch keeps at most MAX_K_RUN entries per query (its running lists live in
shared memory); ``bruteforce_topk_paged`` takes any k_run in pages of at
most MAX_K_RUN, each launch admitting only what follows the last entry of
the page before.  ``fused_exact_search`` is the entry with the contract of
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
# a block up to here; a longer list takes pages of at most this.
MAX_K_RUN = 1024

# The sweep's launch shape, mirrored from csrc/bruteforce_topk.cu (whose
# launch refuses a shared-memory figure that differs from its own): 128-row
# corpus tiles streamed in 32-dim chunks through a 2-stage ring, padded row
# strides (corpus: 32 dims + 16 bytes; streamed query chunks: 36 floats;
# resident queries: D in whole chunks + 4 floats; scores: 136 floats), the
# query tile QT by tier of k_run, 8 bytes per list entry.
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
MAX_SPLITS = 128
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 233_472, 1024     # H100
_TILE_N, _TILE_D, _STAGES = 128, 32, 2
_Q_STRIDE, _SCORE_STRIDE = 36, 136
_MIN_ROWS_PER_SPLIT = 2048
_QT_TIERS = ((256, 64), (MAX_K_RUN, 16))               # (k_run <=, QT)

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
                           n_valid: int, deleted=None, after=None):
    """The kernel's function in plain torch: (d f32[B, k_run], ids
    i32[B, k_run]) ascending by (score, id), masked rows never admitted,
    L2 sqrt'd; ``after`` as in bruteforce_topk."""
    d, i = sweep_min_k(queries, points, k_run, min(n_valid, len(points)),
                       deleted,
                       lambda q, p: _scores(q, p, metric_value),
                       _PLAIN_CHUNK, after)
    if after is not None:
        after[0].copy_(d[:, -1])
        after[1].copy_(i[:, -1])
    if metric_value == Metric.L2.value:
        d = torch.sqrt(d)
    return d, i


def _smem_bytes(qt: int, k_run: int, itemsize: int, dims: int,
                q_resident: bool) -> int:
    stage = _TILE_N * (_TILE_D * itemsize + 16)
    if q_resident:
        queries = qt * (_TILE_D * -(-dims // _TILE_D) + 4) * 4
    else:
        stage, queries = stage + qt * _Q_STRIDE * 4, 0
    return (_STAGES * stage + queries
            + 4 * (qt * _SCORE_STRIDE + qt + _TILE_N) + 8 * qt * k_run)


def _blocks_per_sm(smem: int) -> int:
    return min(2, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


def _launch_shape(b: int, n_rows: int, k_run: int, sms: int,
                  itemsize: int = 4, dims: int = 128):
    """(QT, corpus splits S, resident queries, shared-memory bytes) of a
    sweep launch for ``b`` queries, ``n_rows`` rows of ``dims``
    ``itemsize``-byte elements and ``k_run`` on a card with ``sms`` SMs.

    QT is the largest query tile whose running lists fit beside the ring.
    The block keeps its [QT, D] queries in shared memory for its whole
    sweep, instead of streaming a query chunk beside every corpus chunk,
    when that fits and leaves as many blocks on an SM: it halves what a
    bf16 sweep reads through L2.  Two blocks share an SM where their shared
    memory allows (QT = 64 at small k_run), so one block's selection
    overlaps the other's mma's.  S fills the SMs' block slots as evenly as
    whole waves allow (the fewest splits on a tie), with no split under
    2048 rows."""
    qt = next(qt for k_max, qt in _QT_TIERS if k_run <= k_max)
    streamed = _smem_bytes(qt, k_run, itemsize, dims, False)
    resident = _smem_bytes(qt, k_run, itemsize, dims, True)
    q_res = (resident <= SMEM_LIMIT
             and _blocks_per_sm(resident) >= _blocks_per_sm(streamed))
    smem = resident if q_res else streamed
    slots = sms * _blocks_per_sm(smem)
    q_tiles = -(-b // qt)
    cap = max(1, min(MAX_SPLITS, -(-n_rows // _MIN_ROWS_PER_SPLIT)))

    def fill(s):
        blocks = q_tiles * s
        return blocks / (-(-blocks // slots) * slots)
    splits = max(range(1, cap + 1), key=lambda s: (fill(s), -s))
    return qt, splits, q_res, smem


def _check_args(queries, points, k_run, metric_value, deleted,
                after) -> None:
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
    if after is not None:
        fd, fi = after
        for t, dt in ((fd, torch.float32), (fi, torch.int32)):
            if (t.dtype != dt or t.shape != queries.shape[:1]
                    or t.device != points.device or not t.is_contiguous()):
                raise ValueError("after must be contiguous (f32[B], i32[B]) "
                                 "tensors on the points' device")


def bruteforce_topk(queries, points, k_run: int, metric_value: int,
                    n_valid: int, deleted=None, after=None):
    """Exact top-k_run (k_run <= MAX_K_RUN) of queries f32[B, D] against
    points f32 or bf16 [N, D] rows [0, n_valid), skipping ``deleted`` rows.
    Returns (d f32[B, k_run], ids i32[B, k_run]), ascending by (score, id),
    -1/+inf padded, L2 sqrt'd.

    ``after`` (floor_d f32[B], floor_i i32[B]), a page floor: only rows
    that follow (floor_d[q], floor_i[q]) in (score, id) order are admitted
    (scores before the L2 sqrt; id -1 follows every row), and the call
    overwrites it with each query's last entry, the next page's floor."""
    _check_args(queries, points, k_run, metric_value, deleted, after)
    if points.device.type == "cpu":
        return _bruteforce_topk_plain(queries, points, k_run, metric_value,
                                      n_valid, deleted, after)
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qt, splits, q_res, smem = _launch_shape(
        b, n_rows, k_run, sms, points.element_size(), dims)
    with torch.cuda.device(dev):
        part_d = torch.empty((splits, b, k_run), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((splits, b, k_run), dtype=torch.int32,
                             device=dev)
        err = getattr(lib, name)(
            queries.data_ptr(), points.data_ptr(),
            None if deleted is None else deleted.data_ptr(),
            b, n_rows, dims, k_run, metric_value, qt, splits, int(q_res),
            smem, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), None if after is None else after[0].data_ptr(),
            None if after is None else after[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def bruteforce_topk_paged(queries, points, k_run: int, metric_value: int,
                          n_valid: int, deleted=None):
    """bruteforce_topk for any k_run >= 1: one call up to MAX_K_RUN, else
    equal pages of at most MAX_K_RUN, each a call whose floor is the last
    entry of the page before.  A score depends on its query and row alone,
    so the pages concatenate to the single ascending list."""
    if k_run <= MAX_K_RUN:
        return bruteforce_topk(queries, points, k_run, metric_value, n_valid,
                               deleted)
    b, dev = queries.shape[0], points.device
    size = -(-k_run // -(-k_run // MAX_K_RUN))
    after = (torch.full((b,), -float("inf"), dtype=torch.float32,
                        device=dev),
             torch.full((b,), -1, dtype=torch.int32, device=dev))
    pages = [bruteforce_topk(queries, points, min(size, k_run - start),
                             metric_value, n_valid, deleted, after)
             for start in range(0, k_run, size)]
    return (torch.cat([d for d, _ in pages], dim=1),
            torch.cat([i for _, i in pages], dim=1))


def fused_exact_search(queries, points, k: int, metric=Metric.L2,
                       n_valid=None, deleted=None):
    """Exact top-k — the counterpart of ``pallas_exact_search``, with the
    contract of ops.bruteforce.exact_search.

    L2/cosine run the fused kernel (its plain twin on CPU tensors), in
    pages when k_run (k + _RERANK_PAD for L2, else k) exceeds MAX_K_RUN;
    Manhattan has no matmul form and routes to ops.bruteforce.  For L2 the
    kernel fetches k + _RERANK_PAD and the difference form reranks them.
    ``points`` may be float32 or bfloat16 (a bf16-storage corpus).  Returns
    (dists f32[B, k] ascending, ids i32[B, k]; -1 => none)."""
    metric = resolve_metric(metric)
    k = int(k)
    k_run = k + _RERANK_PAD if metric is Metric.L2 else k
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
    d, i = bruteforce_topk_paged(queries, points, k_run, metric.value, n,
                                 deleted)
    if k_run != k:
        return _rerank_exact(queries, points, i, k=k,
                             metric_value=metric.value)
    return d, i
