"""Fused exact k-NN: the hand-written CUDA kernel and its plain twin.

The counterpart of pg_embedding_tpu/ops/pallas_bruteforce.py.  The kernel
(``csrc/bruteforce_topk.cu``) scores a query batch against the corpus on
the tensor cores (TF32 ``mma.sync`` with a hi/lo split: three passes for
float32 rows, two for bf16 rows) and keeps a running per-query top-k on
chip, so the [B, N] distance matrix is never written out.  Its note says
what bounds it on the card and how the design answers that.  It has three
instantiations for L2 and cosine, one per corpus type: ``bruteforce_topk``
(float32 rows), ``bruteforce_topk_bf16`` (bfloat16 rows, exact in TF32)
and ``bruteforce_topk_q8`` (int8 rows x a float32 scale a row, each
element bf16(bf16(q) * bf16(scale)): the build's int8 shadow, exact in
TF32 too), and three for Manhattan, which has no matmul form and is summed
on the CUDA cores: ``bruteforce_topk_l1``, ``_bf16_l1`` and ``_q8_l1``.
Lists of WIDE_MIN_K to WIDE_MAX_K entries (the build's pools, the exact
route's k past 61) run the wide selection, the int8 and Manhattan
instances' at every k_run up to WIDE_MAX_K, float32 / bf16 rows under L2
and cosine through ``bruteforce_topk_wide`` / ``bruteforce_topk_bf16_wide``
(shorter lists keep the first two): each split admits only rows that
score at most a bound the splits share (``_shared_bound``; ``_entry``
allocates it) and merges a tile's rows into its list at once.
``_launch_shape`` chooses each launch's query tile, corpus splits and
shared memory here, where the CPU tests reach it.

The exact route's short lists over float32 / bf16 rows take the Hopper
instances, ``bruteforce_topk_wgmma`` and ``bruteforce_topk_bf16_wgmma``
(3xTF32 on wgmma, a ring of tensor copies on mbarriers, two selector
warpgroups beside the products), by an explicit rule (``_wgmma_route``): L2 or
cosine, k_run < WIDE_MIN_K, D <= WGMMA_MAX_D, 16-byte rows and base, and
no page of a paged call, whose pages must all score on one path.  The
build's int8 pools take ``bruteforce_topk_q8_wgmma`` by the same rule at
k_run <= WIDE_MAX_K (bf16 wgmma with the query split in three bf16 parts,
the int8 chunks landed by tensor copies, the wide selection in selector
warpgroups; the scales 16-byte aligned too).  Every other launch keeps the
mma.sync instances; neither falls back on the other.

The compressed sweep's coarse pool (ops/pq_sweep) has its own kernel,
``bruteforce_topk_pq`` (``csrc/pq_topk.cu``): rows are PQ codes u8[N, G],
each element decoded in the block from the codebook rounded to bf16
(``pq_table``), scored on the bf16 tensor cores (Manhattan on the CUDA
cores), every row at or under a bound the splits share appended to a
candidate buffer, then each query's pool selected from it; ``pq_topk``
launches it (``_pq_launch_shape`` sizes it) and runs it again with a
larger buffer if one overflowed (``_filter_select``).

``bruteforce_topk`` is the wrapper: on a CPU tensor it runs
``_bruteforce_topk_plain`` (the same function in plain torch), on a CUDA
tensor it launches the instantiation for the corpus dtype or raises.  One
launch keeps at most MAX_K_RUN entries per query (its running lists live in
shared memory); ``bruteforce_topk_paged`` takes any k_run in pages of at
most MAX_K_RUN, each launch admitting only what follows the last entry of
the page before (``pq_topk`` / ``pq_topk_paged`` the same over PQ codes,
CUDA tensors only).  ``fused_exact_search`` is the entry with the contract of
``pallas_exact_search``: L2 fetches k + _RERANK_PAD and reranks with the
difference form; Manhattan on a CPU tensor goes to ops/bruteforce.  ``sweep_pool`` is the
build's candidate sweep (core/build._exact_candidates, the JAX package's
device loop there): one launch over rows [0, base) with no tombstone mask.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import Metric, resolve_metric
from .bruteforce import (_RERANK_PAD, _rerank_exact, as_corpus,
                         exact_search, sweep_min_k)
from .distance import _matmul, _sqrt, pairwise_dist

# Launches of each instantiation since import (or since a caller reset
# them); a run reads them to show that a path went through the kernel.
LAUNCHES = {"bruteforce_topk": 0, "bruteforce_topk_bf16": 0,
            "bruteforce_topk_wgmma": 0, "bruteforce_topk_bf16_wgmma": 0,
            "bruteforce_topk_q8": 0, "bruteforce_topk_q8_wgmma": 0,
            "bruteforce_topk_wide": 0,
            "bruteforce_topk_bf16_wide": 0, "bruteforce_topk_l1": 0,
            "bruteforce_topk_bf16_l1": 0, "bruteforce_topk_q8_l1": 0,
            "bruteforce_topk_pq": 0}

# Running lists live in shared memory: 8 bytes x k_run x 16 queries fit
# a block up to here; a longer list takes pages of at most this.
MAX_K_RUN = 1024
# The wide selection's lists live in registers (8 entries a lane) up to
# here, the build's pools (2 cand_cap = 256 at efc 64); longer ones keep
# the insertion into shared memory.
WIDE_MAX_K = 256
# Float32 / bf16 rows take the wide instances from here up (sweep_probe,
# 1M x 128-d: faster at k_run 64, 102 and 130, slower at 12 and 32).
WIDE_MIN_K = 64

# The sweep's launch shape, mirrored from csrc/bruteforce_topk.cu (whose
# launch refuses a shared-memory figure that differs from its own): 128-row
# corpus tiles streamed in 32-dim chunks through a 2-stage ring, padded row
# strides (corpus: 32 dims + 16 bytes; streamed query chunks: 36 floats;
# resident queries: D in whole chunks + 4 floats; scores: 136 floats), the
# query tile QT by tier of k_run, 8 bytes per list entry; int8 rows (1-byte
# elements) add each stage's 128 float32 scales; Manhattan over bf16 or
# int8 rows adds the [128 x 36] float32 chunk each landed stage is widened
# into.
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
MAX_SPLITS = 128
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 233_472, 1024     # H100
_TILE_N, _TILE_D, _STAGES = 128, 32, 2
_Q_STRIDE, _SCORE_STRIDE, _WIDE_STRIDE = 36, 136, 36
_MIN_ROWS_PER_SPLIT = 2048
_QT_TIERS = ((256, 64), (MAX_K_RUN, 16))               # (k_run <=, QT)

_PLAIN_CHUNK = 16384

# The Hopper instances' shape, mirrored from csrc/bruteforce_topk.cu
# (sweep_wgmma_kernel, wgmma_smem_bytes): a ring of dense [128 x 32] row
# chunks, as the tensor copies land them (3 stages of float32, 6 of
# bf16); 64 queries a block, split once into TF32 hi and lo tiles of D in
# whole 32-dim chunks; two [64 x 132] float32 score tiles; |q|^2; 128
# bytes of mbarriers; 8 bytes a list entry.  512 threads: one block an SM.
# The int8 instance (sweep_q8_wgmma_kernel, q8_wgmma_smem_bytes): 3 stages
# of an int8 [128 x 32] box and the tile's 128 float32 scales; the queries
# split into three bf16 tiles (hi, mid, lo); one score tile; the selector
# warps' staging, 64 words each.
WGMMA_MAX_D = 128
_WG_QT = 64
_WG_STAGES = {4: 3, 2: 6, 1: 3}
_WG_SCORE_STRIDE = _TILE_N + 4
_WG_SCORE_BUFS = 2
_WG_BAR_BYTES = 128
_WG_Q8_PARTS = 3
_WG_Q8_STAGE_WORDS, _WG_Q8_SELECTOR_WARPS = 64, 8

# the kernel instantiation for each corpus dtype, L2 and cosine
_KERNELS = {torch.float32: "bruteforce_topk",
            torch.bfloat16: "bruteforce_topk_bf16",
            torch.int8: "bruteforce_topk_q8"}
_WGMMA_KERNELS = {torch.float32: "bruteforce_topk_wgmma",
                  torch.bfloat16: "bruteforce_topk_bf16_wgmma",
                  torch.int8: "bruteforce_topk_q8_wgmma"}
_WIDE_KERNELS = {torch.float32: "bruteforce_topk_wide",
                 torch.bfloat16: "bruteforce_topk_bf16_wide"}
# Manhattan's, which run the wide selection at every k_run up to
# WIDE_MAX_K (as the int8 one does)
_L1_KERNELS = {torch.float32: "bruteforce_topk_l1",
               torch.bfloat16: "bruteforce_topk_bf16_l1",
               torch.int8: "bruteforce_topk_q8_l1"}


def _corpus_rows(points):
    """(rows, scales or None) of a corpus: a float32 / bf16 [N, D] tensor,
    or the int8 shadow (qvec i8[N, D], qscale f32[N])."""
    if isinstance(points, tuple):
        return points
    return points, None


def dequantize_rows(qvec, qscale) -> torch.Tensor:
    """The int8 shadow's rows as the sweep scores them, bf16[N, D]:
    ``qvec.bf16 * qscale.bf16``, the JAX package's dequantisation (each
    product rounded once to nearest even)."""
    return qvec.to(torch.bfloat16) * qscale.to(torch.bfloat16).unsqueeze(1)


def _scores(queries, rows, metric_value: int) -> torch.Tensor:
    """The kernel's score: squared L2 (before the sqrt) or cosine distance
    in matmul form, or Manhattan's sum (torch.cdist, as pairwise_dist),
    [B, n]; bf16 rows are upcast first."""
    rows = rows.to(torch.float32)
    if metric_value == Metric.MANHATTAN.value:
        return pairwise_dist(queries, rows, metric_value)
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
    L2 sqrt'd; ``points`` and ``after`` as in bruteforce_topk (the int8
    shadow's live rows are dequantised first)."""
    rows, scale = _corpus_rows(points)
    n = min(n_valid, len(rows))
    if scale is not None:
        rows = dequantize_rows(rows[:n], scale[:n])
    d, i = sweep_min_k(queries, rows, k_run, n, deleted,
                       lambda q, p: _scores(q, p, metric_value),
                       _PLAIN_CHUNK, after)
    if after is not None:
        after[0].copy_(d[:, -1])
        after[1].copy_(i[:, -1])
    if metric_value == Metric.L2.value:
        d = torch.sqrt(d)
    return d, i


def _smem_bytes(qt: int, k_run: int, itemsize: int, dims: int,
                q_resident: bool, manhattan: bool = False,
                wgmma: bool = False) -> int:
    """The C side's sweep_smem_bytes; ``itemsize`` 1 is the int8 instance,
    whose ring stages also hold the tile's scales; ``manhattan`` the kL1
    instances, which widen bf16 and int8 rows into a float32 chunk;
    ``wgmma`` the Hopper instances' wgmma_smem_bytes (QT 64, resident
    queries; itemsize 1: the int8 one's q8_wgmma_smem_bytes)."""
    if wgmma:
        chunks = -(-dims // _TILE_D)
        if itemsize == 1:
            return (_WG_STAGES[1] * (_TILE_N * _TILE_D + 4 * _TILE_N)
                    + _WG_Q8_PARTS * chunks * _TILE_D * _WG_QT * 2
                    + _WG_QT * _WG_SCORE_STRIDE * 4 + 4 * _WG_QT
                    + _WG_BAR_BYTES
                    + _WG_Q8_SELECTOR_WARPS * _WG_Q8_STAGE_WORDS * 4
                    + 8 * _WG_QT * k_run)
        return (2 * chunks * _TILE_D * _WG_QT * 4
                + _WG_STAGES[itemsize] * _TILE_N * _TILE_D * itemsize
                + _WG_SCORE_BUFS * _WG_QT * _WG_SCORE_STRIDE * 4 + 4 * _WG_QT
                + _WG_BAR_BYTES + 8 * _WG_QT * k_run)
    stage = _TILE_N * (_TILE_D * itemsize + 16)
    if itemsize == 1:
        stage += 4 * _TILE_N
    if q_resident:
        queries = qt * (_TILE_D * -(-dims // _TILE_D) + 4) * 4
    else:
        stage, queries = stage + qt * _Q_STRIDE * 4, 0
    widened = _TILE_N * _WIDE_STRIDE * 4 if manhattan and itemsize < 4 else 0
    return (_STAGES * stage + widened + queries
            + 4 * (qt * _SCORE_STRIDE + qt + _TILE_N) + 8 * qt * k_run)


def _blocks_per_sm(smem: int) -> int:
    return min(2, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


def _launch_shape(b: int, n_rows: int, k_run: int, sms: int,
                  itemsize: int = 4, dims: int = 128, qt: int | None = None,
                  manhattan: bool = False, wgmma: bool = False):
    """(QT, corpus splits S, resident queries, shared-memory bytes) of a
    sweep launch for ``b`` queries, ``n_rows`` rows of ``dims``
    ``itemsize``-byte elements (1: int8 rows and their scales) and
    ``k_run`` on a card with ``sms`` SMs (``manhattan``: a kL1 instance's
    shared memory; ``wgmma``: a Hopper instance's, QT = 64 with resident
    queries, one block an SM).

    QT is the largest query tile whose running lists fit beside the ring.
    The block keeps its [QT, D] queries in shared memory for its whole
    sweep, instead of streaming a query chunk beside every corpus chunk,
    when that fits and leaves as many blocks on an SM: it halves what a
    bf16 sweep reads through L2.  Two blocks share an SM where their shared
    memory allows (QT = 64 at small k_run), so one block's selection
    overlaps the other's mma's.  S fills the SMs' block slots as evenly as
    whole waves allow (the fewest splits on a tie), with no split under
    2048 rows.  ``qt`` forces the query tile (a probe's choice)."""
    if wgmma:
        qt, q_res = _WG_QT, True
        smem = _smem_bytes(qt, k_run, itemsize, dims, True, wgmma=True)
        slots = sms
    else:
        if qt is None:
            qt = next(t for k_max, t in _QT_TIERS if k_run <= k_max)
        streamed = _smem_bytes(qt, k_run, itemsize, dims, False, manhattan)
        resident = _smem_bytes(qt, k_run, itemsize, dims, True, manhattan)
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


def _wgmma_route(dtype, metric_value: int, k_run: int, dims: int,
                 aligned: bool, page: bool) -> bool:
    """Whether a launch takes a Hopper instance: float32 or bf16 rows at
    k_run < WIDE_MIN_K (the exact route's QT = 64 tier, not the wide one),
    or int8 rows at k_run <= WIDE_MAX_K (the build's pools, the wide
    selection's lists); L2 or cosine, D <= WGMMA_MAX_D (the query tiles,
    ring, score tiles and lists fit a block), ``aligned`` (16-byte rows
    and base, and for int8 rows the scales' base: the copy engine's tensor
    copies) and not ``page`` (a page of a paged call: every page of one
    call scores on one path, or the pages would not concatenate).  A rule,
    not a fallback: what it leaves out takes the mma.sync instances."""
    k_max = WIDE_MAX_K if dtype == torch.int8 else WIDE_MIN_K - 1
    return (dtype in _WGMMA_KERNELS
            and metric_value in (Metric.L2.value, Metric.COSINE.value)
            and 1 <= k_run <= k_max and 1 <= dims <= WGMMA_MAX_D
            and aligned and not page)


def launch_instance(queries, points, k_run: int, metric_value: int,
                    page: bool = False):
    """The C entry a launch of ``bruteforce_topk`` over ``points`` (a
    corpus as bruteforce_topk takes it) at ``k_run`` takes, and whether
    it is a Hopper instance (``page``: a page of a paged call)."""
    rows, scale = _corpus_rows(points)
    # 16-byte rows and a 16-byte aligned base (and scales): the tensor
    # copies' need
    aligned = (rows.data_ptr() % 16 == 0
               and rows.shape[-1] * rows.element_size() % 16 == 0
               and (scale is None or scale.data_ptr() % 16 == 0))
    wgmma = _wgmma_route(rows.dtype, metric_value, k_run, queries.shape[1],
                         aligned, page)
    return _instance(rows.dtype, k_run,
                     manhattan=metric_value == Metric.MANHATTAN.value,
                     wgmma=wgmma)[0], wgmma


def _instance(dtype, k_run: int, wide: bool | None = None,
              manhattan: bool = False, wgmma: bool = False):
    """(the C entry of a launch, whether it takes the shared bound).  The
    int8 and the Manhattan instances run the wide selection up to
    WIDE_MAX_K with a bound, the insertion into shared memory past it;
    float32 / bf16 rows under L2 and cosine take the wide instances from
    WIDE_MIN_K to WIDE_MAX_K, else the exact route's; ``wide`` forces
    their choice (a probe's); ``wgmma`` (``_wgmma_route``'s answer) the
    Hopper instances (the int8 one with the bound)."""
    if wgmma:
        return _WGMMA_KERNELS[dtype], dtype == torch.int8
    if manhattan:
        return _L1_KERNELS[dtype], k_run <= WIDE_MAX_K
    if dtype == torch.int8:
        return _KERNELS[dtype], k_run <= WIDE_MAX_K
    if wide is None:
        wide = WIDE_MIN_K <= k_run <= WIDE_MAX_K
    if wide:
        return _WIDE_KERNELS[dtype], True
    return _KERNELS[dtype], False


def _shared_bound(b: int, splits: int, k_run: int):
    """The bound a wide launch's splits share: (its scratch's shape, the
    rank j whose score each split publishes).  The scratch is f32[B, S] of
    +inf (a query's S slots side by side, read in one line); j =
    ceil(k_run / S), the least with S j >= k_run, so the S published j-th
    scores name at least k_run rows."""
    return (b, splits), -(-k_run // splits)


def _entry(dtype, k_run: int, b: int, splits: int, device,
           wide: bool | None = None, manhattan: bool = False,
           wgmma: bool = False):
    """A launch's C entry (``_instance``), its shared bound's scratch
    (f32[B, S] of +inf, or None) and the arguments the entry takes for the
    bound before the stream: (scratch, rank j); (None, 0) for the int8 and
    Manhattan entries past WIDE_MAX_K; none for the exact route's and the
    float32 / bf16 Hopper instances."""
    name, shared = _instance(dtype, k_run, wide, manhattan, wgmma)
    if shared:
        shape, rank = _shared_bound(b, splits, k_run)
        scratch = torch.full(shape, float("inf"), device=device)
        return name, scratch, (scratch.data_ptr(), rank)
    every_tile = manhattan or dtype == torch.int8
    return name, None, (None, 0) if every_tile else ()


def _check_scope(k_run, metric_value) -> None:
    """k_run within one launch; L2, cosine or Manhattan."""
    ok = (Metric.L2.value, Metric.COSINE.value, Metric.MANHATTAN.value)
    if metric_value not in ok:
        raise ValueError(f"the fused kernel takes L2, cosine or Manhattan, "
                         f"not metric {metric_value}")
    if not 1 <= k_run <= MAX_K_RUN:
        raise ValueError(f"k_run={k_run} outside [1, {MAX_K_RUN}]")


def _check_mask_and_floor(queries, rows, deleted, after) -> None:
    """``deleted`` a contiguous bool[N] of ``rows``' length, ``after`` the
    contiguous (f32[B], i32[B]) floor, both on ``rows``' device."""
    if deleted is not None:
        if (deleted.dtype != torch.bool or deleted.shape != rows.shape[:1]
                or deleted.device != rows.device
                or not deleted.is_contiguous()):
            raise ValueError("deleted must be a contiguous bool[N] tensor "
                             "on the rows' device")
    if after is not None:
        fd, fi = after
        for t, dt in ((fd, torch.float32), (fi, torch.int32)):
            if (t.dtype != dt or t.shape != queries.shape[:1]
                    or t.device != rows.device or not t.is_contiguous()):
                raise ValueError("after must be contiguous (f32[B], i32[B]) "
                                 "tensors on the rows' device")


def _check_args(queries, points, k_run, metric_value, deleted,
                after) -> None:
    _check_scope(k_run, metric_value)
    if isinstance(points, tuple):
        if len(points) != 2:
            raise ValueError("the int8 shadow is a (qvec, qscale) pair")
        points, scale = points
        if points.dtype != torch.int8:
            raise ValueError(f"qvec must be int8, got {points.dtype}")
        if (scale.dtype != torch.float32 or scale.dim() != 1
                or scale.shape[0] != points.shape[0]):
            raise ValueError(f"qscale must be float32[{points.shape[0]}], "
                             f"got {scale.dtype}{list(scale.shape)}")
        tensors = (("queries", queries), ("qvec", points), ("qscale", scale))
    else:
        if points.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"points must be float32 or bfloat16, got "
                             f"{points.dtype}")
        tensors = (("queries", queries), ("points", points))
    if queries.dim() != 2 or points.dim() != 2 or (
            queries.shape[1] != points.shape[1]):
        raise ValueError(f"shapes {tuple(queries.shape)} and "
                         f"{tuple(points.shape)} are not [B, D] and [N, D]")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    for name, t in tensors:
        if t.device != points.device:
            raise ValueError(f"{name} on {t.device}, points on "
                             f"{points.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_mask_and_floor(queries, points, deleted, after)


def bruteforce_topk(queries, points, k_run: int, metric_value: int,
                    n_valid: int, deleted=None, after=None):
    """Exact top-k_run (k_run <= MAX_K_RUN) of queries f32[B, D] against
    points f32 or bf16 [N, D], or the int8 shadow (qvec i8[N, D], qscale
    f32[N]: rows ``dequantize_rows(qvec, qscale)``), rows [0, n_valid),
    skipping ``deleted`` rows.  Returns (d f32[B, k_run], ids i32[B,
    k_run]), ascending by (score, id), -1/+inf padded, L2 sqrt'd.

    ``after`` (floor_d f32[B], floor_i i32[B]), a page floor: only rows
    that follow (floor_d[q], floor_i[q]) in (score, id) order are admitted
    (scores before the L2 sqrt; id -1 follows every row), and the call
    overwrites it with each query's last entry, the next page's floor."""
    _check_args(queries, points, k_run, metric_value, deleted, after)
    rows, scale = _corpus_rows(points)
    if rows.device.type == "cpu":
        return _bruteforce_topk_plain(queries, points, k_run, metric_value,
                                      n_valid, deleted, after)
    if rows.device.type != "cuda":
        raise ValueError(f"no kernel for device {rows.device}")
    row_ptrs = (rows.data_ptr(),) + (() if scale is None
                                     else (scale.data_ptr(),))
    wgmma = launch_instance(queries, points, k_run, metric_value,
                            after is not None)[1]
    return _launch(queries, rows.dtype, row_ptrs, rows.element_size(),
                   n_valid, rows.shape[0], k_run, metric_value, deleted,
                   after, wgmma)


def _launch(queries, dtype, row_ptrs, itemsize: int, n_valid,
            n_stored: int, k_run: int, metric_value: int, deleted, after,
            wgmma: bool = False):
    """One launch of the instance for ``dtype`` and the metric (its C
    entry takes the queries, ``row_ptrs``, the mask, B, the row count, D,
    then the launch shape, the lists, the floor and the bound; ``wgmma``:
    the Hopper instance, _wgmma_route's answer), counted in LAUNCHES;
    raises on a CUDA error."""
    b, dims = queries.shape
    n_rows = max(0, min(int(n_valid), n_stored))
    dev = queries.device
    out_d = torch.empty((b, k_run), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_run), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = _kernels.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    manhattan = metric_value == Metric.MANHATTAN.value
    qt, splits, q_res, smem = _launch_shape(b, n_rows, k_run, sms, itemsize,
                                            dims, manhattan=manhattan,
                                            wgmma=wgmma)
    with torch.cuda.device(dev):
        part_d = torch.empty((splits, b, k_run), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((splits, b, k_run), dtype=torch.int32,
                             device=dev)
        # the scratch is held until the launch is queued
        name, scratch, bound = _entry(dtype, k_run, b, splits, dev,
                                      manhattan=manhattan, wgmma=wgmma)
        err = getattr(lib, name)(
            queries.data_ptr(), *row_ptrs,
            None if deleted is None else deleted.data_ptr(),
            b, n_rows, dims, k_run, metric_value, qt, splits,
            int(q_res), smem, part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            None if after is None else after[0].data_ptr(),
            None if after is None else after[1].data_ptr(), *bound,
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def _paged(topk, queries, k_run: int):
    """``topk(k, after)`` for any k_run >= 1: one call up to MAX_K_RUN,
    else equal pages of at most MAX_K_RUN, each a call whose floor is the
    last entry of the page before.  A score depends on its query and row
    alone, so the pages concatenate to the single ascending list."""
    if k_run <= MAX_K_RUN:
        return topk(k_run, None)
    b, dev = queries.shape[0], queries.device
    size = -(-k_run // -(-k_run // MAX_K_RUN))
    after = (torch.full((b,), -float("inf"), dtype=torch.float32,
                        device=dev),
             torch.full((b,), -1, dtype=torch.int32, device=dev))
    pages = [topk(min(size, k_run - start), after)
             for start in range(0, k_run, size)]
    return (torch.cat([d for d, _ in pages], dim=1),
            torch.cat([i for _, i in pages], dim=1))


def bruteforce_topk_paged(queries, points, k_run: int, metric_value: int,
                          n_valid: int, deleted=None):
    """bruteforce_topk for any k_run >= 1, in pages past MAX_K_RUN
    (_paged)."""
    return _paged(lambda k, after: bruteforce_topk(
        queries, points, k, metric_value, n_valid, deleted, after),
        queries, k_run)


# The PQ kernel's shape, mirrored from csrc/pq_topk.cu: 128 queries a
# block, 128-row tiles in 64-dim steps through a 2-stage ring (each stage
# a row's code window in 80 bytes, 64 dim offsets, the table chunk of 256
# codes x 32 bf16 pairs, the [128 x 72] float32 query chunk), the decoded
# [128 x 36] word tile, a 32-score bound list a query and 32 staged
# scores, nine words a query and two a row: one block an SM, whatever
# the pool.
PQ_QT = 128
PQ_STEP_D = 64
PQ_LIST = 32
_PQ_CODES = 256
PQ_SMEM = (_STAGES * (_TILE_N * 80 + PQ_STEP_D + _PQ_CODES * PQ_STEP_D * 2
                      + PQ_QT * (PQ_STEP_D + 8) * 4)
           + _TILE_N * (PQ_STEP_D // 2 + 4) * 4 + 2 * PQ_QT * PQ_LIST * 4
           + 9 * PQ_QT * 4 + 2 * _TILE_N * 4)
# a (query, split) segment's entries: this many at least, twice the pool
# past half of it
_PQ_CAP_MIN = 512
# bytes of segments a rerun of overflowed queries takes at once
_PQ_RERUN_BYTES = 1 << 28


def pq_table(codebook) -> torch.Tensor:
    """The PQ kernel's codebook in bf16 pairs by 64-dim chunk,
    bf16[ceil(D / 64), 256, 32, 2]: entry (c, code, p) holds dims 64 c + 2
    p and 64 c + 2 p + 1 (0 past D) of ``code``'s decoded row,
    bf16(codebook[d // sub, code, d % sub]) (each value rounded once to
    nearest even, as ``pq_decode(...).to(bfloat16)`` rounds it), from
    codebook f32[G, 256, sub].  The kernel stages a chunk and reads an
    entry as one 32-bit word, pair p from lane p: bank p, whatever the
    codes."""
    groups, codes, sub = codebook.shape
    dims = groups * sub
    chunks = -(-dims // PQ_STEP_D)
    rows = codebook.to(torch.bfloat16).permute(0, 2, 1).reshape(dims, codes)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, chunks * PQ_STEP_D - dims))
    return (rows.view(chunks, PQ_STEP_D // 2, 2, codes).permute(0, 3, 1, 2)
            .contiguous())


def _pq_rank(splits: int, k_run: int) -> int:
    """The shared bound's rank j for S = ``splits``: each split publishes
    its list's j-th, and the bound takes the P = ceil(k_run / j)-th least
    of the F = min(S, 32) lanes' folds; j is the least, up to PQ_LIST,
    with P <= ceil(F / 2), so that half the folds give a bound; 0 (no
    bound) where F PQ_LIST < k_run."""
    folds = min(splits, PQ_LIST)
    rank = min(PQ_LIST, -(-k_run // -(-folds // 2)))
    return rank if -(-k_run // rank) <= folds else 0


def _pq_launch_shape(b: int, n_rows: int, k_run: int, sms: int):
    """(splits S, the shared bound's rank j (0: none), segment entries,
    rows a split) of a PQ call for ``b`` queries, ``n_rows`` rows and
    ``k_run`` on a card with ``sms`` SMs (one block an SM).  S fills the
    SMs as evenly as whole waves allow (the fewest splits on a tie), with
    no split under 2048 rows and, where the rows allow, S PQ_LIST >= k_run
    (j: _pq_rank).  A segment holds max(_PQ_CAP_MIN, 2 k_run) entries,
    or, with no bound to filter, every row of its split."""
    q_tiles = -(-b // PQ_QT)
    top = max(1, min(MAX_SPLITS, -(-n_rows // _MIN_ROWS_PER_SPLIT)))
    low = min(top, -(-k_run // PQ_LIST))

    def fill(s):
        blocks = q_tiles * s
        return blocks / (-(-blocks // sms) * sms)
    splits = max(range(low, top + 1), key=lambda s: (fill(s), -s))
    per = _TILE_N * -(-(-(-n_rows // splits)) // _TILE_N)
    rank = _pq_rank(splits, k_run)
    if not rank:
        return splits, 0, max(1, per), per
    return splits, rank, max(1, min(per, max(_PQ_CAP_MIN, 2 * k_run))), per


def _filter_select(launch, cap: int, rows_per_split: int, splits: int):
    """The pool of ``launch(rows, entries)`` (one sweep and select over the
    queries ``rows``, all when None, with segments of ``entries``; returns
    (d, ids, counts i32[B, S], next floor or None)).  A segment that
    overflowed (a count past ``cap``, possible only when cap <
    rows_per_split) lost rows: its query runs again with segments of
    rows_per_split, which no split can overflow, _PQ_RERUN_BYTES of
    segments a launch at most.  Returns (d, ids, floor)."""
    d, i, counts, floor = launch(None, cap)
    if cap >= rows_per_split:
        return d, i, floor
    over = torch.nonzero((counts > cap).any(dim=1)).flatten()    # a sync
    full = max(1, rows_per_split)
    step = max(1, _PQ_RERUN_BYTES // (8 * splits * full))
    for rows in over.split(step) if len(over) else ():
        d[rows], i[rows], _, again = launch(rows, full)
        if floor is not None:
            floor[0][rows], floor[1][rows] = again
    return d, i, floor


def _pq_bound_plain(slots, k_run: int, rank: int):
    """The PQ kernel's bound from slots f32[B, S] (each a list's j-th, j =
    ``rank``; +inf unpublished): lane l folds slots l, l + 32, ... into
    their largest (+inf for a lane with none), and the bound is the
    ceil(k_run / j)-th least of the 32 folds.  Returns f32[B]."""
    b, s = slots.shape
    width = PQ_LIST * -(-s // PQ_LIST)
    folds = torch.nn.functional.pad(slots, (0, width - s),
                                    value=-float("inf"))
    folds = folds.view(b, -1, PQ_LIST).amax(dim=1)
    if s < PQ_LIST:
        folds[:, s:] = float("inf")
    return torch.sort(folds, dim=1).values[:, -(-k_run // rank) - 1]


def _pq_select_plain(buf, counts, cap: int, bound, rank: int, k_run: int,
                     metric_value: int):
    """The select launch of ``bruteforce_topk_pq`` in torch: each query's
    rows in its S segments (buf i32[B, S, cap, 2]: the score's bits and
    the id, the first min(count, cap) of each, counts i32[B, S]) that score
    at most the bound its slots give (``bound`` f32[B, S] at ``rank``,
    _pq_bound_plain; every row when None), the k_run least by (score,
    id).  Returns (d f32[B, k_run],
    ids i32[B, k_run], next floor (f32[B], i32[B])): ascending, +inf / -1
    padded, L2 sqrt'd; the floor is the last entry, its score before the
    sqrt."""
    b = buf.shape[0]
    scores = buf[..., 0].contiguous().view(torch.float32)
    ids = buf[..., 1]
    live = (torch.arange(cap, device=buf.device)
            < counts.clamp(max=cap).unsqueeze(-1))
    if bound is not None:
        live &= scores <= _pq_bound_plain(bound, k_run, rank).view(b, 1, 1)
    scores = torch.where(live, scores, float("inf")).reshape(b, -1)
    ids = torch.where(live, ids, -1).reshape(b, -1)
    width = max(k_run, ids.shape[1])
    scores = torch.nn.functional.pad(scores, (0, width - scores.shape[1]),
                                     value=float("inf"))
    ids = torch.nn.functional.pad(ids, (0, width - ids.shape[1]), value=-1)
    # (score, id) order: a stable sort by score of the rows sorted by id
    # (-1, an empty slot, last)
    order = torch.sort(torch.where(ids < 0, torch.iinfo(torch.int32).max,
                                   ids), dim=1, stable=True).indices
    scores, ids = scores.gather(1, order), ids.gather(1, order)
    order = torch.sort(scores, dim=1, stable=True).indices[:, :k_run]
    d, i = scores.gather(1, order), ids.gather(1, order)
    floor = (d[:, -1].clone(), i[:, -1].clone())
    if metric_value == Metric.L2.value:
        d = _sqrt(d)
    return d, i, floor


def _check_pq_args(queries, codes, table, k_run, metric_value, deleted,
                   after) -> None:
    _check_scope(k_run, metric_value)
    if queries.dtype != torch.float32 or queries.dim() != 2:
        raise ValueError(f"queries must be float32 [B, D], got "
                         f"{queries.dtype}{list(queries.shape)}")
    dims = queries.shape[1]
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be uint8 [N, G], got "
                         f"{codes.dtype}{list(codes.shape)}")
    groups = codes.shape[1]
    if not 1 <= groups <= dims or dims % groups:
        raise ValueError(f"{groups} code groups do not divide D = {dims}")
    shape = (-(-dims // PQ_STEP_D), _PQ_CODES, PQ_STEP_D // 2, 2)
    if (table.dtype != torch.bfloat16 or tuple(table.shape) != shape
            or table.data_ptr() % 16):
        raise ValueError(f"table must be a 16-byte aligned bfloat16"
                         f"{list(shape)}, got {table.dtype}"
                         f"{list(table.shape)}")
    for name, t in (("queries", queries), ("codes", codes),
                    ("table", table)):
        if t.device != codes.device:
            raise ValueError(f"{name} on {t.device}, codes on "
                             f"{codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_mask_and_floor(queries, codes, deleted, after)


def pq_topk(queries, codes, table, k_run: int, metric_value: int,
            n_valid: int, deleted=None, after=None):
    """The compressed sweep's coarse top-k_run (k_run <= MAX_K_RUN) in a
    call of ``bruteforce_topk_pq`` (the sweep and the select): queries
    f32[B, D] (already rotated under OPQ) against the rows whose PQ codes
    are ``codes`` u8[N, G], each row decoded in the kernel through
    ``table`` (pq_table of the codebook), rows [0, n_valid), skipping
    ``deleted`` rows.  Returns (d f32[B, k_run], ids i32[B, k_run])
    ascending by (score, id), -1/+inf padded, L2 sqrt'd; ``after`` as in
    bruteforce_topk.  A query whose candidate segments overflowed runs
    again (_filter_select), a second counted launch.  CUDA tensors only:
    the CPU's route is ops/pq_sweep._pq_pool_plain."""
    _check_pq_args(queries, codes, table, k_run, metric_value, deleted,
                   after)
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {codes.device}")
    b, dims = queries.shape
    dev = queries.device
    if b == 0:
        return (torch.empty((0, k_run), dtype=torch.float32, device=dev),
                torch.empty((0, k_run), dtype=torch.int32, device=dev))
    n_rows = max(0, min(int(n_valid), codes.shape[0]))
    lib = _kernels.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rank, cap, per = _pq_launch_shape(b, n_rows, k_run, sms)

    def launch(rows, entries):
        q, floor = queries, after
        if rows is not None:
            q = queries[rows].contiguous()
            if after is not None:
                floor = (after[0][rows].contiguous(),
                         after[1][rows].contiguous())
        nb = q.shape[0]
        out_d = torch.empty((nb, k_run), dtype=torch.float32, device=dev)
        out_i = torch.empty((nb, k_run), dtype=torch.int32, device=dev)
        counts = torch.empty((nb, splits), dtype=torch.int32, device=dev)
        buf = torch.empty((nb, splits, entries, 2), dtype=torch.int32,
                          device=dev)
        bound = (torch.full((nb, splits), float("inf"), device=dev)
                 if rank else None)
        nxt = None if after is None else (
            torch.empty(nb, dtype=torch.float32, device=dev),
            torch.empty(nb, dtype=torch.int32, device=dev))
        err = lib.bruteforce_topk_pq(
            q.data_ptr(), codes.data_ptr(), table.data_ptr(),
            None if deleted is None else deleted.data_ptr(), nb, n_rows,
            dims, codes.shape[1], k_run, metric_value, splits, PQ_SMEM,
            buf.data_ptr(), entries, counts.data_ptr(),
            None if bound is None else bound.data_ptr(), rank,
            out_d.data_ptr(), out_i.data_ptr(),
            *((None, None) if floor is None else
              (floor[0].data_ptr(), floor[1].data_ptr())),
            *((None, None) if nxt is None else
              (nxt[0].data_ptr(), nxt[1].data_ptr())),
            torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(lib, err, "bruteforce_topk_pq")
        LAUNCHES["bruteforce_topk_pq"] += 1
        return out_d, out_i, counts, nxt

    with torch.cuda.device(dev):
        d, i, nxt = _filter_select(launch, cap, per, splits)
    if after is not None:
        after[0].copy_(nxt[0])
        after[1].copy_(nxt[1])
    return d, i


def pq_topk_paged(queries, codes, table, k_run: int, metric_value: int,
                  n_valid: int, deleted=None):
    """pq_topk for any k_run >= 1, in pages past MAX_K_RUN (_paged)."""
    return _paged(lambda k, after: pq_topk(
        queries, codes, table, k, metric_value, n_valid, deleted, after),
        queries, k_run)


def sweep_pool(points, rows, keep: int, metric_value: int, base: int):
    """The build's candidate pool (core/build._exact_candidates before its
    exact rerank): the ``keep`` nearest of rows [0, base) to each insert
    point of ``points`` f32[B, D] by the kernel's score, with no tombstone
    mask (deletes filter results, not waypoints, hnswalg.cpp:245).
    ``rows``: the corpus, f32 or bf16 [cap, D] ("exact"), or the int8
    shadow (qvec, qscale) ("exact8").  One launch on CUDA tensors (pages
    past MAX_K_RUN), the plain twin on CPU ones; ``base`` 0 gives the empty
    pool with none.  Returns (d f32[B, keep], ids i32[B, keep]) ascending
    by (score, id), -1/+inf padded, L2 sqrt'd."""
    if base <= 0:
        b, dev = points.shape[0], points.device
        return (torch.full((b, keep), float("inf"), device=dev),
                torch.full((b, keep), -1, dtype=torch.int32, device=dev))
    return bruteforce_topk_paged(points, rows, keep, metric_value, base)


def fused_exact_search(queries, points, k: int, metric=Metric.L2,
                       n_valid=None, deleted=None):
    """Exact top-k — the counterpart of ``pallas_exact_search``, with the
    contract of ops.bruteforce.exact_search.

    Every metric runs the fused kernel, in pages when k_run (k +
    _RERANK_PAD for L2, else k) exceeds MAX_K_RUN: L2 / cosine its plain
    twin on CPU tensors, Manhattan (the CUDA cores' sum, already the
    elementwise form: no rerank) ops.bruteforce.exact_search on them.  For
    L2 the kernel fetches k + _RERANK_PAD and the difference form reranks
    them.  ``points`` may be float32 or bfloat16 (a bf16-storage corpus).
    Returns (dists f32[B, k] ascending, ids i32[B, k]; -1 => none)."""
    metric = resolve_metric(metric)
    k = int(k)
    k_run = k + _RERANK_PAD if metric is Metric.L2 else k
    points = as_corpus(points)
    if metric is Metric.MANHATTAN and points.device.type == "cpu":
        return exact_search(queries, points, k, metric, n_valid=n_valid,
                            deleted=deleted)
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
