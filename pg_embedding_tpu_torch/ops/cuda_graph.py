"""The graph walk and the prune scan: hand-written CUDA kernels and their
plain twins.

The JAX package compiles two loops into device programs: the beam walk
(``core/search.py::_search_one``, a ``lax.while_loop`` vmapped over the
batch) and the diversity prune's keep/reject scan
(``core/build.py::_prune_heuristic``, a ``lax.fori_loop``).  Run as torch
ops, each step of either is a handful of small launches driven from the
host.  Here each loop is one launch:

  * ``beam_walk`` (``csrc/beam_walk.cu``): the whole walk of a query batch,
    one thread block per query.  Its plain twin is core/search's
    ``_search_batch``; it takes the dense dedupe over float32 rows or
    float32 packed records, any metric and T, and ef and cand_cap up to
    MAX_WALK_QUEUE (core/search.walk_route decides which walks come here).
  * ``prune_scan`` (``csrc/prune_scan.cu``): the scan of a batch of sorted
    candidate sets, one warp per set and one round per kept neighbour,
    reading the pairwise distances through the sort order.  Its plain
    twin is core/build's ``_prune_scan_plain``.

Each wrapper runs the plain twin on a CPU tensor and launches its kernel on
a CUDA tensor or raises.  The sources' notes say what bounds each kernel on
the card and what the design does about it.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import Metric
from .distance import dist_one_to_many

# Launches of each kernel since import (or since a caller reset them); a run
# reads them to show that a path went through the kernel.
LAUNCHES = {"beam_walk": 0, "prune_scan": 0}
# prune_scan's launches by candidate-set shape (C, nn), counted beside
# LAUNCHES["prune_scan"]
PRUNE_SHAPES: dict = {}

# Widest result and candidate queue the walk kernel takes: the API widens
# ef up to max_widen_ef = 4096.
MAX_WALK_QUEUE = 4096
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
_METRICS = (Metric.L2.value, Metric.COSINE.value, Metric.MANHATTAN.value)


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _walk_layout(ef: int, cand_cap: int, t: int, max_m: int,
                 dims: int) -> tuple:
    """Shared memory of one walk block, as csrc/beam_walk.cu lays it out:
    (bytes, held-table slots, slot-table slots).  The query row (D rounded
    up to 4 floats), the result and candidate queues twice over (d, id),
    24 bytes per expansion slot (its id, the compacted processed slots, the
    admitted (d, slot) and their ranked (d, id)) and 8 counters; then the
    dedupe's hash tables: the held ids (4 bytes a slot, a power of two of
    at least 2 (ef + cand_cap) slots) and the expansion's ids with their
    smallest slot (8 bytes a slot, at least 2 T maxM).  Where the tables do
    not fit, the kernel dedupes by comparison and they take 0.  Raises
    ValueError past SMEM_LIMIT."""
    tm = t * max_m
    base = 4 * (-(-dims // 4) * 4) + 16 * (ef + cand_cap) + 24 * tm + 32
    held, slots = _pow2_at_least(2 * (ef + cand_cap)), _pow2_at_least(2 * tm)
    tables = 4 * held + 8 * slots
    if base + tables <= SMEM_LIMIT:
        return base + tables, held, slots
    if base > SMEM_LIMIT:
        raise ValueError(
            f"the walk needs {base} bytes of shared memory a block "
            f"(ef={ef}, cand_cap={cand_cap}, T={t}, maxM={max_m}, D={dims});"
            f" the limit is {SMEM_LIMIT}")
    return base, 0, 0


def _walk_smem_bytes(ef: int, cand_cap: int, t: int, max_m: int,
                     dims: int) -> int:
    """The bytes of _walk_layout: what the launch passes and the C side
    checks."""
    return _walk_layout(ef, cand_cap, t, max_m, dims)[0]


def _check_walk_args(graph, queries, records, ef, cand_cap, t,
                     metric_value) -> None:
    if metric_value not in _METRICS:
        raise ValueError(f"unknown metric {metric_value}")
    if not (1 <= ef <= MAX_WALK_QUEUE and 1 <= cand_cap <= MAX_WALK_QUEUE):
        raise ValueError(f"ef={ef}, cand_cap={cand_cap} outside "
                         f"[1, {MAX_WALK_QUEUE}]")
    if not 1 <= t <= cand_cap:
        raise ValueError(f"expand_width={t} outside [1, cand_cap={cand_cap}]")
    cap, dims = graph.vectors.shape
    if queries.dim() != 2 or queries.shape[1] != dims:
        raise ValueError(f"queries {tuple(queries.shape)} are not [B, {dims}]")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    rows = graph.vectors if records is None else records
    if rows.dtype != torch.float32:
        raise ValueError(f"the walk kernel reads float32 rows or records, "
                         f"not {rows.dtype}")
    if records is not None and records.shape != (cap, graph.max_m, dims):
        raise ValueError(f"records {tuple(records.shape)} are not "
                         f"[{cap}, {graph.max_m}, {dims}]")
    for name, x, dt in (("links", graph.links, torch.int32),
                        ("link_counts", graph.link_counts, torch.int32),
                        ("rows", rows, torch.float32)):
        if x.dtype != dt or x.device != queries.device:
            raise ValueError(f"{name} must be {dt} on {queries.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def beam_walk(graph, queries: torch.Tensor, *, ef: int, metric_value: int,
              cand_cap: int, expand_width: int = 1, records=None):
    """searchBaseLayer for a batch of queries f32[B, D] over ``graph``
    with the dense dedupe; neighbour rows from ``graph.vectors`` (float32)
    or from float32 packed records f32[cap, maxM, D].  Returns (res_d
    f32[B, ef], res_i i32[B, ef], hops i32[B], dist_evals i32[B]), results
    ascending, -1/inf padded: what core/search._search_batch returns.

    The entry distance (to node 0) is the twin's own torch op, so both
    walks start from the same bits (and the records, which hold no row of
    the entry, need none)."""
    if queries.device.type == "cpu":
        from ..core.search import _search_batch
        return _search_batch(graph, queries, ef=ef, metric_value=metric_value,
                             cand_cap=cand_cap, expand_width=expand_width,
                             pcodes=records)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    t = int(expand_width)
    _check_walk_args(graph, queries, records, ef, cand_cap, t, metric_value)
    out = _launch_walk(_kernels.load_library(), graph, queries.contiguous(),
                       records, ef=ef, cand_cap=cand_cap, t=t,
                       metric_value=metric_value,
                       smem=_walk_smem_bytes(ef, cand_cap, t, graph.max_m,
                                             queries.shape[1]))
    LAUNCHES["beam_walk"] += int(queries.shape[0] > 0)   # b = 0: no launch
    return out


def _launch_walk(lib, graph, queries, records, *, ef, cand_cap, t,
                 metric_value, smem):
    """One launch of ``lib``'s beam_walk on checked arguments (the
    wrapper's library, or a probe's build of the same source)."""
    b, dims = queries.shape
    dev = queries.device
    out_d = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    hops = torch.empty(b, dtype=torch.int32, device=dev)
    evals = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i, hops, evals
    has_nodes = graph.n_nodes > 0
    if has_nodes:
        entry = dist_one_to_many(queries, graph.vectors[:1].expand(b, 1, dims),
                                 metric_value)[:, 0].contiguous()
    else:
        entry = out_d[:, 0]                 # never read
    rows = graph.vectors if records is None else records
    with torch.cuda.device(dev):
        err = lib.beam_walk(
            graph.links.data_ptr(), graph.link_counts.data_ptr(),
            rows.data_ptr(), queries.data_ptr(), entry.data_ptr(),
            int(records is not None), int(has_nodes), b, dims, graph.max_m,
            t, ef, cand_cap, metric_value, smem, out_d.data_ptr(),
            out_i.data_ptr(), hops.data_ptr(), evals.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, "beam_walk")
    return out_d, out_i, hops, evals


def prune_scan(d_s: torch.Tensor, valid_s: torch.Tensor, order: torch.Tensor,
               pair_d: torch.Tensor, do_prune: torch.Tensor, nn: int):
    """The diversity prune's scan over candidate sets sorted nearest-first:
    d_s f32[B, C], valid_s bool[B, C], order i64[B, C] (the sort's
    permutation), pair_d f32[B, C, C] in the original candidate order,
    do_prune bool[B].  Returns (kept_mask bool[B, C], kept_count i32[B])."""
    if d_s.device.type == "cpu":
        from ..core.build import _prune_scan_plain
        return _prune_scan_plain(d_s, valid_s, order, pair_d, do_prune, nn)
    if d_s.device.type != "cuda":
        raise ValueError(f"no kernel for device {d_s.device}")
    b, c = d_s.shape
    for name, x, dt, shape in (("d_s", d_s, torch.float32, (b, c)),
                               ("valid_s", valid_s, torch.bool, (b, c)),
                               ("order", order, torch.int64, (b, c)),
                               ("pair_d", pair_d, torch.float32, (b, c, c)),
                               ("do_prune", do_prune, torch.bool, (b,))):
        if (x.dtype != dt or tuple(x.shape) != shape
                or x.device != d_s.device):
            raise ValueError(f"{name} must be {dt}{list(shape)} on "
                             f"{d_s.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nn < 1:
        raise ValueError(f"nn={nn} < 1")
    out = _launch_prune(_kernels.load_library(), d_s, valid_s, order, pair_d,
                        do_prune, int(nn))
    if d_s.numel() > 0:                                  # empty: no launch
        LAUNCHES["prune_scan"] += 1
        PRUNE_SHAPES[c, int(nn)] = PRUNE_SHAPES.get((c, int(nn)), 0) + 1
    return out


def _launch_prune(lib, d_s, valid_s, order, pair_d, do_prune, nn):
    """One launch of ``lib``'s prune_scan on checked arguments (the
    wrapper's library, or a probe's build of the same source)."""
    b, c = d_s.shape
    dev = d_s.device
    kept_mask = torch.empty((b, c), dtype=torch.bool, device=dev)
    kept_count = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0 or c == 0:
        return kept_mask.fill_(False), kept_count.fill_(0)
    with torch.cuda.device(dev):
        err = lib.prune_scan(
            d_s.data_ptr(), valid_s.data_ptr(), order.data_ptr(),
            pair_d.data_ptr(), do_prune.data_ptr(), b, c, nn,
            kept_mask.data_ptr(), kept_count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, "prune_scan")
    return kept_mask, kept_count
