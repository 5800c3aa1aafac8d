"""The graph walk, the prune scan and the build's wiring: hand-written CUDA
kernels and their plain twins.

The JAX package compiles three loops into device programs: the beam walk
(``core/search.py::_search_one``, a ``lax.while_loop`` vmapped over the
batch), the diversity prune's keep/reject scan
(``core/build.py::_prune_heuristic``, a ``lax.fori_loop``) and the
wiring's back-link rounds (``core/build.py::_connect_batch``, two nested
``lax.while_loop`` loops).  Run as torch ops, each step of any of them is a
handful of small launches driven from the host.  Here each loop is one
launch:

  * ``beam_walk`` (``csrc/beam_walk.cu``): the whole walk of a query batch,
    one thread block per query.  Its plain twin is core/search's
    ``_search_batch``; it takes every traversal variant of the JAX
    package's walk: neighbour rows from the float32 or bf16 corpus rows,
    int8 rows x scales (quantized traversal), float32 / bf16 / int8 (x
    scales) packed records (int8 and bf16 records and rows staged in
    shared memory a step at a time where they fit, float32 records' first
    processed rows a step in a ring there, _records_place) or PQ
    records through a
    codebook (with OPQ's rotated query; the codes read through a
    per-query distance table in shared memory, whose plain form is
    pq_walk_table_plain and pq_walk_score_plain), the dense dedupe or the
    bitmap or hash visited set (in the block's shared memory where it
    fits, _visited_place), any metric and T, and ef and cand_cap up
    to MAX_WIDE_QUEUE (queues wider than MAX_WALK_QUEUE in the wide
    instances, which keep the held set from step to step;
    core/search.walk_route sends every walk on the card here).
  * ``prune_scan`` (``csrc/prune_scan.cu``): the scan of a batch of sorted
    candidate sets, one warp per set and one round per kept neighbour,
    reading the pairwise distances through the sort order.  Its plain
    twin is core/build's ``_prune_scan_plain``.
  * ``connect_batch`` (``csrc/connect_batch.cu``): the build's wiring of
    an insert batch (the JAX package's ``_connect_batch``: the forward
    rows' scatter and its while_loops): every member's forward row, and
    every target's back-link ops replayed in op order, appended or
    re-pruned by the diversity heuristic, a warp per chain (a block past
    64 candidates).  Its plain twin is core/build's
    ``_connect_sorted_plain`` (``_forward_links``, ``_replay_chains``).

Each wrapper runs the plain twin on a CPU tensor and launches its kernel on
a CUDA tensor or raises.  The sources' notes say what bounds each kernel on
the card and what the design does about it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import _kernels
from ..config import Metric
from .distance import _sqrt, dist_one_to_many

# Launches of each kernel since import (or since a caller reset them); a run
# reads them to show that a path went through the kernel.
LAUNCHES = {"beam_walk": 0, "prune_scan": 0, "connect_batch": 0}
# beam_walk's launches by variant (walk_variant's names), and prune_scan's
# by candidate-set shape (C, nn), counted beside LAUNCHES
WALK_VARIANTS: dict = {}
PRUNE_SHAPES: dict = {}
# beam_walk's launches of its wide instances (queues past MAX_WALK_QUEUE),
# and of its float32 records ring instances (kElemF32Staged), counted
# beside LAUNCHES
WIDE_WALKS = 0
RING_WALKS = 0

# Widest result and candidate queue of the walk instances that rebuild a
# held table each step (csrc/beam_walk.cu's kMaxQueue: past it the wide
# instances are faster, graph_probe --mode wide); wider ones (the API's
# widening from ef_search 40 passes it at 640 and may reach 8,191), up to
# MAX_WIDE_QUEUE, take the wide instances: the held set kept in device
# memory, the queues in shared memory where they fit, else in device
# memory.
MAX_WALK_QUEUE = 320
MAX_WIDE_QUEUE = 1 << 20
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
# an SM's shared memory (H100), the bytes each resident block reserves
# beside its own and the unit the runtime allocates a block's bytes in; the
# blocks an SM must hold of a walk instance (its registers' residency:
# csrc/beam_walk.cu's __launch_bounds__, kMinBlocks by block size,
# kWideMinBlocks).  _records_place's rule alone reads them; the smoke holds
# it to the runtime's occupancy on the card.
SM_SMEM, BLOCK_RESERVED, SMEM_UNIT = 233_472, 1_024, 128
WALK_MIN_BLOCKS = {128: 5, 256: 4}
WIDE_MIN_BLOCKS = 2
# the most shared memory an SM's blocks may take in all where a walk keeps
# its visited set there: 196 KB, the carveout one step below the largest
# (228 KB), so that the SM keeps 60 of its 256 KB as L1 for the rows and
# links the walk reads (_visited_place's rule alone reads it)
SET_SM_SMEM = 200_704
# device memory a launch may take for its queries' visited sets and wide
# queues; larger batches are walked in chunks of queries, a launch each
SCRATCH_BYTES = 1 << 30
_METRICS = (Metric.L2.value, Metric.COSINE.value, Metric.MANHATTAN.value)
# When an int64[8] tensor on the card, every connect_batch launch adds its
# counts to it: chains, back-link ops, re-prunes, pruned re-prunes, pairs
# turned into masks, valid re-prune candidates, the longest chain (a max).
# None on the main path; a measurement sets it.
CONNECT_STATS: Optional[torch.Tensor] = None
# the kernel's row sources by element type (csrc/beam_walk.cu kElem*)
_ELEMS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2, torch.uint8: 3}
_DTYPE_NAMES = {torch.float32: "f32", torch.int8: "int8",
                torch.bfloat16: "bf16", torch.uint8: "pq"}


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class PqTable(NamedTuple):
    """A PQ walk's distance table, as the walk's layout sees it: its groups
    G and its metric (cosine holds a float2 an entry)."""
    groups: int
    metric_value: int


def _pq_place(pq: Optional[PqTable], t: int, max_m: int,
              used: int) -> tuple:
    """Where a PQ source keeps its distance table and its step's codes
    (csrc/beam_walk.cu's pq_place), given ``used``, the shared bytes of the
    block's least layout (the room is what is left of SMEM_LIMIT):
    (shared bytes, device words a query, staged).  The table (256 codes x
    G groups, a float each, a float2 under cosine) and the staged codes (T
    maxM slots x G bytes, rounded up to 8) in shared memory where both
    fit; else the table alone, each row's codes read from the records;
    else the table in the query's device scratch.  (0, 0, False) for the
    other sources (None)."""
    if pq is None:
        return 0, 0, False
    room = max(SMEM_LIMIT - used, 0)
    table = 256 * pq.groups * (8 if pq.metric_value == Metric.COSINE.value
                               else 4)
    codes = -(-t * max_m * pq.groups // 8) * 8
    if table + codes <= room:
        return table + codes, 0, True
    if table <= room:
        return table, 0, False
    return 0, table // 4, False


class RecordsStage(NamedTuple):
    """An int8 or bf16 records or rows source, or float32 records, as the
    walk's layout sees it: the bytes of an element, whether int8 scales go
    with them, whether the bases the bulk copy reads are 16-byte aligned
    (the records' and their scales', or the rows': a rows source's scales
    are copied 4 bytes at a time), whether it is rows (a bulk copy a
    slot's row) or records (one a popped row's record), and for float32
    records the most rows their ring may hold (``ring``: a bulk copy a
    processed slot's row, T maxM at most a step; 0 for the others)."""
    itemsize: int
    scales: bool
    aligned: bool
    rows: bool = False
    ring: int = 0


def _blocks_by_smem(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory an SM holds: each takes
    its bytes and the reserve, rounded up to the allocation unit (45,600 B
    a block: 46,720, so 4 an SM, not 5)."""
    return SM_SMEM // (-(-(smem + BLOCK_RESERVED) // SMEM_UNIT) * SMEM_UNIT)


def _keeps_blocks(used: int, nbytes: int, min_blocks: int) -> bool:
    """Whether ``nbytes`` more beside ``used`` fit SMEM_LIMIT and leave an
    SM as many blocks as ``used`` alone does, up to ``min_blocks`` (the
    blocks it holds of the instance by its registers)."""
    keep = min(min_blocks, _blocks_by_smem(used))
    return (used + nbytes <= SMEM_LIMIT
            and _blocks_by_smem(used + nbytes) >= keep)


def _records_place(stage: Optional[RecordsStage], t: int, max_m: int,
                   dims: int, used: int, min_blocks: int,
                   at: Optional[int] = None) -> tuple:
    """Where an int8 or bf16 records or rows source keeps each step's
    rows, or float32 records their ring, given ``used``, the shared bytes
    of the rest of the block's layout, ``min_blocks``, the blocks an SM
    holds of the instance by its registers, and ``at``, the offset of the
    region they would take (``used`` by default): (shared bytes, staged).
    The T popped rows' whole records, or the T maxM slots' rows (T maxM D
    elements either way), then an int8 source's T maxM float32 scales,
    each rounded up to 16 bytes; for float32 records (``stage.ring``) a
    ring of K rows of D floats, K the most up to ``stage.ring`` that fit,
    in a 128-thread block (T maxM <= 128) alone: where the bulk copy's
    16-byte alignment
    holds (the bytes of what one copy moves: a record, or a rows source's
    or a ring's row; an int8 record's scales, ``at`` and the bases), they
    fit beside ``used`` within SMEM_LIMIT, and an SM still holds as many
    blocks as without them (up to ``min_blocks``); else (0, False): each
    slot is read from the records or rows.  (0, False) for the other
    sources (None).  csrc/beam_walk.cu's records_place checks the
    alignment and the fit again, and launches the staged instance where
    the shared bytes passed count the staged rows (a ring: as many rows
    as they count): the residency rule lives here alone.

    The residency rule is measured (graph_probe --mode records, 1M x
    128-d, ef 64, NVIDIA H100 80GB HBM3 at 700 W): staged walks that keep
    their blocks win (int8 T = 4 / 8 0.652 / 0.654 ms against 0.910 /
    0.853 reading the records; bf16 T = 4 0.644 against 0.912); bf16 at
    T = 8 (79,392 B a block: 2 blocks an SM, not 4) loses, 0.831 against
    0.799, so it reads the records (an L2 prefetch of them: 0.821).  Rows
    the same (graph_probe --mode rows): int8 T = 4 / 8 0.713 / 0.704 ms
    staged against 0.733 / 0.718 read from the rows, bf16 T = 4 0.707
    against 0.732; bf16 T = 8 staged 0.908 against 0.662, so it reads the
    rows.

    The ring's rule is measured too (the same probe and card, each
    comparison in turns in one call): at config 1's T = 4 a ring of 71
    rows (36,352 B beside 8,736: 5 blocks an SM) takes 0.772-0.776 ms
    against 0.909-0.913 reading the records; 64 rows tie with 71, 32 lose
    (0.850-0.853); at T = 2 a ring of the step's 64 rows 1.095-1.099
    against 1.290-1.292.  At T = 8 (256 threads, 64 registers, a ~170 B
    spill stack a thread that lives in the L1 the ring's bytes take)
    every ring lost: 84 rows (the most at 4 blocks) 1.092-1.096, 64
    1.005-1.008, 32 0.935-0.938, 122 at 3 blocks an SM 0.907-0.911, 61 at
    128 threads 0.914-0.916, against 0.899-0.903 reading the records; so
    a 256-thread block reads them.  ``min_blocks`` 0 (a forced placement)
    places a ring there all the same."""
    if stage is None or not stage.aligned:
        return 0, False
    at = used if at is None else at
    unit = (1 if stage.rows or stage.ring else max_m) * dims * stage.itemsize
    if (unit % 16 or (stage.scales and not stage.rows and max_m * 4 % 16)
            or at % 16):
        return 0, False
    if stage.ring:
        if min_blocks and _walk_threads(t, max_m) > 128:
            return 0, False
        rows = _ring_rows(stage, dims, used, min_blocks)
        return (rows * unit, True) if rows > 0 else (0, False)
    nbytes = -(-t * max_m * dims * stage.itemsize // 16) * 16
    if stage.scales:
        nbytes += -(-t * max_m * 4 // 16) * 16
    if not _keeps_blocks(used, nbytes, min_blocks):
        return 0, False
    return nbytes, True


def _ring_rows(stage: RecordsStage, dims: int, used: int,
               min_blocks: int) -> int:
    """The most rows of ``dims`` floats, up to ``stage.ring``, that a
    float32 records ring holds beside ``used`` bytes within SMEM_LIMIT
    with an SM still holding as many blocks as without it (up to
    ``min_blocks``; 0: wherever they fit).  _records_place's count, before
    its condition on the block's threads."""
    keep = min(min_blocks, _blocks_by_smem(used))
    room = SMEM_LIMIT - used
    if keep:
        room = min(room, SM_SMEM // keep // SMEM_UNIT * SMEM_UNIT
                   - BLOCK_RESERVED - used)
    return min(stage.ring, max(room, 0) // (4 * dims))


def _visited_place(words: int, used: int, min_blocks: int) -> tuple:
    """Where a table instance keeps the query's bitmap or hash visited set
    of ``words`` int32 (0: none), given ``used``, the shared bytes of the
    rest of the block's layout, and ``min_blocks``, the blocks an SM holds
    of the instance by its registers: (shared bytes, shared).  In shared
    memory after every other part, from the next 16-byte boundary (a hash
    bucket is one 16-byte load), where it fits beside ``used`` within
    SMEM_LIMIT, an SM still holds as many blocks as without it (up to
    ``min_blocks``: the rule _records_place applies to staged rows), and
    those blocks take at most SET_SM_SMEM of the SM's shared memory with
    it, leaving the SM 60 KB of L1; else (0, False): the set stays in
    device memory, filled by the wrapper.  ``min_blocks`` 0: wherever it
    fits (a probe's or a test's forced placement).  csrc/beam_walk.cu's
    vis_place checks the fit again, and the launch keeps the set there
    where the shared bytes passed count it and no device set is passed:
    the residency rule lives here alone.

    At config 1's shapes (ef 64, maxM 32, D 128, f32 rows) the API's hash
    set of 8,192 slots (32,768 B) is shared at T = 1 and 8 (T = 8: 46,624
    B a block, 4 blocks an SM as without it, 190,592 B an SM with their
    reserve), in device memory at T = 4 (41,504 B a block, 5 blocks: 212,640
    B an SM, past SET_SM_SMEM); at ef 128 its 16,384 slots would leave 2
    blocks an SM of 4 at T = 8, so they stay in device memory.  The
    bitmap, a bit an id of the graph's capacity, is shared for a 100k-row
    index (3,133 words at its capacity: 12,544 B); a 1M-row index's
    (31,680 words, 126,720 B) would leave 1 block an SM.

    The rule is measured (graph_probe --mode sets, ef 64, float32 rows,
    NVIDIA H100 80GB HBM3 at 700 W, each comparison in turns in one call):
    a shared set that costs no block and leaves the L1 wins (the hash set
    at T = 8 0.710-0.713 ms against 0.729-0.733 in device memory; the
    100k-row bitmap at T = 4 / 8 0.296-0.300 / 0.291-0.294 against
    0.305-0.308 / 0.307-0.308); the hash set at T = 4 loses (0.670-0.677
    against 0.670-0.674 in device memory, behind in 10 of 12 pairs over
    two calls): the device set in a block padded to the shared one's bytes
    runs 0.720-0.723, so the sets' 160 KB an SM, which leave it 28 KB of
    L1, cost the walk about what the shared set saves; a set that costs
    blocks loses (the 16,384-slot hash set at ef 128, T = 8, 2 blocks an
    SM: 1.380-1.383 against 1.186-1.192; the 1M-row bitmap, 1 block:
    1.564-1.567 against 0.709-0.715 at T = 8)."""
    if words <= 0:
        return 0, False
    nbytes = -(-used // 16) * 16 - used + -(-4 * words // 16) * 16
    blocks = min(min_blocks, _blocks_by_smem(used))
    if (not _keeps_blocks(used, nbytes, min_blocks)
            or blocks * (used + nbytes + BLOCK_RESERVED) > SET_SM_SMEM):
        return 0, False
    return nbytes, True


def _walk_plan(ef: int, cand_cap: int, t: int, max_m: int, dims: int,
               pq: Optional[PqTable], capacity: int, dense: bool,
               stage: Optional[RecordsStage] = None,
               visited: int = 0) -> tuple:
    """One walk block's memory, as csrc/beam_walk.cu's walk_layout lays it
    out: (shared bytes, held-table slots, slot-table slots, int32 words of
    device memory a query, whether the visited set is in shared memory).

    Shared memory: the query row (D rounded up to 4 floats), the result
    and candidate queues twice over (d, id), 24 bytes per expansion slot
    (its id, the compacted processed slots, the admitted (d, slot) and
    their ranked (d, id)) and 8 counters; then the dedupe's hash tables:
    the held ids (4 bytes a slot, a power of two of at least 2 (ef +
    cand_cap) slots) and the expansion's ids with their smallest slot (8
    bytes a slot, at least 2 T maxM); then a PQ source's table and staged
    codes (_pq_place: placed before the hash tables, which take what it
    leaves; where they do not fit, the kernel dedupes by comparison and
    they take 0); then an int8 or bf16 records or rows source's staged
    rows, or a float32 records source's ring (``stage``, _records_place:
    after every other part, where they fit beside it, so nothing else
    moves); then a bitmap or hash visited
    set of ``visited`` words (0: none) where _visited_place keeps it there
    (else it is in device memory, its words not counted here:
    _walk_launch).
    Queues wider than
    MAX_WALK_QUEUE take the wide instances: the least part (_walk_fixed),
    the PQ part or the staged rows (no ring), then each queue once (d, id; the
    candidate ring of _walk_ring entries) where that fits SMEM_LIMIT; no
    held table, and the visited set in device memory.  Device
    memory a query: 0 where both queues
    fit MAX_WALK_QUEUE, else the held set of the dense dedupe (two bits an
    id of ``capacity``, kept from step to step), then the queues where they
    are not in shared memory; and a PQ table's words where it is not (the
    walk's own words rounded up to 2: the kernel lays the tables out after
    every query's own words, 8-aligned).  Raises ValueError where
    the least part is past SMEM_LIMIT, as for every source: a PQ table
    never refuses a walk."""
    tm = t * max_m
    if max(ef, cand_cap) > MAX_WALK_QUEUE:
        fixed = _walk_fixed(t, max_m, dims)
        if fixed > SMEM_LIMIT:
            raise ValueError(
                f"the walk needs {fixed} bytes of shared memory a block "
                f"(T={t}, maxM={max_m}, D={dims}); the limit is "
                f"{SMEM_LIMIT}")
        pq_smem, pq_words, _ = _pq_place(pq, t, max_m, fixed)
        fixed += pq_smem
        held = -(-capacity // 16) if dense else 0
        queues = 8 * (ef + _walk_ring(cand_cap, t))
        slots = _pow2_at_least(2 * tm)
        if stage is not None and stage.ring:
            stage = None            # the wide instances keep no ring
        if fixed + queues <= SMEM_LIMIT:
            rec, _ = _records_place(stage, t, max_m, dims, fixed + queues,
                                    WIDE_MIN_BLOCKS, fixed)
            return (fixed + rec + queues, 0, slots,
                    _with_pq_words(held, pq_words), False)
        rec, _ = _records_place(stage, t, max_m, dims, fixed,
                                WIDE_MIN_BLOCKS)
        return (fixed + rec, 0, slots,
                _with_pq_words(held + queues // 4, pq_words), False)
    held, slots = _pow2_at_least(2 * (ef + cand_cap)), _pow2_at_least(2 * tm)
    base = 4 * (-(-dims // 4) * 4) + 16 * (ef + cand_cap) + 24 * tm + 32
    if base > SMEM_LIMIT:
        raise ValueError(
            f"the walk needs {base} bytes of shared memory a block "
            f"(ef={ef}, cand_cap={cand_cap}, T={t}, maxM={max_m}, D={dims});"
            f" the limit is {SMEM_LIMIT}")
    pq_smem, pq_words, _ = _pq_place(pq, t, max_m, base)
    base += pq_smem
    tables = 4 * held + 8 * slots
    if base + tables > SMEM_LIMIT:
        held = slots = tables = 0
    min_blocks = WALK_MIN_BLOCKS[_walk_threads(t, max_m)]
    rec, _ = _records_place(stage, t, max_m, dims, base + tables, min_blocks)
    vis, shared = _visited_place(visited, base + tables + rec, min_blocks)
    return base + tables + rec + vis, held, slots, pq_words, shared


def _walk_threads(t: int, max_m: int) -> int:
    """Threads of a table instance's block (csrc/beam_walk.cu's
    walk_threads): 128 where T maxM <= 128, else 256."""
    return 128 if t * max_m <= 128 else 256


def _with_pq_words(words: int, pq_words: int) -> int:
    """A query's device words: the walk's own and a PQ table's (the walk's
    rounded up to 2 first, so that the tables, after every query's own
    words, are 8-aligned)."""
    return -(-words // 2) * 2 + pq_words if pq_words else words


def _walk_layout(ef: int, cand_cap: int, t: int, max_m: int, dims: int,
                 pq: Optional[PqTable],
                 stage: Optional[RecordsStage] = None,
                 visited: int = 0) -> tuple:
    """Shared memory of one walk block (_walk_plan): (bytes, held-table
    slots, slot-table slots).  ``pq``: a PQ source's table (None for the
    other sources); ``stage``: an int8 or bf16 records or rows
    source's; ``visited``: a bitmap or hash set's words."""
    return _walk_plan(ef, cand_cap, t, max_m, dims, pq, 0, False,
                      stage, visited)[:3]


def _walk_fixed(t: int, max_m: int, dims: int) -> int:
    """Bytes of a wide walk block before a PQ source's part and the
    queues: the query row (D rounded up to 4 floats), 24 bytes per
    expansion slot, 8 counters and the slot table (8 bytes a slot, a power
    of two of at least 2 T maxM)."""
    tm = t * max_m
    return 4 * (-(-dims // 4) * 4) + 24 * tm + 32 + 8 * _pow2_at_least(
        2 * tm)


def _walk_ring(cand_cap: int, t: int) -> int:
    """Entries of a wide walk's candidate ring: cand_cap rounded up to a
    multiple of T, so that a pop of T never wraps."""
    return -(-cand_cap // t) * t


def _walk_wide_words(ef: int, cand_cap: int, t: int, max_m: int, dims: int,
                     capacity: int, dense: bool,
                     pq: Optional[PqTable]) -> int:
    """int32 words of device memory one query's walk takes (_walk_plan):
    the wide walks' held set and the queues that are not in shared memory,
    then a PQ table that is not."""
    return _walk_plan(ef, cand_cap, t, max_m, dims, pq, capacity, dense)[3]


def _walk_smem_bytes(ef: int, cand_cap: int, t: int, max_m: int,
                     dims: int, pq: Optional[PqTable],
                     stage: Optional[RecordsStage] = None,
                     visited: int = 0) -> int:
    """The bytes of _walk_layout: what the launch passes and the C side
    checks."""
    return _walk_layout(ef, cand_cap, t, max_m, dims, pq, stage,
                        visited)[0]


class WalkLaunch(NamedTuple):
    """One beam_walk launch's plan (_walk_plan): its shared bytes a block,
    whether a bitmap or hash visited set is in them (each block fills its
    own, and no device set is passed), the walk's own device words a
    query (the wide walks' held set and queues, a PQ table: the kernel's
    wide_words) and a visited set's where it is in device memory (filled
    by the wrapper).  ``words`` is what SCRATCH_BYTES chunks a batch by."""
    smem: int
    visited_shared: bool
    wide_words: int
    set_words: int

    @property
    def words(self) -> int:
        return self.wide_words + self.set_words


def _walk_launch(graph, src: "WalkSource", ef: int, cand_cap: int, t: int,
                 visited_slots: int) -> WalkLaunch:
    """The launch _walk_plan lays out for a walk of ``src`` over
    ``graph`` under the visited set ``visited_slots`` (-1: the dense
    dedupe)."""
    vis = _visited_words(graph, visited_slots) if visited_slots >= 0 else 0
    smem, _, _, wide, shared = _walk_plan(
        ef, cand_cap, t, graph.max_m, src.query.shape[1], src.pq,
        graph.capacity, visited_slots < 0, src.stage, vis)
    return WalkLaunch(smem, shared, wide, 0 if shared else vis)


def records_staging(ef: int, cand_cap: int, t: int, max_m: int, dims: int,
                    stage: Optional[RecordsStage]) -> int:
    """The shared bytes a walk block gives its staged records or rows
    (_walk_plan; 0: the walk reads each slot from the records or
    rows)."""
    return (_walk_smem_bytes(ef, cand_cap, t, max_m, dims, None, stage)
            - _walk_smem_bytes(ef, cand_cap, t, max_m, dims, None))


def _lane_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The kernel's sum of a warp's lane partials over the last axis:
    lane l sums elements l, l + 32, ... in order from 0, then the lanes
    meet in a butterfly (xor 16, 8, 4, 2, 1; rows_sum and warp_sum's tree
    of additions), each addition rounded."""
    n = x.shape[-1]
    lanes = torch.zeros((*x.shape[:-1], 32), dtype=torch.float32,
                        device=x.device)
    for start in range(0, n, 32):
        part = x[..., start:start + 32]
        lanes[..., :part.shape[-1]] = lanes[..., :part.shape[-1]] + part
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    return lanes[..., 0]


def pq_walk_table_plain(query_t: torch.Tensor, codebook: torch.Tensor,
                        metric_value: int) -> torch.Tensor:
    """The PQ walk's per-query distance table, as csrc/beam_walk.cu's
    build_pq_table computes it: the walk's queries f32[B, D] (OPQ: q @ R)
    against codebook f32[G, 256, D / G].  Entry [b, k, g] is the metric's
    sum over group g's elements of centroid k against query b, from 0 in
    element order, each operation rounded on its own: L2 sum (c - q)^2,
    Manhattan sum |c - q|; cosine has a last axis of 2, (sum c q, sum
    c^2).  Returns f32[B, 256, G] (cosine f32[B, 256, G, 2]): the kernel's
    layout, the group minor.  The tests' plain form: nothing on the card's
    path calls it."""
    groups, n_codes, sub = codebook.shape
    q = query_t.to(torch.float32).reshape(-1, groups, sub)
    cb = codebook.to(torch.float32).transpose(0, 1)          # [256, G, sub]
    a = torch.zeros((q.shape[0], n_codes, groups), dtype=torch.float32,
                    device=q.device)
    pp = torch.zeros_like(a)
    cosine = metric_value == Metric.COSINE.value
    for j in range(sub):
        c, x = cb[None, :, :, j], q[:, None, :, j]
        if metric_value == Metric.L2.value:
            t = c - x
            a = a + t * t
        elif cosine:
            a = a + c * x
            pp = pp + c * c
        elif metric_value == Metric.MANHATTAN.value:
            a = a + torch.abs(c - x)
        else:
            raise ValueError(f"unknown metric {metric_value}")
    return torch.stack([a, pp], dim=-1) if cosine else a


def pq_walk_score_plain(table: torch.Tensor, codes: torch.Tensor,
                        metric_value: int,
                        query_t: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The PQ walk's distances by lookups, as csrc/beam_walk.cu's
    score_rows computes them: ``table`` from pq_walk_table_plain, codes
    u8[B, N, G] (each query's rows).  Lane g's partial sums the entries of
    groups g, g + 32, ... from 0; the lanes meet in the kernel's butterfly
    (_lane_tree_sum); then the verdict: L2 sqrt, Manhattan the sum, cosine
    1 - dot rsqrt(max(|q|^2 sum c^2, 1e-30)) with |q|^2 summed in the
    kernel's order from ``query_t`` (needed for cosine only).  Returns
    f32[B, N].  The tests' plain form: nothing on the card's path calls
    it."""
    idx = codes.long()
    if metric_value == Metric.COSINE.value:
        if query_t is None:
            raise ValueError("cosine scores need the walk's queries")
        got = torch.gather(table, 1, idx.unsqueeze(-1).expand(
            *idx.shape, 2))
        dot = _lane_tree_sum(got[..., 0])
        cc = _lane_tree_sum(got[..., 1])
        q = query_t.to(torch.float32)
        qq = _lane_tree_sum(q * q).unsqueeze(1)
        return 1.0 - dot * torch.rsqrt(torch.clamp(qq * cc, min=1e-30))
    s = _lane_tree_sum(torch.gather(table, 1, idx))
    if metric_value == Metric.L2.value:
        return _sqrt(s)
    if metric_value == Metric.MANHATTAN.value:
        return s
    raise ValueError(f"unknown metric {metric_value}")


class WalkSource(NamedTuple):
    """What the kernel's phase 3 reads, checked by _check_walk_args."""
    rows: torch.Tensor            # rows [cap, D] or records [cap, maxM, .]
    elem: int                     # csrc/beam_walk.cu's kElem
    records: bool
    scales: Optional[torch.Tensor]    # int8: f32[cap] or f32[cap, maxM]
    codebook: Optional[torch.Tensor]  # PQ: f32[G, 256, D / G]
    query: torch.Tensor           # the walk's query rows (OPQ: q @ R)
    variant: str                  # walk_variant's name
    pq: Optional[PqTable]         # PQ: its distance table, else None
    stage: Optional[RecordsStage]  # int8 / bf16 records or rows, float32
                                   # records (a ring), else None


def visited_name(visited_slots: int) -> str:
    return ("dense" if visited_slots < 0 else
            "bitmap" if visited_slots == 0 else "hash")


def walk_variant(rows_dtype, records_dtype=None, *, quantized=False,
                 rotated=False, visited_slots=-1) -> str:
    """The name a walk is counted under in WALK_VARIANTS: its row source
    and visited set, e.g. "records int8, dense" or "records pq rotated,
    hash"."""
    if records_dtype is not None:
        src = f"records {_DTYPE_NAMES[records_dtype]}"
    elif quantized:
        src = "rows int8"
    else:
        src = f"rows {_DTYPE_NAMES[rows_dtype]}"
    return (f"{src}{' rotated' if rotated else ''}, "
            f"{visited_name(visited_slots)}")


def _want(name, x, dtype, shape, device) -> None:
    """Raise ValueError unless ``x`` is ``dtype`` of ``shape`` on
    ``device`` and contiguous."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype}{list(shape)}, got "
                         f"{x.dtype}{list(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} must be on {device}, not {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_walk_args(graph, queries, ef, cand_cap, t, metric_value, *,
                     records=None, pscales=None, qvectors=None, qscale=None,
                     pq_codebook=None, query_t=None,
                     visited_slots=-1) -> WalkSource:
    """Check a walk's arguments for the kernel (the operands of
    core/search._search_batch) and return its row source; raise
    ValueError on anything the kernel does not take."""
    if metric_value not in _METRICS:
        raise ValueError(f"unknown metric {metric_value}")
    if not (1 <= ef <= MAX_WIDE_QUEUE and 1 <= cand_cap <= MAX_WIDE_QUEUE):
        raise ValueError(f"ef={ef}, cand_cap={cand_cap} outside "
                         f"[1, {MAX_WIDE_QUEUE}]")
    if not 1 <= t <= cand_cap:
        raise ValueError(f"expand_width={t} outside [1, cand_cap={cand_cap}]")
    if visited_slots > 0 and (visited_slots < 4
                              or visited_slots & (visited_slots - 1)):
        raise ValueError(f"visited_slots={visited_slots} is not a power of "
                         f"2 of at least 4")
    cap, dims = graph.vectors.shape
    max_m, dev = graph.max_m, queries.device
    if queries.dim() != 2 or queries.shape[1] != dims:
        raise ValueError(f"queries {tuple(queries.shape)} are not [B, {dims}]")
    b = queries.shape[0]
    _want("queries", queries, torch.float32, (b, dims), dev)
    if graph.vectors.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the walk kernel reads float32 or bf16 corpus "
                         f"rows, not {graph.vectors.dtype}")
    _want("vectors", graph.vectors, graph.vectors.dtype, (cap, dims), dev)
    _want("links", graph.links, torch.int32, (cap, max_m), dev)
    _want("link_counts", graph.link_counts, torch.int32, (cap,), dev)
    if query_t is not None:
        _want("query_t", query_t, torch.float32, (b, dims), dev)
    if (pscales is not None) != (records is not None
                                 and records.dtype == torch.int8):
        raise ValueError("pscales go with int8 records, and only with them")
    if (qscale is not None) != (qvectors is not None):
        raise ValueError("qvectors and qscale go together")
    if (pq_codebook is not None) and records is None:
        raise ValueError("pq_codebook needs PQ records")
    if records is not None and qvectors is not None:
        raise ValueError("the walk reads records or int8 rows, not both")
    scales = codebook = None
    if pq_codebook is not None:
        groups = records.shape[-1] if records.dim() == 3 else 0
        if groups < 1 or dims % groups:
            raise ValueError(f"PQ records {tuple(records.shape)} are not "
                             f"[{cap}, {max_m}, G] with G dividing {dims}")
        _want("records", records, torch.uint8, (cap, max_m, groups), dev)
        _want("pq_codebook", pq_codebook, torch.float32,
              (groups, 256, dims // groups), dev)
        rows, codebook = records, pq_codebook
    elif records is not None:
        if records.dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"the walk kernel reads float32, bf16 or int8 "
                             f"records, not {records.dtype}")
        _want("records", records, records.dtype, (cap, max_m, dims), dev)
        if pscales is not None:
            _want("pscales", pscales, torch.float32, (cap, max_m), dev)
        rows, scales = records, pscales
    elif qvectors is not None:
        _want("qvectors", qvectors, torch.int8, (cap, dims), dev)
        _want("qscale", qscale, torch.float32, (cap,), dev)
        rows, scales = qvectors, qscale
    else:
        rows = graph.vectors
    variant = walk_variant(graph.vectors.dtype,
                           None if records is None else records.dtype,
                           quantized=qvectors is not None,
                           rotated=query_t is not None,
                           visited_slots=visited_slots)
    pq = (PqTable(rows.shape[-1], metric_value) if codebook is not None
          else None)
    stage = None
    if rows.dtype in (torch.int8, torch.bfloat16):
        # the bases the bulk copy reads: the records' and their scales', or
        # the rows' alone (a rows source's scales go 4 bytes at a time)
        bulk = (rows,) if records is None else (rows, scales)
        stage = RecordsStage(rows.element_size(), scales is not None,
                             all(x.data_ptr() % 16 == 0 for x in bulk
                                 if x is not None),
                             records is None)
    elif records is not None and rows.dtype == torch.float32:
        # float32 records: a ring of at most a step's T maxM slots' rows
        stage = RecordsStage(4, False, rows.data_ptr() % 16 == 0, False,
                             t * max_m)
    return WalkSource(rows, _ELEMS[rows.dtype], records is not None, scales,
                      codebook, queries if query_t is None else query_t,
                      variant, pq, stage)


def beam_walk(graph, queries: torch.Tensor, *, ef: int, metric_value: int,
              cand_cap: int, expand_width: int = 1, records=None,
              pscales=None, qvectors=None, qscale=None, pq_codebook=None,
              query_t=None, visited_slots: int = -1):
    """searchBaseLayer for a batch of queries f32[B, D] over ``graph``:
    the walk of core/search._search_batch, with the same operands (records
    = its ``pcodes``).  Returns (res_d f32[B, ef], res_i i32[B, ef], hops
    i32[B], dist_evals i32[B]), results ascending, -1/inf padded: what
    _search_batch returns (core/search.finish_walk then reranks approximate
    sources and drops the hash set's duplicates, on both routes).

    The entry distance (to node 0) is the twin's own torch op on the
    original queries and corpus row, so both walks start from the same
    bits (and the records, which hold no row of the entry, need none).
    The bitmap and hash sets live in each block's shared memory where a
    table instance has room for them and an SM keeps its blocks
    (_visited_place), else in device memory; those, and the wide walks'
    held set and queues that do not fit in shared memory, take
    SCRATCH_BYTES at most a launch: a larger batch is walked in chunks
    (_walk_launch).  A PQ walk's
    blocks each build the query's distance table in shared memory and
    stage each step's codes beside it, or, where they do not fit a block,
    read the codes from the records, or keep the table in device memory
    too (_pq_place).  An int8 or bf16 records walk's blocks copy each
    step's popped records to shared memory, an int8 or bf16 rows walk's
    each processed slot's row as the dedupe keeps it, a float32 records
    walk's the first K processed slots' rows into a ring (the rest read
    from the records), where they fit and an SM keeps its blocks, else
    read them from the records or rows (_records_place)."""
    global WIDE_WALKS, RING_WALKS
    if queries.device.type == "cpu":
        from ..core.search import _search_batch
        return _search_batch(graph, queries, ef=ef, metric_value=metric_value,
                             cand_cap=cand_cap, expand_width=expand_width,
                             pcodes=records, pscales=pscales,
                             qvectors=qvectors, qscale=qscale,
                             pq_codebook=pq_codebook, query_t=query_t,
                             visited_slots=visited_slots)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    t = int(expand_width)
    queries = queries.contiguous()
    src = _check_walk_args(graph, queries, ef, cand_cap, t, metric_value,
                           records=records, pscales=pscales,
                           qvectors=qvectors, qscale=qscale,
                           pq_codebook=pq_codebook, query_t=query_t,
                           visited_slots=visited_slots)
    lib = _kernels.load_library()
    plan = _walk_launch(graph, src, ef, cand_cap, t, visited_slots)
    ring = (src.stage is not None and src.stage.ring > 0
            and records_staging(ef, cand_cap, t, graph.max_m,
                                queries.shape[1], src.stage) > 0)
    b = queries.shape[0]
    step = max(1, SCRATCH_BYTES // (4 * plan.words)) if plan.words else b
    outs = []
    for lo in range(0, max(b, 1), step):
        hi = min(lo + step, b)
        outs.append(_launch_walk(
            lib, graph, queries[lo:hi], src._replace(query=src.query[lo:hi]),
            ef=ef, cand_cap=cand_cap, t=t, metric_value=metric_value,
            plan=plan, visited_slots=visited_slots))
        if hi > lo:                                     # b = 0: no launch
            LAUNCHES["beam_walk"] += 1
            WALK_VARIANTS[src.variant] = WALK_VARIANTS.get(src.variant,
                                                           0) + 1
            WIDE_WALKS += max(ef, cand_cap) > MAX_WALK_QUEUE
            RING_WALKS += ring
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _visited_words(graph, visited_slots: int) -> int:
    """32-bit words of one query's visited set: the bitmap's (a bit an id)
    or the hash table's slots."""
    return -(-graph.capacity // 32) if visited_slots == 0 else visited_slots


def _device_visited(b: int, words: int, visited_slots: int, has_nodes: bool,
                    dev) -> torch.Tensor:
    """``b`` queries' visited sets of ``words`` in device memory, as the
    twin starts them: the bitmap zeroed, the hash table -1, node 0 held
    (its bit; slot 0 of its bucket) when the graph has nodes."""
    visited = torch.full((b, words), 0 if visited_slots == 0 else -1,
                         dtype=torch.int32, device=dev)
    if has_nodes:
        visited[:, 0] = 1 if visited_slots == 0 else 0
    return visited


def _launch_walk(lib, graph, queries, src: WalkSource, *, ef, cand_cap, t,
                 metric_value, plan: WalkLaunch, visited_slots=-1):
    """One launch of ``lib``'s beam_walk on checked arguments (the
    wrapper's library, or a probe's build of the same source) as ``plan``
    lays it out (_walk_launch).  The bitmap starts zeroed and the hash
    table empty (-1), each holding node 0 when the graph has nodes, as the
    twin's do: filled here in device memory where the plan has a device
    set, else by each block in its shared memory; a walk with queues
    wider than MAX_WALK_QUEUE, or a PQ table that does not fit a block,
    gets its device memory here, zeroed (the held set starts empty; the
    kernel fills the queues and builds the table)."""
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
    vis_n = _visited_words(graph, visited_slots) if visited_slots >= 0 else 0
    visited = (_device_visited(b, plan.set_words, visited_slots, has_nodes,
                               dev) if plan.set_words else None)
    wide = (torch.zeros((b, plan.wide_words), dtype=torch.int32, device=dev)
            if plan.wide_words else None)

    def ptr(x):
        return None if x is None else x.data_ptr()
    groups = src.rows.shape[-1] if src.codebook is not None else 0
    with torch.cuda.device(dev):
        err = lib.beam_walk(
            graph.links.data_ptr(), graph.link_counts.data_ptr(),
            src.rows.data_ptr(), ptr(src.scales), ptr(src.codebook),
            src.query.data_ptr(), entry.data_ptr(), ptr(visited), ptr(wide),
            src.elem, int(src.records), int(has_nodes), b, dims, graph.max_m,
            t, ef, cand_cap, metric_value, groups, visited_slots, vis_n,
            graph.capacity, plan.smem, plan.wide_words, out_d.data_ptr(),
            out_i.data_ptr(), hops.data_ptr(),
            evals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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


class ConnectLayout(NamedTuple):
    """One connect_batch launch's shape, as csrc/connect_batch.cu picks it:
    the tier ("warp", or the block tier's "staged", "masks only", "device
    masks"), the bytes of shared memory a block and the threads a
    block."""
    tier: str
    smem: int
    threads: int


# the warp tier: sets of up to CONNECT_WARP_MAX_C candidates (two a lane),
# CONNECT_WARPS warps a block where their shared memory fits
CONNECT_WARP_MAX_C = 64
CONNECT_WARPS = 4
_CONNECT_THREADS = 256              # a block of the block tier


def _connect_warp_bytes(c: int, dims: int, itemsize: int) -> int:
    """Shared memory of one warp of connect_batch's warp tier, as
    csrc/connect_batch.cu lays it out: the staging's barrier (16 bytes), the
    masks (8 bytes a candidate), the chain's row, d, two norms and the scan
    order (4 bytes a candidate each), rounded up to 16 bytes; then the c
    candidates' rows and the target's in their own dtype, each at a stride
    of 16-byte chunks rounded up to a multiple of 8."""
    chunks = -(-dims * itemsize // 16)
    return 16 + -(-28 * c // 16) * 16 + (c + 1) * -(-chunks // 8) * 8 * 16


def _connect_layout(c: int, dims: int, itemsize: int = 4) -> ConnectLayout:
    """connect_batch's launch shape for sets of ``c`` = maxM + 1 candidates
    of ``dims`` elements of ``itemsize`` bytes.  The warp tier where c <=
    CONNECT_WARP_MAX_C and a warp's slice (_connect_warp_bytes) fits:
    CONNECT_WARPS warps a block, fewer where only fewer fit.  Else a block
    of 256 threads: ids, distances, two norms and the scan order (4 bytes a
    candidate each), the kept words and their prefix counts (4 bytes a 32
    candidates each) and 8 scalars; the bit masks [c, ceil(c / 32)] words
    where they fit (else a scratch in device memory); the candidates' rows
    as float32 [c, dims | 1] where those fit too.  Raises ValueError past
    SMEM_LIMIT."""
    if c <= CONNECT_WARP_MAX_C:
        per = _connect_warp_bytes(c, dims, itemsize)
        warps = min(CONNECT_WARPS, SMEM_LIMIT // per)
        if warps:
            return ConnectLayout("warp", warps * per, 32 * warps)
    w = -(-c // 32)
    base = 4 * (5 * c + 2 * w + 8)
    if base > SMEM_LIMIT:
        raise ValueError(f"a re-prune of {c} candidates needs {base} bytes "
                         f"of shared memory; the limit is {SMEM_LIMIT}")
    masks, rows = 4 * c * w, 4 * c * (dims | 1)
    if base + masks + rows <= SMEM_LIMIT:
        return ConnectLayout("staged", base + masks + rows, _CONNECT_THREADS)
    if base + masks <= SMEM_LIMIT:
        return ConnectLayout("masks only", base + masks, _CONNECT_THREADS)
    return ConnectLayout("device masks", base, _CONNECT_THREADS)


class ConnectLaunch(NamedTuple):
    """The shape a connect_batch launch was given: its tier, blocks,
    threads a block and bytes of shared memory a block."""
    tier: str
    blocks: int
    threads: int
    smem: int


# the shape of the last connect_batch launch, as _launch_connect passed it
LAST_CONNECT_LAUNCH: Optional[ConnectLaunch] = None


def _connect_blocks(bm: int, c: int, layout: ConnectLayout, sms: int) -> int:
    """connect_batch's grid.  The warp tier: a warp a sorted op (bm warps).
    The block tier: four blocks an SM (a grid-stride loop over the bm
    sorted ops), fewer where the masks take SCRATCH_BYTES of device memory
    (c * ceil(c / 32) words a block)."""
    if layout.tier == "warp":
        return max(-(-bm // (layout.threads // 32)), 1)
    blocks = min(bm, 4 * sms)
    if layout.tier == "device masks":
        blocks = min(blocks, max(1, SCRATCH_BYTES // (4 * c * -(-c // 32))))
    return max(blocks, 1)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def connect_batch(vectors: torch.Tensor, links: torch.Tensor,
                  link_counts: torch.Tensor, keys: torch.Tensor,
                  perm: torch.Tensor, kept_i: torch.Tensor,
                  kept_cnt: torch.Tensor, *, base: int, n_insert: int,
                  m: int, max_m: int, metric_value: int):
    """Wire an insert batch on ``links`` i32[cap, maxM] and ``link_counts``
    i32[cap] in place: the members' forward rows (kept_i i32[b, m],
    kept_cnt i32[b]: member u < n_insert is node base + u) and the
    back-link ops, keys i32[bm] (their targets stably sorted, invalid ops
    at core/build.NO_TARGET) and perm i64[bm] (their op indices, op =
    member * m + slot, carrying node base + member), core/build's
    _back_link_targets and _chain_order; vectors f32 or bf16 [cap, D].
    Returns (links, link_counts).  One launch, no host sync."""
    if vectors.device.type == "cpu":
        from ..core.build import _connect_sorted_plain
        return _connect_sorted_plain(
            vectors, links, link_counts, keys, perm, kept_i, kept_cnt,
            base=base, n_insert=n_insert, m=m, max_m=max_m,
            metric_value=metric_value)
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    if metric_value not in _METRICS:
        raise ValueError(f"unknown metric {metric_value}")
    if vectors.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the connect kernel reads float32 or bf16 rows, "
                         f"not {vectors.dtype}")
    if vectors.dim() != 2 or keys.dim() != 1 or kept_i.dim() != 2:
        raise ValueError(f"vectors {tuple(vectors.shape)}, keys "
                         f"{tuple(keys.shape)} and kept_i "
                         f"{tuple(kept_i.shape)} are not [cap, D], [bm] "
                         f"and [b, m]")
    if not 1 <= m <= max_m:
        raise ValueError(f"m={m} outside [1, max_m={max_m}]")
    (cap, dims), dev = vectors.shape, vectors.device
    b, bm = kept_i.shape[0], keys.shape[0]
    if bm != b * m or not (0 <= n_insert <= b and 0 <= base
                           and base + n_insert <= cap):
        raise ValueError(f"{bm} ops are not a batch of {b} x m={m} with "
                         f"{n_insert} members at base {base} of {cap} rows")
    _want("vectors", vectors, vectors.dtype, (cap, dims), dev)
    _want("links", links, torch.int32, (cap, max_m), dev)
    _want("link_counts", link_counts, torch.int32, (cap,), dev)
    _want("keys", keys, torch.int32, (bm,), dev)
    _want("perm", perm, torch.int64, (bm,), dev)
    _want("kept_i", kept_i, torch.int32, (b, m), dev)
    _want("kept_cnt", kept_cnt, torch.int32, (b,), dev)
    _connect_layout(max_m + 1, dims, vectors.element_size())  # or raises
    if bm == 0:                                          # no op: no launch
        return links, link_counts
    _launch_connect(_kernels.load_library(), vectors, links, link_counts,
                    keys, perm, kept_i, kept_cnt, base=base,
                    n_insert=n_insert, m=m, max_m=max_m,
                    metric_value=metric_value)
    LAUNCHES["connect_batch"] += 1
    return links, link_counts


def _launch_connect(lib, vectors, links, link_counts, keys, perm, kept_i,
                    kept_cnt, *, base, n_insert, m, max_m, metric_value):
    """One launch of ``lib``'s connect_batch on checked arguments (the
    wrapper's library, or a probe's build of the same source), on
    _connect_blocks' grid; the shape it passes is left in
    LAST_CONNECT_LAUNCH."""
    global LAST_CONNECT_LAUNCH
    dev, dims, c = vectors.device, vectors.shape[1], max_m + 1
    b, bm = kept_i.shape[0], keys.shape[0]
    layout = _connect_layout(c, dims, vectors.element_size())
    blocks = _connect_blocks(bm, c, layout, _sm_count(dev))
    # the block tier's masks in device memory where they do not fit shared
    # memory: a block's slice each
    masks = (torch.empty((blocks, c * -(-c // 32)), dtype=torch.int32,
                         device=dev)
             if layout.tier == "device masks" else None)
    stats = CONNECT_STATS
    if stats is not None:
        _want("CONNECT_STATS", stats, torch.int64, (8,), dev)
    with torch.cuda.device(dev):
        err = lib.connect_batch(
            vectors.data_ptr(), _ELEMS[vectors.dtype], links.data_ptr(),
            link_counts.data_ptr(), keys.data_ptr(), perm.data_ptr(),
            kept_i.data_ptr(), kept_cnt.data_ptr(), b, m, base, n_insert,
            max_m, dims, metric_value, layout.smem, blocks,
            None if masks is None else masks.data_ptr(),
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, "connect_batch")
    LAST_CONNECT_LAUNCH = ConnectLaunch(layout.tier, blocks, layout.threads,
                                        layout.smem)
