"""The int8 and bf16 records and rows walks' staging (csrc/beam_walk.cu's
records_place, ops/cuda_graph._records_place): each popped row's whole
record, and an int8 record's scales, copied to shared memory in phase 1,
or each processed slot's row, and an int8 row's scale, in phase 2; and
the float32 records' ring: the first K processed slots' record rows a
step, copied in phase 2.  On the CPU: the bytes it takes, where it does
not stage (alignment, room, residency, the wide instances), the walk
block's layout with and without it (every other source's bytes as
before), the constants it shares with the C side and the row source each
walk's operands give.  Nothing here needs the card: the staged walks
themselves are held to the twin bit for bit in tests/test_torch_cuda.py
and chip_smoke.py."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch.convert import graph_from_numpy
from pg_embedding_tpu_torch.core.graph import pack_records
from pg_embedding_tpu_torch.ops import cuda_graph as cg

INT8 = cg.RecordsStage(1, True, True)
BF16 = cg.RecordsStage(2, False, True)
# the quantized traversal's int8 rows x scales, and bf16 corpus rows
INT8_ROWS = cg.RecordsStage(1, True, True, True)
BF16_ROWS = cg.RecordsStage(2, False, True, True)
# the f32 rows' layout at the smoke's shapes (ef = cand_cap = 64, maxM 32,
# D 128): (bytes, held-table slots, slot-table slots) at T = 4 and 8
F32_LAYOUT = {4: (8736, 256, 256), 8: (13856, 256, 512)}


def ring(t, max_m=32, aligned=True):
    """The float32 records source of a walk at T = ``t`` (a ring of at
    most T maxM rows), as _check_walk_args gives it."""
    return cg.RecordsStage(4, False, aligned, False, t * max_m)


def _old_walk_plan(ef, cand_cap, t, max_m, dims, pq, capacity, dense):
    """The walk block's layout before the records' staging (the tree of the
    PQ table), for every source: (shared bytes, held-table slots,
    slot-table slots, device words a query)."""
    tm = t * max_m
    if max(ef, cand_cap) > cg.MAX_WALK_QUEUE:
        fixed = cg._walk_fixed(t, max_m, dims)
        pq_smem, pq_words, _ = cg._pq_place(pq, t, max_m, fixed)
        fixed += pq_smem
        held = -(-capacity // 16) if dense else 0
        queues = 8 * (ef + cg._walk_ring(cand_cap, t))
        slots = cg._pow2_at_least(2 * tm)
        if fixed + queues <= cg.SMEM_LIMIT:
            return (fixed + queues, 0, slots,
                    cg._with_pq_words(held, pq_words))
        return fixed, 0, slots, cg._with_pq_words(held + queues // 4,
                                                  pq_words)
    held, slots = (cg._pow2_at_least(2 * (ef + cand_cap)),
                   cg._pow2_at_least(2 * tm))
    base = 4 * (-(-dims // 4) * 4) + 16 * (ef + cand_cap) + 24 * tm + 32
    pq_smem, pq_words, _ = cg._pq_place(pq, t, max_m, base)
    base += pq_smem
    tables = 4 * held + 8 * slots
    if base + tables <= cg.SMEM_LIMIT:
        return base + tables, held, slots, pq_words
    return base, 0, 0, pq_words


@pytest.mark.parametrize("t,max_m,dims,stage,want", [
    (8, 32, 128, INT8, 32768 + 1024),    # the smoke's int8 records at T = 8
    (4, 32, 128, INT8, 16384 + 512),
    (4, 32, 128, BF16, 32768),
    (1, 16, 32, INT8, 512 + 64),         # the integer fixture's
    (8, 16, 32, BF16, 8192),
    (3, 8, 6, BF16, 288),                # 96 B a record
    (5, 4, 4, INT8, 80 + 80),            # 16 B a record and its scales
    (7, 4, 12, cg.RecordsStage(1, False, True), 7 * 48),
    (8, 32, 128, INT8_ROWS, 32768 + 1024),   # config 1's rows: a record's
    (4, 32, 128, INT8_ROWS, 16384 + 512),    # bytes at the same shape
    (4, 32, 128, BF16_ROWS, 32768),
    (8, 32, 128, BF16_ROWS, 65536),
])
def test_records_place_takes_exactly_the_records(t, max_m, dims, stage,
                                                 want):
    """T maxM D elements of the records (or of T maxM slots' rows), plus
    an int8 source's T maxM float32 scales, each rounded up to 16 bytes
    (already whole 16-byte chunks where the alignment holds), where there
    is room."""
    rows = -(-t * max_m * dims * stage.itemsize // 16) * 16
    scales = -(-t * max_m * 4 // 16) * 16 if stage.scales else 0
    assert rows + scales == want
    assert cg._records_place(stage, t, max_m, dims, 0, 1) == (want, True)


@pytest.mark.parametrize("case", [
    "maxM 6, D 5, int8", "maxM 6, D 5, bf16", "int8 scales of 24 B",
    "region at 8", "unaligned bases", "past the room", "no source",
    "rows of D 100 int8", "rows of D 4 bf16", "rows region at 8",
    "rows unaligned base", "bf16 rows at T=8 beside 13,856 B",
])
def test_records_place_refuses(case):
    """Where the bulk copy's 16-byte alignment fails (a record's bytes, an
    int8 record's scales, a rows source's row bytes, the region, the
    tensors' bases), past the room a block has, where an SM would hold
    fewer blocks (bf16 rows at T = 8 beside config 1's 13,856 B: 2 of 4),
    and for the other sources: no staging, no bytes.  A row of D = 100
    int8 or D = 4 bf16 is no whole 16-byte chunk, though records of 32
    such rows are."""
    args = {"maxM 6, D 5, int8": (INT8, 8, 6, 5, 0, 1),
            "maxM 6, D 5, bf16": (BF16, 8, 6, 5, 0, 1),
            "int8 scales of 24 B": (INT8, 8, 6, 16, 0, 1),
            "region at 8": (INT8, 8, 32, 128, 0, 1),
            "unaligned bases": (cg.RecordsStage(1, True, False), 8, 32, 128,
                                0, 1),
            "past the room": (BF16, 8, 32, 128, cg.SMEM_LIMIT - 65535, 1),
            "no source": (None, 8, 32, 128, 0, 1),
            "rows of D 100 int8": (INT8_ROWS, 8, 32, 100, 0, 1),
            "rows of D 4 bf16": (BF16_ROWS, 8, 32, 4, 0, 1),
            "rows region at 8": (INT8_ROWS, 8, 32, 128, 0, 1),
            "rows unaligned base": (cg.RecordsStage(1, True, False, True), 8,
                                    32, 128, 0, 1),
            "bf16 rows at T=8 beside 13,856 B": (BF16_ROWS, 8, 32, 128,
                                                 13856, 4)}[case]
    stage, t, max_m, dims, used, blocks = args
    at = 8 if case.endswith("region at 8") else None
    assert cg._records_place(stage, t, max_m, dims, used, blocks, at) == (
        0, False)
    if case.endswith("region at 8"):
        assert cg._records_place(stage, t, max_m, dims, used, 1, 16)[1]
    if case.startswith("rows of"):
        assert cg._records_place(stage._replace(rows=False), t, max_m, dims,
                                 used, blocks)[1]


def test_records_place_keeps_the_blocks_an_sm():
    """The staging never lowers the blocks an SM holds below what the
    layout without it holds (up to the instance's register-bound
    residency): bf16 at T = 8 beside config 1's 13,856 B would leave 2
    blocks an SM of 4, and is not staged; int8 keeps 4, bf16 at T = 4
    keeps 5.  Where the rest of the layout already holds fewer blocks,
    staging that keeps that count is taken."""
    assert cg._blocks_by_smem(13856 + 65536) == 2
    assert cg._records_place(BF16, 8, 32, 128, 13856, 4) == (0, False)
    assert cg._records_place(BF16, 8, 32, 128, 13856, 2) == (65536, True)
    assert cg._records_place(INT8, 8, 32, 128, 13856, 4) == (33792, True)
    assert cg._blocks_by_smem(13856 + 33792) == 4
    assert cg._records_place(BF16, 4, 32, 128, 8736, 5) == (32768, True)
    assert cg._blocks_by_smem(8736 + 32768) == 5
    # a block the SM holds once already: anything that still fits
    assert cg._blocks_by_smem(150_000) == 1
    assert cg._records_place(BF16, 8, 32, 128, 150_000, 4) == (65536, True)


@pytest.mark.parametrize("t", [4, 8])
def test_smoke_and_card_shapes(t):
    """Config 1's walks (ef = cand_cap = 64, maxM 32, D 128): int8 records
    and rows are staged at T = 4 and 8 (25,632 and 47,648 B a block:
    13,856 + 32,768 + 1,024 at T = 8, still 4 blocks an SM), bf16 at T = 4
    (41,504 B, 5 blocks an SM) but not at T = 8 (it would hold 2): its
    block is the f32 rows' 13,856 B.  No device memory either way."""
    smem, held, slots = F32_LAYOUT[t]
    assert cg._walk_layout(64, 64, t, 32, 128, None) == F32_LAYOUT[t]
    want = {(4, 1): 16384 + 512, (8, 1): 32768 + 1024, (4, 2): 32768,
            (8, 2): 0}
    for stage in (INT8, BF16, INT8_ROWS, BF16_ROWS):
        staged = want[t, stage.itemsize]
        assert cg.records_staging(64, 64, t, 32, 128, stage) == staged
        assert cg._walk_layout(64, 64, t, 32, 128, None, stage) == (
            smem + staged, held, slots)
        assert cg._walk_wide_words(64, 64, t, 32, 128, 10**6, True,
                                   None) == 0
    assert F32_LAYOUT[8][0] + want[8, 1] == 13856 + 32768 + 1024 == 47648
    assert cg._blocks_by_smem(47648) == 4
    assert cg._blocks_by_smem(8736 + 32768) == 5


def test_integer_fixture_shapes():
    """The integer fixture's walks (maxM 16, D 32) stage both records
    sources and both rows sources at T 1 / 4 / 8 and (ef, cand_cap) (16,
    16) and (64, 128), and in the wide instance at (5120, 5120), T = 4
    (the card tests' and the smoke's cases); at T = 256, (256, 256) the
    256 popped records or 4,096 slots' rows do not fit beside the queues
    and tables, and the walk reads the records or rows."""
    for stage in (INT8, BF16, INT8_ROWS, BF16_ROWS):
        for t in (1, 4, 8):
            for ef, cap in ((16, 16), (64, 128)):
                assert cg.records_staging(ef, cap, t, 16, 32, stage) > 0
        assert cg.records_staging(5120, 5120, 4, 16, 32, stage) == (
            4 * 16 * 32 * stage.itemsize + (256 if stage.scales else 0))
        assert cg.records_staging(256, 256, 256, 16, 32, stage) == 0


@pytest.mark.parametrize("ef,cap,t,max_m,dims", [
    (64, 64, 8, 32, 128), (64, 64, 4, 32, 128), (16, 16, 1, 16, 32),
    (320, 320, 8, 32, 128), (320, 320, 8, 32, 52_000), (16, 48, 3, 7, 30),
    (321, 64, 8, 32, 128), (5120, 5120, 8, 32, 128), (5120, 5120, 4, 16, 32),
    (8191, 8191, 8, 32, 128), (13854, 13854, 8, 32, 128),
    (16384, 16384, 8, 32, 128), (256, 256, 256, 16, 32),
])
@pytest.mark.parametrize("source", ["f32", "pq l2", "pq cosine", "int8",
                                    "bf16", "int8 rows", "bf16 rows",
                                    "f32 records"])
def test_other_sources_keep_their_layout(ef, cap, t, max_m, dims, source):
    """Every source's layout without staging is the layout before it, byte
    for byte (shared memory, tables, device words); a staged source's
    (int8 / bf16 records or rows, float32 records' ring) differs only by
    its staged bytes, after everything else (none in the wide
    instances for the ring)."""
    pq = {"pq l2": cg.PqTable(16, 0), "pq cosine": cg.PqTable(16, 1)}.get(
        source) if dims % 16 == 0 else None
    stage = {"int8": INT8, "bf16": BF16, "int8 rows": INT8_ROWS,
             "bf16 rows": BF16_ROWS,
             "f32 records": ring(t, max_m)}.get(source)
    rows = 1_000_003
    for dense in (True, False):
        old = _old_walk_plan(ef, cap, t, max_m, dims, pq, rows, dense)
        # the fifth figure: no visited set in shared memory (none asked)
        assert cg._walk_plan(ef, cap, t, max_m, dims, pq, rows,
                             dense) == (*old, False)
        got = cg._walk_plan(ef, cap, t, max_m, dims, pq, rows, dense, stage)
        staged = cg.records_staging(ef, cap, t, max_m, dims, stage)
        assert got == (old[0] + staged, *old[1:], False)
        assert got[0] <= cg.SMEM_LIMIT
        if source == "f32 records" and max(ef, cap) > cg.MAX_WALK_QUEUE:
            assert staged == 0


def test_constants_match_the_kernel():
    """The figures _records_place shares with csrc/beam_walk.cu are the
    kernel's: a block's shared-memory limit, the blocks an SM each table
    instance (by block size) and the wide instances must hold, the block
    size by T maxM, and records_place's unit of alignment (a row for a
    rows source, a record else; a record's scales only for records)."""
    path = os.path.join(os.path.dirname(cg.__file__), "..", "csrc",
                        "beam_walk.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src)[1])
    assert const("kWideMinBlocks") == cg.WIDE_MIN_BLOCKS
    assert const("kSmemLimit") == cg.SMEM_LIMIT
    m = re.search(r"kMinBlocks = kThreads == 128 \? (\d+) : (\d+);", src)
    assert {128: int(m[1]), 256: int(m[2])} == cg.WALK_MIN_BLOCKS
    assert "return T * maxM <= 128 ? 128 : 256;" in src
    assert cg._walk_threads(4, 32) == 128 and cg._walk_threads(5, 32) == 256
    assert "const size_t unit = (size_t)(rows || ring ? 1 : maxM) * D * " \
        "elem_bytes;" in src
    assert "if (unit % 16 || (scales && !rows && maxM * 4 % 16) || at % 16)" \
        in src
    for rows in (True, False):
        for dims, ok in ((16, True), (100, rows is False), (4, not rows)):
            stage = cg.RecordsStage(1, True, True, rows)
            assert cg._records_place(stage, 1, 4, dims, 0, 1)[1] == ok
    # vis_place: a visited set after every other part, from the next
    # 16-byte boundary, its words rounded up to 16 bytes, within the limit
    # (_visited_place's figures), placed after the staged rows
    assert "  const size_t at = round16(used);\n" \
        "  const size_t bytes = at - used + round16(4 * words);\n" \
        "  if (used + bytes > (size_t)kSmemLimit) return {0, 0};\n" in src
    assert "const VisPlace vis = vis_place(vis_words, used + rec.smem);" \
        in src
    assert "const VisPlace vis = vis_place(vis_words, base + rec.smem);" \
        in src
    # the kernel finds a shared set after the layout's other parts: past
    # the slot table, a PQ source's part and the staged rows, from a
    # 16-byte boundary, as vis_place lays it out
    assert "      size_t at = region - smem;\n" \
        "      if constexpr (is_pq(kElem))\n" \
        "        at += pq_region_bytes<kElem>(src, metric, T, maxM);\n" \
        "      if constexpr (is_staged(kElem))\n" \
        "        at += rec_stage_bytes(elem_type(kElem) == kElemI8 ? 1 : 2,\n" \
        "                              elem_type(kElem) == kElemI8, T, maxM, " \
        "D);\n" \
        "      if constexpr (is_ring(kElem)) at += (size_t)src.ring * D * 4;\n" \
        "      vis = reinterpret_cast<int*>(smem + round16(at));\n" in src
    # the float32 records ring: whole rows of D floats, as many as the
    # shared bytes count past the unstaged layout, none in the wide
    # instances (_records_place's ring, _walk_plan)
    assert "  const size_t bytes = ring ? (size_t)ring * unit\n" in src
    assert "    if (rec_ring) rec_elem = 0;\n" in src
    assert "    const size_t ring = ((size_t)smem_bytes - lay.smem) / " \
        "((size_t)D * 4);\n" in src
    for used in (13856, 13860, cg.SMEM_LIMIT - 32):
        pad = -(-used // 16) * 16 - used
        want = (pad + 32, True) if used + pad + 32 <= cg.SMEM_LIMIT else (
            0, False)
        assert cg._visited_place(7, used, 0) == want


def _graph(n=40, d=32, max_m=4, seed=3):
    rng = np.random.default_rng(seed)
    return graph_from_numpy(
        rng.integers(-8, 9, size=(n, d)).astype(np.float32),
        rng.integers(-1, n, size=(n, max_m)).astype(np.int32),
        np.full(n, max_m, np.int32), np.zeros(n, bool), n, device="cpu")


def test_walk_source_carries_the_stage():
    """_check_walk_args gives int8 and bf16 records and rows their staging
    (element bytes, int8 scales, the bases' alignment, records or rows),
    float32 records their ring (at most T maxM rows), and every other
    source none; a records or rows view whose base is 8 bytes off 16 is
    not aligned; a rows source's scales need no 16-byte base (they are
    copied 4 bytes at a time)."""
    g = _graph()
    q = torch.zeros((3, 32))
    walk = (q, 16, 16, 4, 0)
    n, max_m = g.capacity, g.max_m
    assert cg._check_walk_args(g, *walk).stage is None
    i8 = pack_records(g.vectors.to(torch.int8), g.links)
    sc = torch.ones((n, max_m))
    src = cg._check_walk_args(g, *walk, records=i8, pscales=sc)
    assert src.stage == cg.RecordsStage(1, True, True)
    bf = pack_records(g.vectors, g.links, torch.bfloat16)
    assert cg._check_walk_args(g, *walk, records=bf).stage == BF16
    f32 = pack_records(g.vectors, g.links, torch.float32)
    assert cg._check_walk_args(g, *walk, records=f32).stage == ring(4, max_m)
    assert cg._check_walk_args(g, q, 16, 16, 2, 0,
                               records=f32).stage.ring == 2 * max_m
    qv = g.vectors.to(torch.int8)
    assert cg._check_walk_args(g, *walk, qvectors=qv,
                               qscale=torch.ones(n)).stage == INT8_ROWS
    sc = torch.ones(n + 1)[1:]
    assert sc.data_ptr() % 16 == 4
    assert cg._check_walk_args(g, *walk, qvectors=qv,
                               qscale=sc).stage == INT8_ROWS
    qbuf = torch.zeros(qv.numel() + 8, dtype=torch.int8)
    qoff = qbuf[8:].view(qv.shape)
    assert qoff.data_ptr() % 16 == 8
    assert not cg._check_walk_args(g, *walk, qvectors=qoff,
                                   qscale=torch.ones(n)).stage.aligned
    gb = dataclasses.replace(g, vectors=g.vectors.to(torch.bfloat16))
    assert cg._check_walk_args(gb, *walk).stage == BF16_ROWS
    assert cg._check_walk_args(gb, *walk, records=f32).stage == ring(4, max_m)
    fbuf = torch.zeros(f32.numel() + 2)
    foff = fbuf[2:].view(f32.shape)
    assert foff.data_ptr() % 16 == 8
    assert cg._check_walk_args(g, *walk, records=foff).stage == ring(
        4, max_m, aligned=False)
    buf = torch.zeros(bf.numel() + 4, dtype=torch.bfloat16)
    off = buf[4:].view(bf.shape)
    assert off.data_ptr() % 16 == 8 and off.is_contiguous()
    assert not cg._check_walk_args(g, *walk, records=off).stage.aligned


# config 1's float32 records ring at T = 4: its rows (the most that keep 5
# blocks an SM) and the bytes of the block with it
RING_ROWS, RING_BLOCK = 71, 45088


def test_ring_at_config_1():
    """Config 1's float32 records walk at T = 4 (ef = cand_cap = 64, maxM
    32, D 128: a 128-thread block) keeps a ring of 71 rows (36,352 B beside
    8,736: 5 blocks an SM), the most that keep the f32 layout's blocks:
    one row more would cost one (45,600 B a block: 46,720 with its reserve
    in the runtime's 128-byte units, 4 an SM).  The ring comes after every
    other part, so the tables keep their slots and no device memory is
    taken; a shared visited set beside it (the API's hash set, 32,768 B)
    would cost a block, so it stays in device memory."""
    smem, held, slots = F32_LAYOUT[4]
    assert cg.records_staging(64, 64, 4, 32, 128, ring(4)) == RING_ROWS * 512
    assert cg._walk_layout(64, 64, 4, 32, 128, None, ring(4)) == (
        RING_BLOCK, held, slots)
    assert RING_BLOCK == smem + RING_ROWS * 512
    assert cg._walk_plan(64, 64, 4, 32, 128, None, 10**6, True,
                         ring(4)) == (RING_BLOCK, held, slots, 0, False)
    assert cg._walk_threads(4, 32) == 128 and cg.WALK_MIN_BLOCKS[128] == 5
    assert cg._blocks_by_smem(smem) >= 5
    assert cg._blocks_by_smem(RING_BLOCK) == 5
    assert cg._blocks_by_smem(RING_BLOCK + 512) == 4
    assert cg._walk_plan(64, 64, 4, 32, 128, None, 10**6, False, ring(4),
                         8192) == (RING_BLOCK, held, slots, 0, False)


def test_ring_is_for_128_thread_blocks():
    """At T = 8 (T maxM = 256: a 256-thread block, whose 64 registers spill
    into the L1 a ring's bytes take) the rule places no ring: config 1's
    block keeps the f32 layout's 13,856 B and reads the records.  A forced
    placement (no residency to keep: ``min_blocks`` 0) places one all the
    same, up to the step's 256 rows; at maxM 16 (the integer fixture) T =
    8 is a 128-thread block again and takes its ring."""
    assert cg._walk_threads(8, 32) == 256
    assert cg.records_staging(64, 64, 8, 32, 128, ring(8)) == 0
    assert cg._walk_layout(64, 64, 8, 32, 128, None, ring(8)) == F32_LAYOUT[8]
    assert cg._records_place(ring(8), 8, 32, 128, 13856, 4) == (0, False)
    assert cg._records_place(ring(8), 8, 32, 128, 13856, 0) == (256 * 512,
                                                                True)
    assert cg.records_staging(64, 128, 8, 16, 32, ring(8, 16)) == 128 * 128


@pytest.mark.parametrize("case", ["D=130", "misaligned base", "region at 8",
                                  "wide queues", "ef=321", "costs a block",
                                  "no room"])
def test_ring_refuses(case):
    """No ring, and no bytes, where a row of D floats is no whole 16-byte
    chunks (D = 130: 520 B), the records' base or the region is not
    16-aligned, the queues take the wide instances (they keep no ring),
    where even one row would cost an SM a block, or where no row fits the
    block."""
    if case == "D=130":
        assert cg._records_place(ring(4), 4, 32, 130, 0, 5) == (0, False)
        assert cg.records_staging(64, 64, 4, 32, 130, ring(4)) == 0
        assert cg.records_staging(64, 64, 4, 32, 132, ring(4)) > 0
    elif case == "misaligned base":
        assert cg._records_place(ring(4, aligned=False), 4, 32, 128, 8736,
                                 5) == (0, False)
        assert cg.records_staging(64, 64, 4, 32, 128,
                                  ring(4, aligned=False)) == 0
    elif case == "region at 8":
        assert cg._records_place(ring(4), 4, 32, 128, 8736, 5, 8) == (
            0, False)
        assert cg._records_place(ring(4), 4, 32, 128, 8736, 5, 16)[1]
    elif case in ("wide queues", "ef=321"):
        ef, cap = (5120, 5120) if case == "wide queues" else (321, 64)
        for t in (4, 8):
            assert cg.records_staging(ef, cap, t, 32, 128, ring(t)) == 0
            assert cg._walk_plan(ef, cap, t, 32, 128, None, 10**6, True,
                                 ring(t)) == cg._walk_plan(
                ef, cap, t, 32, 128, None, 10**6, True)
    elif case == "costs a block":
        # 45,568 B a block: 5 an SM; 512 B more would leave 4
        assert cg._blocks_by_smem(45_568) == 5
        assert cg._blocks_by_smem(46_080) == 4
        assert cg._records_place(ring(4), 4, 32, 128, 45_568, 5) == (
            0, False)
        assert cg._records_place(ring(4), 4, 32, 128, 45_568, 0) == (
            128 * 512, True)
    else:
        assert cg._records_place(ring(4), 4, 32, 128,
                                 cg.SMEM_LIMIT - 496, 0) == (0, False)
        assert cg._records_place(ring(4), 4, 32, 128,
                                 cg.SMEM_LIMIT - 512, 0) == (512, True)


@pytest.mark.parametrize("cap_rows,want", [(None, 128), (71, 71),
                                           (64, 64), (32, 32), (1, 1)])
def test_ring_holds_at_most_its_rows(cap_rows, want):
    """With no residency to keep the ring takes every row a step can
    process (T maxM: 128 at T = 4) where they fit, and never more than
    the source's ``ring`` (a probe's or a test's smaller ring); keeping 5
    blocks an SM, at most 71."""
    stage = ring(4) if cap_rows is None else ring(4)._replace(ring=cap_rows)
    assert cg._records_place(stage, 4, 32, 128, 8736, 0) == (want * 512,
                                                             True)
    assert cg._records_place(stage, 4, 32, 128, 8736, 5) == (
        min(want, RING_ROWS) * 512, True)


def _c_ring_rows(smem: int, unstaged: int, dims: int) -> int:
    """csrc/beam_walk.cu's beam_walk: the ring's rows from the shared bytes
    a launch passes, past the unstaged layout (a shared set's bytes in
    both), whole rows of D floats."""
    return (smem - unstaged) // (4 * dims) if smem > unstaged else 0


@pytest.mark.parametrize("ef,cap,t,max_m,dims,visited", [
    (64, 64, 4, 32, 128, 0), (64, 64, 2, 32, 128, 0),
    (16, 16, 1, 16, 32, 0), (64, 128, 4, 16, 32, 0), (64, 128, 8, 16, 32, 0),
    (64, 128, 8, 16, 32, 94), (16, 16, 1, 16, 32, 94),
    (64, 128, 4, 16, 32, 8192), (8, 8, 2, 4, 8, 16),
])
def test_ring_rows_follow_from_the_launch_bytes(ef, cap, t, max_m, dims,
                                                visited):
    """The rows the kernel reads from the launch's shared bytes are the
    rows _records_place chose: the ring's bytes are whole rows, and a
    visited set kept in shared memory after it moves by the ring's bytes
    alone (the ring starts and ends 16-aligned), so the unstaged layout
    with the same set (the C side's first layout) is the launch's less
    the ring."""
    stage = ring(t, max_m)
    smem, _, _, _, shared = cg._walk_plan(ef, cap, t, max_m, dims, None,
                                          3000, visited == 0, stage,
                                          visited)
    rows = cg.records_staging(ef, cap, t, max_m, dims, stage) // (4 * dims)
    if shared:
        # the set's bytes, placed right after the tables, 16-aligned there
        unstaged = cg._walk_smem_bytes(ef, cap, t, max_m, dims, None)
        unstaged += cg._visited_place(visited, unstaged, 0)[0]
    else:
        unstaged = cg._walk_smem_bytes(ef, cap, t, max_m, dims, None)
    assert rows >= 1
    assert _c_ring_rows(smem, unstaged, dims) == rows
    assert smem == unstaged + rows * 4 * dims
    # a figure between two whole rows is no layout: the C side refuses it
    assert _c_ring_rows(smem + 16, unstaged, dims) == rows
