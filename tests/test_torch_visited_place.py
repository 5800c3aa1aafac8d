"""Where the walk keeps a bitmap or hash visited set (csrc/beam_walk.cu's
vis_place, ops/cuda_graph._visited_place): in the block's shared memory
after every other part of a table instance's layout, from a 16-byte
boundary, where it fits and an SM keeps its blocks, else in device memory
filled by the wrapper.  On the CPU: the placement at config 1's shapes and
the integer fixture's, the residency rule over a grid of shapes, the
layout with and without the set (nothing else moves), the device words the
launch's chunking counts, and the wrapper's device set as the twin starts
it.  Nothing here needs the card: the walks in either placement are held
to the twin bit for bit in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch.convert import graph_from_numpy
from pg_embedding_tpu_torch.ops import cuda_graph as cg

INT8 = cg.RecordsStage(1, True, True)
BF16_ROWS = cg.RecordsStage(2, False, True, True)
# the API's hash set (HnswIndex._visited_slots) at ef 64 and 128, maxM 32
HASH_EF64, HASH_EF128 = 8192, 16384


def _bitmap_words(rows):
    return -(-rows // 32)


def _set_bytes(ef, cap, t, max_m, dims, pq, stage, words):
    """The shared bytes _walk_plan gives a visited set of ``words`` (0: it
    stays in device memory), checked against the placement it names."""
    got = cg._walk_plan(ef, cap, t, max_m, dims, pq, 10**6, False, stage,
                        words)
    without = cg._walk_plan(ef, cap, t, max_m, dims, pq, 10**6, False,
                            stage)
    assert got[4] == (got[0] > without[0]) and not without[4]
    return got[0] - without[0]


def _blocks_kept(ef, cap, t, max_m, dims, words, stage=None):
    """(blocks an SM holds of the block with the set, without it, the
    instance's register-bound residency)."""
    without = cg._walk_smem_bytes(ef, cap, t, max_m, dims, None, stage)
    with_set = cg._walk_smem_bytes(ef, cap, t, max_m, dims, None, stage,
                                   words)
    return (cg._blocks_by_smem(with_set), cg._blocks_by_smem(without),
            cg.WALK_MIN_BLOCKS[cg._walk_threads(t, max_m)])


@pytest.mark.parametrize("t,smem,blocks,shared", [(1, 4896, 5, True),
                                                  (4, 8736, 5, False),
                                                  (8, 13856, 4, True)])
def test_hash_set_shared_at_ef_64(t, smem, blocks, shared):
    """Config 1's walk (ef = cand_cap = 64, maxM 32, D 128, float32 rows)
    under the API's hash set at ef 64 (8,192 slots, 32,768 B): at T = 1
    and 8 shared, after the layout's own bytes (already 16-aligned), an
    SM holding as many blocks as without it (T = 8: 46,624 B, 4 blocks,
    190,592 B an SM with their reserve); at T = 4 it would keep the SM's
    5 blocks too, but they would take 212,640 B of its shared memory, past
    SET_SM_SMEM (28 KB of L1 left; measured slower): device memory."""
    assert cg._walk_smem_bytes(64, 64, t, 32, 128, None) == smem
    assert _set_bytes(64, 64, t, 32, 128, None, None, HASH_EF64) == (
        32768 if shared else 0)
    with_set = smem + 32768 + cg.BLOCK_RESERVED
    got, _, keep = _blocks_kept(64, 64, t, 32, 128, HASH_EF64)
    kept = min(keep, cg._blocks_by_smem(smem))
    assert kept == blocks
    assert (kept * with_set <= cg.SET_SM_SMEM) == shared
    assert cg._blocks_by_smem(with_set - cg.BLOCK_RESERVED) >= kept
    assert cg._walk_layout(64, 64, t, 32, 128, None, None, HASH_EF64)[1:] \
        == cg._walk_layout(64, 64, t, 32, 128, None)[1:]


def test_hash_set_in_device_memory_at_ef_128():
    """At ef = cand_cap = 128, T = 8 the API's 16,384 slots (65,536 B)
    would leave 2 blocks an SM of 4: the set stays in device memory, and
    the block's bytes are the layout's without it."""
    smem = cg._walk_smem_bytes(128, 128, 8, 32, 128, None)
    assert cg._blocks_by_smem(smem + 65536) == 2
    assert _set_bytes(128, 128, 8, 32, 128, None, None,
                      HASH_EF128) == 0
    assert cg._walk_smem_bytes(128, 128, 8, 32, 128, None, None,
                               HASH_EF128) == smem


@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("rows,shared", [(100_000, 12512), (100_256, 12544),
                                         (131_072, 16384), (1_000_000, 0),
                                         (1 << 20, 0)])
def test_bitmap_by_rows(t, rows, shared):
    """The bitmap (a bit an id of the graph's capacity): shared at 100k
    rows (3,125 words, 12,500 B rounded up to 12,512; the probe's 100k-row
    index has capacity for 3,133 words, 12,532 B rounded up to 12,544) and
    at 2^17, in device memory at 1M (125,000 B would leave 1 block an
    SM)."""
    words = _bitmap_words(rows)
    assert _set_bytes(64, 64, t, 32, 128, None, None, words) == shared
    _, without, keep = _blocks_kept(64, 64, t, 32, 128, words)
    used = cg._walk_smem_bytes(64, 64, t, 32, 128, None)
    forced = cg._visited_place(words, used, 0)[0]
    assert forced >= 4 * words
    assert (cg._blocks_by_smem(used + forced) >= min(keep, without)) == (
        shared > 0)


@pytest.mark.parametrize("ef,cap", [(16, 16), (64, 128)])
@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("words,nbytes", [(94, 384), (HASH_EF64, 32768),
                                          (64, 256)])
def test_integer_fixture_sets_are_shared(ef, cap, t, words, nbytes):
    """The integer fixture (3,000 rows, maxM 16, D 32) over float32 rows:
    its bitmap (94 words), the 8,192-slot hash set and the 64-slot one are
    shared at every table shape the card tests walk but the 8,192-slot
    set at (64, 128) and T = 4 or 8 (5 blocks an SM of 40,000-odd bytes
    each, past SET_SM_SMEM), which is why those tests walk each set in the
    other placement, forced, too; beside a PQ table (G 8) or staged bf16
    records at T = 8 the hash set would cost an SM a block, and stays in
    device memory; the wide instances keep every set in device memory."""
    if words == HASH_EF64 and cap == 128 and t > 1:
        nbytes = 0
    assert _set_bytes(ef, cap, t, 16, 32, None, None, words) == nbytes
    assert _set_bytes(5120, 5120, t, 16, 32, None, None, words) == 0
    if t == 8 and words == HASH_EF64:
        for pq, stage in ((cg.PqTable(8, 0), None),
                          (None, cg.RecordsStage(2, False, True))):
            assert _set_bytes(ef, cap, t, 16, 32, pq, stage,
                              words) == 0


@pytest.mark.parametrize("t,max_m,dims", [(1, 32, 128), (4, 32, 128),
                                          (8, 32, 128), (8, 16, 32),
                                          (3, 7, 30), (16, 32, 960)])
def test_a_shared_set_never_costs_a_block(t, max_m, dims):
    """Over queue widths and set sizes from 4 slots to a 1M-row bitmap: a
    shared set fits the limit and leaves an SM as many blocks as without
    it (up to the instance's register-bound residency), and the blocks
    take at most SET_SM_SMEM with it; a set left in device memory would
    have passed the limit, cost a block or passed SET_SM_SMEM."""
    for ef, cap in ((16, 16), (40, 64), (64, 64), (128, 128), (320, 320)):
        for words in (4, 64, 94, 3125, 8192, 16384, 31250):
            shared = _set_bytes(ef, cap, t, max_m, dims, None, None,
                                words)
            got, without, keep = _blocks_kept(ef, cap, t, max_m, dims, words)
            used = cg._walk_smem_bytes(ef, cap, t, max_m, dims, None)
            kept = min(keep, without)
            if shared:
                assert got >= kept, (ef, cap, words)
                assert used + shared <= cg.SMEM_LIMIT
                assert shared >= 4 * words
                assert kept * (used + shared + cg.BLOCK_RESERVED) <= \
                    cg.SET_SM_SMEM
            else:
                forced = used + -(-used // 16) * 16 - used + \
                    -(-4 * words // 16) * 16
                assert (forced > cg.SMEM_LIMIT
                        or cg._blocks_by_smem(forced) < kept
                        or kept * (forced + cg.BLOCK_RESERVED)
                        > cg.SET_SM_SMEM), (ef, cap, words)


@pytest.mark.parametrize("used", [13856, 13864, 13860, 0, 232_448 - 64])
def test_visited_place_pads_to_16(used):
    """The set starts at the next 16-byte boundary past ``used`` (a hash
    bucket is one 16-byte load) and takes its words rounded up to 16
    bytes; none where that passes SMEM_LIMIT."""
    nbytes, shared = cg._visited_place(13, used, 0)
    pad = -(-used // 16) * 16 - used
    if used + pad + 64 > cg.SMEM_LIMIT:
        assert (nbytes, shared) == (0, False)
    else:
        assert (nbytes, shared) == (pad + 64, True)
    assert cg._visited_place(0, used, 0) == (0, False)


@pytest.mark.parametrize("ef,cap,t,max_m,dims", [
    (64, 64, 8, 32, 128), (64, 64, 4, 32, 128), (16, 48, 3, 7, 30),
    (320, 320, 320, 16, 32), (321, 64, 8, 32, 128), (5120, 5120, 4, 16, 32),
    (16384, 16384, 8, 32, 128)])
@pytest.mark.parametrize("stage", [None, INT8, BF16_ROWS])
def test_the_set_goes_last(ef, cap, t, max_m, dims, stage):
    """A shared set takes bytes after every other part of the layout, so
    the tables, the staged rows and the device words are what they are
    without it; the wide instances (queues past MAX_WALK_QUEUE) and a
    block whose tables do not fit (T = 320) take no set in shared memory
    past the limit, and at no other shape either where it does not fit."""
    for words in (64, 8192):
        old = cg._walk_plan(ef, cap, t, max_m, dims, None, 10**6, False,
                            stage)
        got = cg._walk_plan(ef, cap, t, max_m, dims, None, 10**6, False,
                            stage, words)
        shared = _set_bytes(ef, cap, t, max_m, dims, None, stage, words)
        assert got == (old[0] + shared, *old[1:4], shared > 0)
        if max(ef, cap) > cg.MAX_WALK_QUEUE:
            assert shared == 0


def _graph(n, d=32, max_m=16, seed=3):
    rng = np.random.default_rng(seed)
    return graph_from_numpy(
        rng.integers(-8, 9, size=(n, d)).astype(np.float32),
        rng.integers(-1, n, size=(n, max_m)).astype(np.int32),
        np.full(n, max_m, np.int32), np.zeros(n, bool), n, device="cpu")


@pytest.mark.parametrize("visited_slots", [-1, 0, 64, 8192])
@pytest.mark.parametrize("ef,t", [(16, 1), (64, 8), (5120, 4)])
def test_walk_launch_counts_device_words_by_placement(visited_slots, ef, t,
                                                      monkeypatch):
    """The launch's plan (_walk_launch, what beam_walk chunks a batch by):
    a shared set adds its bytes to the block and no device words; one in
    device memory (the wide instances', or one forced there) adds its
    words a query and no bytes; the dense dedupe neither."""
    g = _graph(3000)
    q = torch.zeros((4, 32))
    src = cg._check_walk_args(g, q, ef, ef, t, 0, visited_slots=visited_slots)
    wide = cg._walk_wide_words(ef, ef, t, g.max_m, 32, g.capacity,
                               visited_slots < 0, None)
    plain = cg._walk_smem_bytes(ef, ef, t, g.max_m, 32, None)
    words = cg._visited_words(g, visited_slots) if visited_slots >= 0 else 0
    rule = words > 0 and ef <= cg.MAX_WALK_QUEUE and cg._visited_place(
        words, plain, cg.WALK_MIN_BLOCKS[cg._walk_threads(t, g.max_m)])[1]
    for device in (False, True):
        if device:
            monkeypatch.setattr(cg, "_visited_place",
                                lambda words, used, min_blocks: (0, False))
        plan = cg._walk_launch(g, src, ef, ef, t, visited_slots)
        shared = rule and not device
        assert plan.visited_shared == shared
        if shared:
            assert plan.smem > plain and plan.words == wide
            assert plan.smem - plain == _set_bytes(
                ef, ef, t, g.max_m, 32, None, None, words)
            assert plan == (plan.smem, True, wide, 0)
        else:
            assert plan == (plain, False, wide, words)
            assert plan.words == wide + words


@pytest.mark.parametrize("visited_slots,words,first", [(0, 94, 1),
                                                       (8192, 8192, 0),
                                                       (4, 4, 0)])
@pytest.mark.parametrize("has_nodes", [True, False])
def test_device_set_starts_as_the_twins(visited_slots, words, first,
                                        has_nodes):
    """The wrapper's device set (what a block fills in shared memory the
    same way): the bitmap zeroed, the hash table -1, node 0 held (bit 0 of
    word 0, slot 0 of its bucket) where the graph has nodes."""
    got = cg._device_visited(3, words, visited_slots, has_nodes, "cpu")
    empty = 0 if visited_slots == 0 else -1
    want = torch.full((3, words), empty, dtype=torch.int32)
    if has_nodes:
        want[:, 0] = first
    assert got.dtype == torch.int32 and torch.equal(got, want)
