"""The PQ walk's distance table (csrc/beam_walk.cu's PQ row source) in its
plain form, on the CPU: ops/cuda_graph.pq_walk_table_plain builds each
query's table as the kernel's block does (entry (k, g): the metric's sum
over group g's elements of centroid k, from 0 in element order, each
operation rounded) and pq_walk_score_plain scores code rows by lookups in
the kernel's order (lane g sums groups g, g + 32, ..., the lanes meet in
the warp's butterfly); then the walk block's shared-memory figure with the
table (ops/cuda_graph._walk_layout / _walk_fixed / _walk_wide_words).

Tolerances: against the JAX package's pq_decode and dist_one_to_many on
the decoded rows, rtol 1e-5 (float32 sums in another order); against the
port's decode-then-distance on integer codebooks (every sum exact), bit
for bit; at D / G = 4 each entry is the lane partial the decoded row's
lane would sum, and a row's distance the decoded row's in the kernel's
lane order, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops import distance as jdist
from pg_embedding_tpu.ops import pq as jpq
from pg_embedding_tpu_torch.ops import cuda_graph as cg
from pg_embedding_tpu_torch.ops.distance import dist_one_to_many
from pg_embedding_tpu_torch.ops.pq import pq_decode

METRICS = {"l2": 0, "cosine": 1, "manhattan": 2}
B, N = 4, 40                 # queries, code rows a query


def _case(seed, dims, groups, integer=False):
    """(queries f32[B, D], codebook f32[G, 256, D / G], codes u8[B, N, G])
    from numpy: normal values, or integers in [-8, 8]."""
    rng = np.random.default_rng(seed)
    if integer:
        qs = rng.integers(-8, 9, size=(B, dims)).astype(np.float32)
        cb = rng.integers(-8, 9, size=(groups, 256, dims // groups)).astype(
            np.float32)
    else:
        qs = rng.normal(size=(B, dims)).astype(np.float32)
        cb = rng.normal(size=(groups, 256, dims // groups)).astype(np.float32)
    codes = rng.integers(0, 256, size=(B, N, groups)).astype(np.uint8)
    return qs, cb, codes


def _rotation(seed, dims):
    """An orthogonal rotation (OPQ's R) f32[D, D] from numpy's QR."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(dims,
                                                                 dims)))
    return q.astype(np.float32)


def _lookup(qs, cb, codes, metric):
    """The plain table and lookups on numpy operands: f32[B, N]."""
    q = torch.from_numpy(qs)
    table = cg.pq_walk_table_plain(q, torch.from_numpy(cb), metric)
    return cg.pq_walk_score_plain(table, torch.from_numpy(codes), metric,
                                  q).numpy()


@pytest.mark.parametrize("metric,rotated", [
    ("l2", False), ("cosine", False), ("manhattan", False),
    ("l2", True), ("cosine", True)])    # Manhattan refuses OPQ
@pytest.mark.parametrize("groups", [8, 16, 32, 64])
def test_table_scores_match_jax_decode(groups, metric, rotated):
    """The table's lookups against the JAX package's decode-then-distance
    (pq_decode, then dist_one_to_many on the decoded rows) at D = 128,
    under OPQ on the rotated query q @ R: rtol 1e-5."""
    qs, cb, codes = _case(groups, 128, groups)
    if rotated:
        qs = (qs.astype(np.float64) @ _rotation(groups + 1, 128)).astype(
            np.float32)
    m = METRICS[metric]
    got = _lookup(qs, cb, codes, m)
    rows = jpq.pq_decode(jnp.asarray(codes), jnp.asarray(cb))
    want = np.asarray(jax.vmap(lambda q, p: jdist.dist_one_to_many(q, p, m))(
        jnp.asarray(qs), rows))
    assert got.shape == want.shape == (B, N)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("groups", [4, 8, 16, 32])
def test_table_scores_bit_equal_on_integer_codebooks(groups, metric):
    """On integer codebooks and queries every entry and every sum is exact,
    so the lookups equal the port's decode-then-distance (the walk twin's
    form: ops/pq.pq_decode, ops/distance.dist_one_to_many) bit for bit at
    every group width D = 32 gives."""
    qs, cb, codes = _case(40 + groups, 32, groups, integer=True)
    m = METRICS[metric]
    got = _lookup(qs, cb, codes, m)
    want = dist_one_to_many(torch.from_numpy(qs), pq_decode(
        torch.from_numpy(codes), torch.from_numpy(cb)), m).numpy()
    np.testing.assert_array_equal(got, want)


def _lane_partial(c, q, metric):
    """One lane's partial over the elements of c and q (float32 numpy),
    summed as the kernel's accum: from 0, in order, each operation
    rounded to float32."""
    f = np.float32
    a, pp = f(0), f(0)
    for cj, qj in zip(c, q):
        if metric == 0:
            t = f(cj - qj)
            a = f(a + f(t * t))
        elif metric == 1:
            a = f(a + f(cj * qj))
            pp = f(pp + f(cj * cj))
        else:
            a = f(a + f(abs(f(cj - qj))))
    return a, pp


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("dims,groups", [(32, 8), (128, 32)])
def test_table_entry_is_the_lane_partial(dims, groups, metric):
    """At D / G = 4 lane c of the decoded row's walk sums elements [4c, 4c
    + 4), which are group c's: each table entry is that lane partial, bit
    for bit, so a row's lane partials, and with the same butterfly its
    distance, are the decoded row's."""
    qs, cb, _ = _case(7, dims, groups)
    m = METRICS[metric]
    table = cg.pq_walk_table_plain(torch.from_numpy(qs), torch.from_numpy(cb),
                                   m).numpy()
    rng = np.random.default_rng(1)
    for b in range(B):
        for k in rng.integers(0, 256, 8):
            for g in range(groups):
                a, pp = _lane_partial(cb[g, k], qs[b, 4 * g:4 * g + 4], m)
                entry = table[b, k, g]
                if m == 1:
                    assert (entry[0], entry[1]) == (a, pp)
                else:
                    assert entry == a


@pytest.mark.parametrize("metric", list(METRICS))
def test_lookup_distance_is_the_decoded_rows_in_lane_order(metric):
    """At G = 32, D = 128 a row's distance by lookups equals, bit for bit,
    the decoded row's in the kernel's order before the table (lane c: the
    4 elements of chunk c summed from 0; the butterfly; the verdict)."""
    qs, cb, codes = _case(11, 128, 32)
    m = METRICS[metric]
    got = _lookup(qs, cb, codes, m)
    rows = pq_decode(torch.from_numpy(codes), torch.from_numpy(cb)).numpy()
    for b in range(B):
        q = torch.from_numpy(qs[b:b + 1])
        for n in range(N):
            lanes = np.array([_lane_partial(rows[b, n, 4 * c:4 * c + 4],
                                            qs[b, 4 * c:4 * c + 4], m)
                              for c in range(32)], np.float32)
            a = cg._lane_tree_sum(torch.from_numpy(lanes[:, 0]))
            if m == 0:
                want = cg._sqrt(a)
            elif m == 2:
                want = a
            else:
                pp = cg._lane_tree_sum(torch.from_numpy(lanes[:, 1]))
                qq = cg._lane_tree_sum(q[0] * q[0])
                want = 1.0 - a * torch.rsqrt(torch.clamp(qq * pp,
                                                         min=1e-30))
            assert got[b, n] == want.item(), (b, n)


def test_lane_tree_sum_is_the_warp_butterfly():
    """_lane_tree_sum: lane l sums elements l, l + 32, ... from 0, then
    the lanes pair as the butterfly does (xor 16, then 8, 4, 2, 1)."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 70)).astype(np.float32))
    lanes = np.zeros((3, 32), np.float32)
    for i in range(70):
        lanes[:, i % 32] = lanes[:, i % 32] + x[:, i].numpy()
    for o in (16, 8, 4, 2, 1):
        lanes = np.array([[lanes[r, l] + lanes[r, l ^ o] for l in range(32)]
                          for r in range(3)], np.float32)
    np.testing.assert_array_equal(cg._lane_tree_sum(x).numpy(), lanes[:, 0])


# --- the walk block's shared memory with the table --------------------------

# the other sources' figures at the smoke's shapes (ef = cand_cap = 64;
# T = 4: 128-thread blocks, T = 8: 256; maxM 32, D 128): bytes, held-table
# slots, slot-table slots
F32_LAYOUT = {4: (8736, 256, 256), 8: (13856, 256, 512)}


@pytest.mark.parametrize("metric,groups", [
    ("l2", 16), ("l2", 32), ("cosine", 32), ("manhattan", 32), ("l2", 64),
    ("cosine", 64)])
@pytest.mark.parametrize("t", [4, 8])
def test_pq_source_adds_exactly_its_bytes(t, metric, groups):
    """A PQ source's layout is the other sources' (unchanged: F32_LAYOUT)
    plus its table, 256 x G floats (a float2 under cosine), and the step's
    staged codes, T maxM x G bytes: at the smoke's shapes both fit beside
    the hash tables, and nothing goes to device memory.  At G = 32 under
    L2 a T = 8 block is 54,816 bytes (4 of them an SM: 223,360 of 233,472
    with the 1 KB a block the card reserves) and a T = 4 one 45,600 (5:
    233,120)."""
    table = 256 * groups * (8 if metric == "cosine" else 4)
    pq = cg.PqTable(groups, METRICS[metric])
    assert cg._pq_place(pq, t, 32, 0) == (table + t * 32 * groups, 0,
                                             True)
    assert cg._walk_layout(64, 64, t, 32, 128, None) == F32_LAYOUT[t]
    smem, held, slots = F32_LAYOUT[t]
    pq_smem = table + t * 32 * groups
    assert cg._walk_layout(64, 64, t, 32, 128, pq) == (smem + pq_smem, held,
                                                       slots)
    assert cg._walk_smem_bytes(64, 64, t, 32, 128, pq) == smem + pq_smem
    assert cg._walk_wide_words(64, 64, t, 32, 128, 10**6, True, pq) == 0
    if (metric, groups) == ("l2", 32):
        assert smem + pq_smem == {4: 45600, 8: 54816}[t]
        blocks = {4: 5, 8: 4}[t]
        assert blocks * (smem + pq_smem + 1024) <= 233_472


def test_pq_codes_round_to_8_bytes():
    """The staged codes take T maxM G bytes rounded up to 8 (what follows
    them in the wide instances is 4-byte aligned queues)."""
    assert cg._pq_place(cg.PqTable(3, 0), 1, 3, 0)[0] == 256 * 3 * 4 + 16
    assert cg._pq_place(cg.PqTable(8, 2), 4, 32, 0)[0] == (256 * 8 * 4
                                                             + 1024)
    assert cg._pq_place(None, 8, 32, 0) == (0, 0, False)


def test_pq_table_in_the_wide_instances():
    """The wide instances put the table and the staged codes after the
    slot table and before the queues; the queues leave shared memory once
    they no longer fit beside them (device words: the held bits, then the
    queues)."""
    rows = 1_000_000
    held = -(-rows // 16)
    pq = cg.PqTable(32, 0)
    assert cg._pq_place(pq, 8, 32, 0) == (32768 + 8192, 0, True)
    assert cg._walk_fixed(8, 32, 128) == 10784
    queues = 8 * (5120 + 5120)
    assert cg._walk_layout(5120, 5120, 8, 32, 128, pq) == (
        10784 + 40960 + queues, 0, 512)
    assert cg._walk_wide_words(5120, 5120, 8, 32, 128, rows, True,
                               pq) == held
    # (8191, 8191) under L2: beside G = 64's 80 KB the queues fit, beside
    # G = 128's 160 KB they move to device memory
    queues = 8 * (8191 + 8192)
    for groups, fits in ((64, True), (128, False)):
        pq = cg.PqTable(groups, 0)
        pq_smem = 1280 * groups
        assert cg._pq_place(pq, 8, 32, 10784) == (pq_smem, 0, True)
        assert (10784 + pq_smem + queues <= cg.SMEM_LIMIT) == fits
        assert cg._walk_layout(8191, 8191, 8, 32, 128, pq) == (
            10784 + pq_smem + (queues if fits else 0), 0, 512)
        assert cg._walk_wide_words(8191, 8191, 8, 32, 128, rows, True,
                                   pq) == held + (0 if fits else queues // 4)
    assert cg._walk_wide_words(8191, 8191, 8, 32, 128, rows, True,
                               None) == held


def test_smoke_and_card_shapes_fit():
    """The shapes the smoke, the probe and the card tests walk PQ records
    at keep the table and the staged codes in shared memory: G 16 / 32 /
    64 at 1M x 128-d, T 4 / 8, ef 64 (L2; cosine at G 32), and the integer
    fixture's G 2-32 at D 32 and G 3 at D 24 (maxM 16) up to (5120, 5120)
    under every metric."""
    for groups, metric in ((16, 0), (32, 0), (32, 1), (64, 0)):
        for t in (4, 8):
            smem = cg._walk_smem_bytes(64, 64, t, 32, 128,
                                       cg.PqTable(groups, metric))
            assert smem == (F32_LAYOUT[t][0] + 256 * groups * (4 + 4 * metric)
                            + t * 32 * groups)
    for dims, groups in ((32, 2), (32, 4), (32, 8), (32, 16), (32, 32),
                         (24, 3)):
        for metric in (0, 1, 2):
            pq = cg.PqTable(groups, metric)
            for t, ef, cap in ((8, 64, 128), (4, 5120, 5120)):
                rest = cg._walk_smem_bytes(ef, cap, t, 16, dims, None)
                assert cg._walk_smem_bytes(ef, cap, t, 16, dims, pq) == (
                    rest + cg._pq_place(pq, t, 16, 0)[0])
                assert cg._walk_wide_words(ef, cap, t, 16, dims, 2000, True,
                                           pq) == cg._walk_wide_words(
                    ef, cap, t, 16, dims, 2000, True, None)


# wide rows (1536-d, T 8, maxM 32): where the table and the staged codes
# both fit a block, the table alone, or neither; (metric, G, ef = cand_cap)
# -> (shared bytes, held-table slots, slot-table slots, device words at 1M
# rows, dense dedupe).  The table instances' least part is 14,368 bytes
# and their hash tables 5,120; the wide ones' least part 16,416 and their
# queues 81,920 at 5120 (20,480 words), the held bits 62,500 words.
WIDE_ROWS = {
    ("cosine", 96, 64): (14368 + 196608 + 5120, 256, 512, 0),
    ("l2", 192, 64): (14368 + 196608 + 5120, 256, 512, 0),
    ("cosine", 192, 64): (14368 + 5120, 256, 512, 98304),
    ("l2", 384, 64): (14368 + 5120, 256, 512, 98304),
    ("cosine", 96, 5120): (16416 + 196608, 0, 512, 62500 + 20480),
    ("l2", 192, 5120): (16416 + 196608, 0, 512, 62500 + 20480),
    ("cosine", 192, 5120): (16416 + 81920, 0, 512, 62500 + 98304),
    ("l2", 384, 5120): (16416 + 81920, 0, 512, 62500 + 98304),
}


@pytest.mark.parametrize("metric,groups,ef", list(WIDE_ROWS))
def test_pq_table_placement_at_wide_rows(metric, groups, ef):
    """A PQ source never refuses a walk: at 1536-d, cosine at G = 96 and L2
    at G = 192 keep the table in shared memory and read each row's codes
    from the records (table and codes would pass SMEM_LIMIT), and cosine
    at G = 192 or L2 at G = 384 build the table in the query's device
    scratch, the walk's own words rounded up to 2 (8-aligned); the
    rest of the block is laid out as for any other source."""
    smem, held, slots, words = WIDE_ROWS[metric, groups, ef]
    pq = cg.PqTable(groups, METRICS[metric])
    assert cg._walk_layout(ef, ef, 8, 32, 1536, pq) == (smem, held, slots)
    assert cg._walk_wide_words(ef, ef, 8, 32, 1536, 10**6, True,
                               pq) == words
    table = 256 * groups * (8 if metric == "cosine" else 4)
    used = 16416 if ef > cg.MAX_WALK_QUEUE else 14368
    shared = used + table <= cg.SMEM_LIMIT
    assert cg._pq_place(pq, 8, 32, used) == (
        table if shared else 0, 0 if shared else table // 4, False)
    if ef > cg.MAX_WALK_QUEUE and not shared:
        assert cg._walk_wide_words(ef, ef, 8, 32, 1536, 10**6 + 16, True,
                                   pq) == words + 2     # 62,501 rounds to 2


@pytest.mark.parametrize("ef,cap", [(64, 64), (5120, 5120)])
def test_walk_past_the_limit_raises_for_every_source(ef, cap):
    """What refuses a walk is its least part past SMEM_LIMIT (the query
    row), as for the other sources; a PQ table never does: cosine at G =
    128 on 128-d (256 KB) is laid out in device memory."""
    for pq in (None, cg.PqTable(64, 0), cg.PqTable(128, 1)):
        cg._walk_layout(ef, cap, 8, 32, 128, pq)
        with pytest.raises(ValueError, match="232448"):
            cg._walk_layout(ef, cap, 8, 32, 60_000, pq)
    assert cg._walk_wide_words(ef, cap, 8, 32, 128, 1000, False,
                               cg.PqTable(128, 1)) >= 256 * 128 * 2


def test_walk_source_carries_the_pq_table():
    """_check_walk_args gives a PQ source its table (G and the metric,
    from which the layout derives its bytes) and every other source
    none."""
    from pg_embedding_tpu_torch.convert import graph_from_numpy
    rng = np.random.default_rng(4)
    n, d, max_m = 50, 32, 4
    g = graph_from_numpy(rng.normal(size=(n, d)).astype(np.float32),
                         rng.integers(0, n, size=(n, max_m)).astype(np.int32),
                         np.full(n, max_m, np.int32), np.zeros(n, bool), n,
                         device="cpu")
    q = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32))
    walk = (q, 16, 16, 4)
    for metric in (0, 1, 2):
        assert cg._check_walk_args(g, *walk, metric).pq is None
        for groups in (8, 16):
            src = cg._check_walk_args(
                g, *walk, metric,
                records=torch.zeros((n, max_m, groups), dtype=torch.uint8),
                pq_codebook=torch.zeros((groups, 256, d // groups)))
            assert src.pq == cg.PqTable(groups, metric)
