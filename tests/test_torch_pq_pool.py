"""The compressed sweep's coarse pool (ops/pq_sweep._pq_pool, the JAX
package's _pq_pool_impl) on the CPU: the kernel's plain twin
_pq_pool_plain against the JAX function at the pool level, before any
rerank; the PQ kernel's (csrc/pq_topk.cu) element rule and its staged
code windows rendered in torch, and its Manhattan sum's order; its shared
memory and launch shape (one query tile at every pool); its filter
(tests/pq_filter.py) and select (the radix select rendered in Python, and
the plain select) against the plain pool, a segment's overflow and the
rerun of its query; the wrapper's routing by device and metric.

Data: integer codebooks whose 256 centroids in a group are signed
permutations of 1 .. sub, so every decoded row has the same norm, and
integer queries (OPQ: a signed permutation).  Every score is then exact
in float32 in both packages, rows with equal products tie exactly (the
lower id first in both), and unequal cosines lie ~1e-4 apart, far past
either package's rsqrt: ids are held equal, distances at rtol 1e-5."""

import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops.pq_sweep import _pq_pool_impl as jax_pool
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
from pg_embedding_tpu_torch.ops import pq_sweep
from pg_embedding_tpu_torch.ops.pq import pq_decode

N, B = 3000, 16
# rows past n_valid inside the last 128-row tile; a chunk that does not
# divide N
N_VALID, CHUNK = N - 37, 1024
METRICS = {"l2": 0, "cosine": 1, "manhattan": 2}
# (G, D): sub = 16, 8 and 6 (6 does not divide the kernel's 64-dim step)
GROUPS = {4: 64, 8: 64, 12: 72}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def equal_norm_case(seed, groups, dims, n=N, b=B):
    """(codes u8[n, G], codebook f32[G, 256, sub], queries f32[b, D],
    signed permutation f32[D, D], tombstones bool[n]): each centroid a
    signed permutation of 1 .. sub, queries integers in [-4, 4]."""
    rng = np.random.default_rng(seed)
    sub = dims // groups
    base = np.arange(1, sub + 1, dtype=np.float32)
    book = np.stack([[rng.permutation(base) * rng.choice([-1, 1], sub)
                      for _ in range(256)] for _ in range(groups)])
    codes = rng.integers(0, 256, size=(n, groups)).astype(np.uint8)
    qs = rng.integers(-4, 5, size=(b, dims)).astype(np.float32)
    rot = np.zeros((dims, dims), np.float32)
    rot[np.arange(dims), rng.permutation(dims)] = rng.choice([-1, 1], dims)
    dead = rng.random(n) < 0.05
    return codes, book.astype(np.float32), qs, rot, dead


@pytest.mark.parametrize("pool", [16, 64, 256, 1024])
@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_pool_plain_matches_jax(metric, groups, pool):
    """_pq_pool_plain against the JAX _pq_pool_impl on the same inputs,
    rows past n_valid and tombstones masked, a chunk that does not divide
    N (the JAX function takes codes padded to whole chunks), OPQ's rotation
    for L2 and cosine at pools 64 and 1024: ids equal, distances at rtol
    1e-5."""
    dims = GROUPS[groups]
    codes, book, qs, rot, dead = equal_norm_case(pool + groups, groups, dims)
    rotation = rot if metric != "manhattan" and pool in (64, 1024) else None
    n_pad = -(-N // CHUNK) * CHUNK
    jd, ji = jax_pool(
        jnp.asarray(qs), jnp.asarray(np.pad(codes, ((0, n_pad - N), (0, 0)))),
        jnp.asarray(book), None if rotation is None else jnp.asarray(rotation),
        jnp.asarray(N_VALID, jnp.int32), jnp.asarray(np.pad(dead,
                                                            (0, n_pad - N))),
        pool=pool, metric_value=METRICS[metric], chunk=CHUNK)
    td, ti = pq_sweep._pq_pool_plain(
        torch.from_numpy(qs), torch.from_numpy(codes), torch.from_numpy(book),
        None if rotation is None else torch.from_numpy(rotation), N_VALID,
        torch.from_numpy(dead), pool=pool, metric_value=METRICS[metric],
        chunk=CHUNK)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    live = ~dead[:N_VALID]
    assert (ti.numpy() >= 0).all() and live[ti.numpy()].all()


# (D, G) of the element rule and the staged windows: sub dividing 64 or
# not, G % 4 != 0 (byte loads), D % 64 != 0 (a step past D), sub = 1
RENDER_SHAPES = [(128, 32), (128, 16), (96, 12), (96, 32), (72, 12),
                 (30, 6), (960, 32), (64, 64), (100, 25), (45, 9)]
# the kernel's code window stride (bytes), dims a step, pairs a step
CODE_STRIDE, STEP_D, PAIRS = 80, 64, 32


@pytest.mark.parametrize("dims,groups", RENDER_SHAPES)
def test_element_rule_is_the_bf16_decode(dims, groups):
    """The kernel's element (r, d): the codebook table (pq_table, rounded
    once to bf16, in pairs, [step][code][pair]) at step d // 64, the code
    of group d // sub, pair (d % 64) // 2, half d % 2; rendered as the
    kernel stages and decodes it, a 64-dim step at a time: the row's code
    bytes [w0, g_end) with w0 = d0 // sub rounded down to a word (at most
    68 bytes, in whole words inside the 80-byte stage row and, when G % 4
    == 0, inside the row), lane p taking the low half from the code at
    dim 2p's offset and the high half from the code at dim 2p + 1's.
    Equals pq_decode(codes, codebook).to(bfloat16) bit for bit, on a
    normal codebook (ties to even included); the table is 0 past D."""
    rng = np.random.default_rng(dims + groups)
    n, sub = 300, dims // groups
    book = torch.from_numpy(rng.normal(size=(groups, 256, sub))
                            .astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, groups))
                             .astype(np.uint8))
    table = cb.pq_table(book)
    steps = -(-dims // STEP_D)
    assert table.dtype == torch.bfloat16
    assert table.shape == (steps, 256, PAIRS, 2)
    by_dim = table.permute(0, 2, 3, 1).reshape(steps * STEP_D, 256)
    assert not by_dim[dims:].any()
    rendered = torch.zeros((n, dims), dtype=torch.bfloat16)
    for d0 in range(0, dims, STEP_D):
        w0 = (d0 // sub) & ~3
        g_end = min(groups, (min(d0 + STEP_D, dims) - 1) // sub + 1)
        nb = g_end - w0
        assert 1 <= nb <= 68 and 4 * -(-nb // 4) <= CODE_STRIDE
        if groups % 4 == 0:
            assert w0 + 4 * -(-nb // 4) <= groups
        window = codes[:, w0:g_end].long()
        offsets = [(d0 + dl) // sub - w0 if d0 + dl < dims else 0
                   for dl in range(STEP_D)]
        assert all(0 <= o < nb for o in offsets)
        chunk = table[d0 // STEP_D]
        for p in range(PAIRS):
            for h in range(2):
                d = d0 + 2 * p + h
                if d < dims:
                    rendered[:, d] = chunk[window[:, offsets[2 * p + h]], p,
                                           h]
    want = pq_decode(codes, book).to(torch.bfloat16)
    assert torch.equal(rendered.view(torch.int16), want.view(torch.int16))


def _l1_schedule(qs, rows, n_valid, dead, pool):
    """The PQ kernel's Manhattan pool rendered in torch: every (query,
    row) score summed over the dims in ascending order in float32, each
    difference and sum rounded on its own (a 64-dim step at a time, a pair
    of dims at once, dims past D zero on both sides), over the decoded
    bf16 rows;
    rows >= n_valid and tombstones +inf; the ``pool`` least by (score,
    id)."""
    dims = qs.shape[1]
    width = STEP_D * -(-dims // STEP_D)
    q = torch.nn.functional.pad(qs, (0, width - dims))
    p = torch.nn.functional.pad(rows.float(), (0, width - dims))
    acc = torch.zeros((q.shape[0], p.shape[0]), dtype=torch.float32)
    for d in range(width):
        acc = acc + (q[:, d, None] - p[None, :, d]).abs()
    mask = torch.arange(p.shape[0]) >= n_valid
    if dead is not None:
        mask |= dead
    acc[:, mask] = float("inf")
    # a stable sort of the scores keeps the lower id first among equals
    order = torch.sort(acc, dim=1, stable=True).indices[:, :pool]
    return torch.gather(acc, 1, order), order.to(torch.int32)


@pytest.mark.parametrize("dims,groups", [(64, 8), (72, 12), (30, 6)])
def test_manhattan_schedule_matches_the_twin(dims, groups):
    """The kernel's Manhattan order of summation (_l1_schedule) against the
    twin's torch.cdist: on the equal-norm integer case bit for bit, ids
    and distances; on normal codebooks and queries distances at rtol 1e-5
    and ids except float64 near-ties (< 1e-5 relative)."""
    codes, book, qs, _, dead = equal_norm_case(dims, groups, dims, n=700,
                                               b=8)
    tc, tb = torch.from_numpy(codes), torch.from_numpy(book)
    n_valid = 700 - 21
    kw = dict(pool=64, metric_value=METRICS["manhattan"], chunk=256)
    rows = pq_decode(tc, tb).to(torch.bfloat16)
    got = _l1_schedule(torch.from_numpy(qs), rows, n_valid,
                       torch.from_numpy(dead), 64)
    want = pq_sweep._pq_pool_plain(torch.from_numpy(qs), tc, tb, None,
                                   n_valid, torch.from_numpy(dead), **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    rng = np.random.default_rng(dims)
    tb = torch.from_numpy(rng.normal(size=book.shape).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=qs.shape).astype(np.float32))
    rows = pq_decode(tc, tb).to(torch.bfloat16)
    got = _l1_schedule(q, rows, n_valid, None, 64)
    want = pq_sweep._pq_pool_plain(q, tc, tb, None, n_valid, None, **kw)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5)
    diff = got[1] != want[1]
    r64, q64 = rows.double(), q.double()

    def d64(ids):
        return (r64[ids.long()] - q64[:, None]).abs().sum(-1)
    a, b = d64(got[1])[diff], d64(want[1])[diff]
    assert bool(((a - b).abs() <= 1e-5 * b).all())


def _c_pq_smem_bytes():
    """kSmemBytes of csrc/pq_topk.cu, term by term: two ring stages of
    [128 x 80] code bytes, 64 offset bytes, the table's [256 x 32] chunk of
    bf16 pairs and the [128 x 72] float32 query chunk; the decoded [128 x
    36] word tile; the [128 x 32] bound lists and their staged scores;
    nine words a query and two a row."""
    stage = 128 * 80 + 64 + 256 * 32 * 4 + 128 * 72 * 4
    return (2 * stage + 128 * 36 * 4 + 2 * 128 * 32 * 4 + 9 * 128 * 4
            + 2 * 128 * 4)


def _pq_src():
    return open(cb.__file__.replace("ops/cuda_bruteforce.py",
                                    "csrc/pq_topk.cu")).read()


@pytest.mark.parametrize("dims", [64, 128, 960])
def test_pq_smem_bytes_and_launch_shape(dims):
    """PQ_SMEM against the C formula (one figure for every D and pool, one
    block an SM), and _pq_launch_shape at every pool from 1 to 1024 over
    1M rows at B = 1024: one query tile of 128 (the C side has no other),
    S splits and the bound's rank j <= 32, whose P = ceil(k_run / j) folds
    are at most half the F = min(S, 32) lanes' where j < 32 (at most all
    of them at j = 32), segments of max(512, 2 k_run) entries, never more
    than a split's rows; at phase 8's pool of 32, 33 splits of 8 query
    tiles fill 132 SMs twice."""
    src = _pq_src()
    for line in ("constexpr int kQT = 128;", "constexpr int kStepD = 64;",
                 "constexpr int kCS = 80;", "constexpr int kJ = 32;",
                 "constexpr int kSmemBytes = kStages * kStageBytes + "
                 "kTileN * kDW * 4 +"):
        assert line in src
    assert cb.PQ_SMEM == _c_pq_smem_bytes() <= cb.SMEM_LIMIT
    assert cb._blocks_per_sm(cb.PQ_SMEM) == 1 and cb.PQ_QT == 128
    assert tuple(cb.pq_table(torch.zeros((dims // 4, 256, 4))).shape) == (
        -(-dims // 64), 256, 32, 2)
    for k_run in range(1, cb.MAX_K_RUN + 1):
        splits, rank, cap, per = cb._pq_launch_shape(1024, 1_000_000, k_run,
                                                     132)
        folds = min(splits, 32)
        assert 1 <= splits <= cb.MAX_SPLITS and 1 <= rank <= min(32, k_run)
        assert -(-k_run // rank) <= (folds if rank == 32 else -(-folds // 2))
        assert rank == 1 or -(-k_run // (rank - 1)) > -(-folds // 2)
        assert cap == min(per, max(512, 2 * k_run))
        assert per == 128 * -(-(-(-1_000_000 // splits)) // 128)
    assert cb._pq_launch_shape(1024, 1_000_000, 32, 132)[:2] == (33, 2)
    assert cb._pq_launch_shape(1024, 1_000_000, 1024, 132)[:2] == (33, 32)


def test_pq_launch_shape_without_a_bound():
    """Rows too few for S >= k_run / 32 splits of 2048: no bound, and
    segments that hold a split's every row, so none overflows (at a pool
    of 256 the same rows take the bound); no rows at all: one split,
    segments of one entry."""
    splits, rank, cap, per = cb._pq_launch_shape(65, 20_000, 1024, 132)
    assert (splits, rank) == (10, 0) and cap == per == 2048
    assert cb._pq_launch_shape(65, 20_000, 256, 132) == (10, 32, 512, 2048)
    assert cb._pq_launch_shape(5, 0, 10, 132) == (1, 10, 1, 0)


def test_pq_entry_and_instance():
    """The PQ pool is its own kernel (csrc/pq_topk.cu), no instance of the
    row sweep's template: bruteforce_topk.cu holds no PQ entry, _instance
    takes no uint8 rows, and the PQ kernel's calls are counted under its
    name."""
    rows_src = open(cb.__file__.replace("ops/cuda_bruteforce.py",
                                        "csrc/bruteforce_topk.cu")).read()
    assert "bruteforce_topk_pq" not in rows_src and "pq_rows" not in rows_src
    assert "int bruteforce_topk_pq(" in _pq_src()
    with pytest.raises(KeyError):
        cb._instance(torch.uint8, 32)
    assert "bruteforce_topk_pq" in cb.LAUNCHES


# (rows, k_run, splits, tile, cap) of the filter's model
FILTER_SHAPES = [(600, 16, 5, 8, 600), (1000, 64, 33, 4, 40),
                 (2000, 130, 33, 16, 80), (300, 40, 7, 32, 64),
                 (700, 200, 3, 16, 700)]


def _scores(kind, n, gen):
    """One query's scores f32[n]: normal; integers in {0, 1, 2}; all
    equal; {0, 1, 2} with 40% of the rows masked (+inf)."""
    if kind == "normal":
        return torch.randn(n, generator=gen)
    if kind == "all equal":
        return torch.zeros(n)
    scores = torch.randint(0, 3, (n,), generator=gen).float()
    if kind == "masked":
        scores[torch.rand(n, generator=gen) < 0.4] = float("inf")
    return scores


@pytest.mark.parametrize("kind", ["normal", "ties 012", "all equal",
                                  "masked"])
@pytest.mark.parametrize("shape", FILTER_SHAPES,
                         ids=[f"n{n}-k{k}-s{s}-t{t}-c{c}"
                              for n, k, s, t, c in FILTER_SHAPES])
def test_filter_then_select_gives_the_plain_pool(kind, shape):
    """The PQ kernel's sweep modelled in torch (tests/pq_filter.py: each
    split's 32-score list fed by its staged rows, its own k_run-th when
    k_run <= 32, the bound the P-th least of the slots' 32 folds, read
    fresh or stale under random interleavings, before every tile or every
    8, with and without the seeding pass), then the select (the
    stored rows at or under the final bound, the k_run least): the plain
    top k_run whenever no segment overflowed, on tie-heavy scores too; the
    same through _pq_select_plain on the segments as the kernel lays them
    out."""
    from pq_filter import pq_filter, select
    from split_filter import plain_topk
    n, k_run, splits, tile, cap = shape
    gen = torch.Generator().manual_seed(zlib.crc32(repr((kind, shape))
                                                   .encode()))
    for trial in range(6):
        scores = _scores(kind, n, gen)
        want = plain_topk(scores, k_run)
        rank = cb._pq_rank(splits, k_run)
        segs, counts, slots = pq_filter(scores, k_run, splits, tile, cap,
                                        rank, gen,
                                        max_lag=None if trial % 2 else 0,
                                        refresh=(1, 8)[trial % 3 == 2],
                                        seed=(0, 2)[trial // 3])
        if max(counts) > cap:
            continue
        assert select(segs, slots, k_run, rank) == want
        buf = torch.zeros((1, splits, cap, 2), dtype=torch.int32)
        for s, seg in enumerate(segs):
            for e, (v, r) in enumerate(seg):
                buf[0, s, e, 0] = torch.tensor(v).view(torch.int32)
                buf[0, s, e, 1] = r
        d, i, floor = cb._pq_select_plain(
            buf, torch.tensor([counts], dtype=torch.int32), cap,
            None if slots is None else torch.tensor([slots]), rank, k_run,
            METRICS["cosine"])
        assert list(zip(d[0].tolist(), i[0].tolist())) == want
        assert (floor[0].item(), floor[1].item()) == want[-1]


def _fkey(v):
    """The kernel's ordered bits of a float32 (fkey)."""
    u = int(np.float32(v).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def _radix_threshold(keys, k_run):
    """pq_select_kernel's threshold over 64-bit keys (unique), rendered in
    Python: eight 8-bit passes from the top, each a histogram of the next
    byte among the keys that share the prefix, the bin where the count
    reaches the rows still needed; done once a bin holds exactly them."""
    if len(keys) <= k_run:
        return (1 << 64) - 1, 0
    prefix, need = 0, k_run
    for n_pass, shift in enumerate(range(56, -1, -8), 1):
        hist = [0] * 256
        for key in keys:
            if shift == 56 or ((key ^ prefix) >> (shift + 8)) == 0:
                hist[(key >> shift) & 255] += 1
        below, b = 0, 0
        while below + hist[b] < need:
            below += hist[b]
            b += 1
        prefix |= b << shift
        need -= below
        thresh = prefix | ((1 << shift) - 1)
        if hist[b] == need:
            return thresh, n_pass
    return thresh, 8


@pytest.mark.parametrize("kind", ["normal", "ties 012", "all equal",
                                  "signed"])
def test_select_radix_schedule(kind):
    """The select's radix threshold takes exactly the k_run least (score,
    id) keys, whatever the ties: normal scores end in the score's bytes
    (at most 4 passes), equal scores pass into the id's; signed scores
    (cosine's can round below 0) keep their order under fkey."""
    gen = torch.Generator().manual_seed(zlib.crc32(kind.encode()))
    for n, k_run in ((50, 64), (700, 1), (700, 32), (3000, 1024),
                     (2000, 257)):
        scores = (_scores("normal" if kind == "signed" else kind, n, gen)
                  .tolist())
        if kind == "signed":
            scores = [v * 1e-6 for v in scores]
        ids = torch.randperm(10 * n, generator=gen)[:n].tolist()
        keys = [(_fkey(v) << 32) | i for v, i in zip(scores, ids)]
        thresh, passes = _radix_threshold(keys, k_run)
        got = sorted(k for k in keys if k <= thresh)
        want = sorted((np.float32(v), i) for v, i in zip(scores, ids))
        want = [(_fkey(v) << 32) | i for v, i in want][:k_run]
        assert got == want
        if kind == "normal" and n > k_run:
            assert passes <= 4


def _plain_launch(scores, k_run, splits, tile, gen, calls):
    """A ``launch(rows, entries)`` for _filter_select over queries whose
    rows score ``scores`` f32[B, n]: the filter's model, then
    _pq_select_plain, each call recorded in ``calls``."""
    from pq_filter import pq_filter
    rank = cb._pq_rank(splits, k_run)

    def launch(rows, entries):
        idx = range(scores.shape[0]) if rows is None else rows.tolist()
        calls.append((None if rows is None else list(idx), entries))
        buf = torch.zeros((len(idx), splits, entries, 2), dtype=torch.int32)
        counts = torch.zeros((len(idx), splits), dtype=torch.int32)
        bound = torch.zeros((len(idx), splits)) if rank else None
        for a, q in enumerate(idx):
            segs, cnt, slots = pq_filter(scores[q], k_run, splits, tile,
                                         entries, rank, gen)
            counts[a] = torch.tensor(cnt)
            if rank:
                bound[a] = torch.tensor(slots)
            for s, seg in enumerate(segs):
                for e, (v, r) in enumerate(seg):
                    buf[a, s, e, 0] = torch.tensor(v).view(torch.int32)
                    buf[a, s, e, 1] = r
        d, i, floor = cb._pq_select_plain(buf, counts, entries, bound, rank,
                                          k_run, METRICS["manhattan"])
        return d, i, counts, floor
    return launch


def test_overflow_reruns_its_queries():
    """Segments too small for the first tiles (every row of a tile
    appended before any bound exists) overflow: _filter_select runs the
    queries that overflowed again, in one call with segments of a split's
    every row, and the pool equals the plain one on every query; with
    segments that hold a split's rows, or where none overflowed, there is
    one call."""
    from split_filter import plain_topk
    gen = torch.Generator().manual_seed(11)
    n, k_run, splits, tile = 800, 24, 4, 32
    per = tile * math.ceil(n / splits / tile)
    scores = torch.randn((6, n), generator=gen)
    scores[2] = torch.arange(n, 0, -1).float()   # every tile improves
    calls = []
    launch = _plain_launch(scores, k_run, splits, tile, gen, calls)
    d, i, floor = cb._filter_select(launch, 40, per, splits)
    assert calls[0] == (None, 40) and len(calls) == 2
    assert calls[1][1] == per and 2 in calls[1][0]
    for q in range(6):
        want = plain_topk(scores[q], k_run)
        assert list(zip(d[q].tolist(), i[q].tolist())) == want
        assert (floor[0][q].item(), floor[1][q].item()) == want[-1]
    calls.clear()
    cb._filter_select(launch, per, per, splits)
    assert calls == [(None, per)]
    # segments that can overflow but did not: one call, no empty rerun
    calls.clear()
    launch = _plain_launch(scores[:2], k_run, splits, tile, gen, calls)
    d, i, _ = cb._filter_select(launch, 200, per, splits)
    assert calls == [(None, 200)]
    for q in range(2):
        want = plain_topk(scores[q], k_run)
        assert list(zip(d[q].tolist(), i[q].tolist())) == want


def test_pq_select_plain_is_the_twin():
    """With every live row of every split in its segment (no bound), the
    plain select gives _pq_pool_plain's pool bit for bit, every metric, on
    the equal-norm integer case (ties by id), pools past the rows too."""
    codes, book, qs, _, dead = equal_norm_case(3, 8, 64, n=700, b=6)
    tc, tb, tq = (torch.from_numpy(a) for a in (codes, book, qs))
    rows = pq_decode(tc, tb).to(torch.bfloat16).float()
    n_valid, splits = 650, 3
    per = 128 * math.ceil(n_valid / splits / 128)
    for metric, value in METRICS.items():
        score = {"l2": lambda: torch.clamp(
            (tq * tq).sum(1, keepdim=True) + (rows * rows).sum(1)
            - 2 * tq @ rows.T, min=0),
                 "cosine": lambda: 1 - tq @ rows.T * torch.rsqrt(
                     (tq * tq).sum(1, keepdim=True) * (rows * rows).sum(1)),
                 "manhattan": lambda: torch.cdist(tq, rows, p=1)}[metric]()
        buf = torch.zeros((6, splits, per, 2), dtype=torch.int32)
        counts = torch.zeros((6, splits), dtype=torch.int32)
        for r in range(n_valid):
            if dead[r]:
                continue
            s = r // per
            at = counts[:, s].clone()
            for q in range(6):
                buf[q, s, at[q], 0] = score[q, r].view(torch.int32)
                buf[q, s, at[q], 1] = r
            counts[:, s] += 1
        for pool in (16, 1024):
            got = cb._pq_select_plain(buf, counts, per, None, 0, pool, value)
            want = pq_sweep._pq_pool_plain(tq, tc, tb, None, n_valid,
                                           torch.from_numpy(dead), pool=pool,
                                           metric_value=value, chunk=256)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_routing_on_the_cpu(metric):
    """A CPU tensor runs the twin (the same pool) and launches nothing,
    Manhattan included; a meta tensor raises, whatever the metric;
    pq_topk takes CUDA tensors only, every metric (Manhattan too)."""
    codes, book, qs, _, dead = equal_norm_case(7, 8, 64, n=500, b=4)
    args = [torch.from_numpy(a) for a in (qs, codes, book)]
    kw = dict(pool=32, metric_value=METRICS[metric], chunk=128)
    before = dict(cb.LAUNCHES)
    got = pq_sweep._pq_pool(*args, None, 480, torch.from_numpy(dead), **kw)
    want = pq_sweep._pq_pool_plain(*args, None, 480, torch.from_numpy(dead),
                                   **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cb.LAUNCHES == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pq_sweep._pq_pool(*meta, None, 480, None, **kw)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        cb.pq_topk(args[0], args[1], cb.pq_table(args[2]), 32,
                   METRICS[metric], 480)
    with pytest.raises(ValueError, match="or Manhattan, not metric 3"):
        cb.pq_topk(args[0], args[1], cb.pq_table(args[2]), 32, 3, 480)
