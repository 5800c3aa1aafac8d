"""The CUDA kernels on the card: ops/cuda_bruteforce.bruteforce_topk
(float32, bfloat16 and int8-shadow rows) against its plain twin, the
index's exact route and the build's candidate sweep (sweep_pool) through
it; ops/cuda_graph.beam_walk and prune_scan against theirs
(core/search._search_batch, core/build._prune_scan_plain), and the graph
route through the walk kernel; ops/cuda_graph.connect_batch, the build's
wiring, against core/build._connect_batch_plain.  A CUDA kernel has no
CPU mode, so every test here skips without a CUDA device; run them on the
card with
``python -m pytest tests/ -m cuda``.  This file imports no JAX (the card's
machine has none); its integer fixture is shared with test_torch_walk.py.

Tolerances: distances rtol 1e-5; ids equal except where the two sides'
distances at that rank are within 1e-5 relative (float32 sums in another
order may swap near-tied rows).  The walk on the integer fixture (every
L2 and Manhattan distance exact in float32), the int8 sweep under L2 on
integer rows at power-of-two scales, the prune scan (comparisons of
the same values) and the wiring on integer rows are held bit for bit."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch import HnswConfig, HnswIndex
from pg_embedding_tpu_torch.convert import graph_from_numpy, to_numpy
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
# the walk's operands by row source, shared with chip_smoke.py
from walk_operands import (WIDE_ROW_PQ, integer_operands, on_device,
                            wide_row_operands)

pytestmark = pytest.mark.cuda

# the integer fixture: 3,000 rows of 32 integers in [-8, 8]
N, D, B = 3000, 32, 64
METRICS = {"l2": 0, "cosine": 1, "manhattan": 2}
# (ef, cand_cap) of the walk's bit-equality cases
QUEUES = [(16, 16), (64, 64), (64, 128), (128, 64)]


def integer_data(seed=8, n=N, b=B):
    """(rows f32[n, D], queries f32[b, D]): integers in [-8, 8], so every
    L2 and Manhattan distance is exact in float32 whatever the summation
    order, and exact ties are frequent."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-8, 9, size=(n, D)).astype(np.float32)
    qs = rng.integers(-8, 9, size=(b, D)).astype(np.float32)
    return pts, qs


def integer_graph(metric: str):
    """The integer fixture's graph, built by the port on the CPU with
    ``metric``, as numpy arrays (convert.to_numpy), and its queries."""
    pts, qs = integer_data()
    idx = HnswIndex(HnswConfig(dims=D, m=8, ef_construction=32, ef_search=32,
                               metric=metric), device="cpu")
    idx.build(pts)
    return to_numpy(idx.graph), qs


def prune_case(seed, b, c):
    """Candidate sets for the prune: exact ties in both the query
    distances and the pairwise matrix, invalid entries, and sets with too
    few valid candidates to prune."""
    rng = np.random.default_rng(seed)
    cand_d = (rng.integers(1, 12, size=(b, c)) / 4).astype(np.float32)
    cand_i = rng.permutation(200_000)[: b * c].reshape(b, c).astype(np.int32)
    cand_i[rng.random((b, c)) < 0.2] = -1
    cand_d[rng.random((b, c)) < 0.1] = np.inf
    cand_i[: b // 4, 6:] = -1
    pair = (rng.integers(1, 12, size=(b, c, c)) / 4).astype(np.float32)
    pair = np.minimum(pair, pair.transpose(0, 2, 1))
    return (torch.from_numpy(cand_d), torch.from_numpy(cand_i),
            torch.from_numpy(pair))


def prune_case_adversarial(seed, b, c, symmetric=True):
    """prune_case, plus: a pair matrix that is not symmetric (when asked),
    a quarter of the sets repeating one id, a quarter all valid (as a
    re-prune's maxM + 1 candidates usually are) and an eighth with nothing
    valid."""
    cand_d, cand_i, pair = prune_case(seed, b, c)
    if not symmetric:
        rng = np.random.default_rng(seed + 1)
        pair = torch.from_numpy((rng.integers(1, 12, size=(b, c, c)) / 4)
                                .astype(np.float32))
    cand_i[1::4, : min(c, 3)] = cand_i[1::4, :1]
    full = cand_i[2::4]
    cand_i[2::4] = 300_000 + torch.arange(full.numel(),
                                          dtype=torch.int32).view_as(full)
    cand_d[2::4] = torch.where(torch.isfinite(cand_d[2::4]), cand_d[2::4],
                               0.25)
    cand_i[3::8] = -1
    return cand_d, cand_i, pair


# the walk's row sources (ops/cuda_graph.walk_variant's names, without the
# visited set) and visited sets, as the integer operands give them
SOURCES = ("rows f32", "rows bf16", "rows int8", "records f32",
           "records bf16", "records int8", "records pq",
           "records pq rotated")
VISITED = {"dense": -1, "bitmap": 0, "hash": 8192}


def sets_in_device_memory(monkeypatch):
    """Every walk from here on keeps its visited set in device memory: the
    placement rule (ops/cuda_graph._visited_place) refuses shared memory.
    The integer fixture's sets under float32 rows fit every table
    instance's block (its bitmap is 94 words), so this is how its tests
    reach the other placement."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    monkeypatch.setattr(cg, "_visited_place",
                        lambda words, used, min_blocks: (0, False))


def sets_in_shared_memory(monkeypatch):
    """Every walk from here on keeps its visited set in a table instance's
    shared memory wherever it fits, whatever an SM then holds (the rule
    with no residency to keep)."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    rule = cg._visited_place
    monkeypatch.setattr(cg, "_visited_place",
                        lambda words, used, min_blocks: rule(words, used, 0))


def repeated_links(arrays, seed=13):
    """The integer graph with heavily repeated links: each row's slots
    draw from its first four links and a small shared pool, so ids repeat
    within a popped row and across the rows of a step."""
    rng = np.random.default_rng(seed)
    links = arrays["links"].copy()
    n, max_m = links.shape
    counts = arrays["link_counts"]
    pool = rng.integers(0, int(arrays["n_nodes"]), size=16)
    for i in range(n):
        k = int(counts[i])
        if k == 0:
            continue
        own = links[i, : min(k, 4)]
        links[i, :k] = rng.choice(np.concatenate([own, pool]), size=k)
    return dict(arrays, links=links)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _check(got, want):
    (dk, ik), (dp, ip) = [(d.cpu().numpy(), i.cpu().numpy())
                          for d, i in (got, want)]
    np.testing.assert_array_equal(np.isinf(dk), np.isinf(dp))
    fin = np.isfinite(dp)
    np.testing.assert_allclose(dk[fin], dp[fin], rtol=1e-5, atol=1e-6)
    diff = ik != ip
    assert np.all(np.abs(dk[diff] - dp[diff]) <= 1e-5 * np.abs(dp[diff]))


@pytest.mark.parametrize("metric,n,d,b,k_run,masked", [
    (0, 20000, 128, 300, 12, False),
    (1, 20000, 100, 64, 1, True),
    (0, 7000, 960, 40, 102, True),
    (1, 5000, 30, 17, 1000, False),      # QT = 16
    (0, 3000, 64, 33, 100, True),        # k_run > live rows
])
def test_kernel_matches_plain(cuda, metric, n, d, b, k_run, masked):
    g = torch.Generator(device=cuda).manual_seed(n + d)
    pts = torch.randn((n, d), generator=g, device=cuda)
    qs = torch.randn((b, d), generator=g, device=cuda)
    n_valid, dead = n, None
    if masked:
        n_valid = n // 30 if k_run == 100 else n - 123
        dead = torch.rand(n, generator=g, device=cuda) < 0.1
    # the Hopper instance where the rule takes it, else the exact route's,
    # or the wide one from WIDE_MIN_K to 256
    name = cb.launch_instance(qs, pts, k_run, metric)[0]
    before = cb.LAUNCHES[name]
    got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[name] == before + 1
    _check(got, cb._bruteforce_topk_plain(qs, pts, k_run, metric, n_valid,
                                          dead))


@pytest.mark.parametrize("metric,n,d,b,k_run,masked", [
    (0, 20000, 128, 300, 12, False),     # 16-byte row loads
    (1, 20000, 100, 64, 10, True),       # D % 8 != 0: element loads
    (0, 7000, 960, 40, 102, True),
    (1, 5000, 32, 17, 1000, False),
])
def test_bf16_kernel_matches_plain(cuda, metric, n, d, b, k_run, masked):
    g = torch.Generator(device=cuda).manual_seed(n + d + 1)
    pts = torch.randn((n, d), generator=g, device=cuda).to(torch.bfloat16)
    qs = torch.randn((b, d), generator=g, device=cuda)
    n_valid, dead = n, None
    if masked:
        n_valid = n - 321
        dead = torch.rand(n, generator=g, device=cuda) < 0.1
    name = cb.launch_instance(qs, pts, k_run, metric)[0]
    before = dict(cb.LAUNCHES)
    got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[name] == before[name] + 1
    assert sum(cb.LAUNCHES.values()) == sum(before.values()) + 1
    _check(got, cb._bruteforce_topk_plain(qs, pts, k_run, metric, n_valid,
                                          dead))
    # an unaligned corpus view (rows start 2 bytes in) takes element loads
    off = pts.view(-1)[1:1 + (n - 1) * d].view(n - 1, d)
    _check(cb.bruteforce_topk(qs, off, k_run, metric, n - 1),
           cb._bruteforce_topk_plain(qs, off, k_run, metric, n - 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric,n,d,b,k_run,masked", [
    (0, 9000, 128, 300, 64, True),       # the largest k_run of QT = 128
    (1, 9000, 128, 17, 65, False),       # the smallest of QT = 64
    (0, 6000, 100, 300, 256, False),
    (1, 6000, 30, 17, 257, True),        # QT = 16; element loads
    (0, 5000, 960, 17, 1024, True),
    (1, 4000, 960, 300, 12, False),
])
def test_kernel_tier_edges(cuda, dtype, metric, n, d, b, k_run, masked):
    """Each query tile's k_run edges, B not a multiple of the tile, D = 30 /
    100 / 960; bf16 also through an unaligned view (element loads)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(n + d + k_run)
    pts = torch.randn((n, d), generator=g, device=cuda).to(dt)
    qs = torch.randn((b, d), generator=g, device=cuda)
    n_valid, dead = n, None
    if masked:
        n_valid = n - 77
        dead = torch.rand(n, generator=g, device=cuda) < 0.1
    name = cb.launch_instance(qs, pts, k_run, metric)[0]
    before = cb.LAUNCHES[name]
    got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[name] == before + 1
    _check(got, cb._bruteforce_topk_plain(qs, pts, k_run, metric, n_valid,
                                          dead))
    if dt is torch.bfloat16:
        off = pts.view(-1)[1:1 + (n - 1) * d].view(n - 1, d)
        _check(cb.bruteforce_topk(qs, off, k_run, metric, n - 1),
               cb._bruteforce_topk_plain(qs, off, k_run, metric, n - 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric,n,d,b,k_run,masked", [
    (0, 20000, 128, 300, 12, True),      # the main path's k_run; B % 64
    (1, 20000, 128, 65, 1, False),
    (0, 9000, 32, 17, 63, True),         # the largest k_run of the rule
    (1, 9000, 96, 130, 33, True),        # D % 32 != 0: a zero-filled chunk
    (0, 7000, 128, 64, 63, "all"),       # every row tombstoned
    (1, 5000, 256, 64, 12, False),       # past WGMMA_MAX_D: mma.sync
])
def test_wgmma_tier_edges(cuda, dtype, metric, n, d, b, k_run, masked):
    """The Hopper instances against the twin at the rule's edges: k_run 1,
    12 and 63, B not a multiple of the 64-query tile, n_valid not a
    multiple of the 128-row tile, tombstones, every row masked, D 32, 96
    and 128; D = 256 takes the mma.sync instance by the rule.  Ids equal
    the twin's but for float64-judged near-ties; distances to rtol 1e-5."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(n + d + k_run)
    pts = torch.randn((n, d), generator=g, device=cuda).to(dt)
    qs = torch.randn((b, d), generator=g, device=cuda)
    n_valid, dead = n, None
    if masked == "all":
        dead = torch.ones(n, dtype=torch.bool, device=cuda)
    elif masked:
        n_valid = n - 77
        dead = torch.rand(n, generator=g, device=cuda) < 0.1
    name, wgmma = cb.launch_instance(qs, pts, k_run, metric)
    assert wgmma == (d <= cb.WGMMA_MAX_D)
    assert name == (cb._WGMMA_KERNELS if wgmma else cb._KERNELS)[dt]
    before = dict(cb.LAUNCHES)
    got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[name] == before[name] + 1
    assert sum(cb.LAUNCHES.values()) == sum(before.values()) + 1
    want = cb._bruteforce_topk_plain(qs, pts, k_run, metric, n_valid, dead)
    _check(got, want)
    if masked == "all":
        assert bool((got[1] == -1).all()) and bool(torch.isinf(got[0]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgmma_paged_call_keeps_one_path(cuda, dtype):
    """k = 1030 in two pages, both on the mma.sync instance (the rule keeps
    pages off the Hopper one, whose scores need not equal mma.sync's bit
    for bit): one list, no duplicate id, no gap, the twin's answer."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1030)
    pts = torch.randn((6000, 128), generator=g, device=cuda).to(dt)
    qs = torch.randn((70, 128), generator=g, device=cuda)
    dead = torch.rand(6000, generator=g, device=cuda) < 0.05
    before = dict(cb.LAUNCHES)
    got = cb.bruteforce_topk_paged(qs, pts, 1030, 0, 5900, dead)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in cb.LAUNCHES.items() if v != before[k]}
    assert ran == {cb._KERNELS[dt]: 2}
    ids = got[1].cpu().numpy()
    assert (ids >= 0).all()
    assert all(len(np.unique(r)) == 1030 for r in ids)
    assert not np.isin(ids, torch.nonzero(dead).cpu().numpy()).any()
    assert bool((got[0][:, 1:] >= got[0][:, :-1]).all())
    _check(got, cb._bruteforce_topk_plain(qs, pts, 1030, 0, 5900, dead))


def test_wgmma_launch_refuses_what_the_rule_keeps_off(cuda):
    """The Hopper entries check their own shared-memory figure and refuse
    a floor, a query tile other than 64, streamed queries, k_run 64 and
    D past 128 rather than launch."""
    from pg_embedding_tpu_torch import _kernels
    lib = _kernels.load_library()
    qs = torch.zeros((4, 128), device=cuda)
    pts = torch.zeros((300, 128), device=cuda)
    part = torch.empty((1, 4, 64), device=cuda)
    out = torch.empty((4, 64), device=cuda)
    floor = torch.zeros(4, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    good = cb._launch_shape(4, 300, 12, 132, 4, 128, wgmma=True)[3]

    def call(k_run=12, qt=64, q_res=1, smem=good, dims=128, fl=None):
        return lib.bruteforce_topk_wgmma(
            qs.data_ptr(), pts.data_ptr(), None, 4, 300 * 128 // dims, dims,
            k_run, 0, qt, 1, q_res, smem, part.data_ptr(), part.data_ptr(),
            out.data_ptr(), out.data_ptr(), fl, fl, stream)
    assert call() == 0
    torch.cuda.synchronize()
    for bad in (dict(smem=good + 16), dict(qt=16), dict(q_res=0),
                dict(fl=floor.data_ptr()),
                dict(k_run=64, smem=cb._smem_bytes(64, 64, 4, 128, True,
                                                   wgmma=True)),
                dict(dims=256, smem=cb._smem_bytes(64, 12, 4, 256, True,
                                                   wgmma=True))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.check(lib, call(**bad), "bruteforce_topk_wgmma")


def test_launch_refuses_a_wrong_shared_memory_figure(cuda):
    """The C side computes its own shared memory and raises rather than
    launch with another figure."""
    from pg_embedding_tpu_torch import _kernels
    lib = _kernels.load_library()
    qs = torch.zeros((4, 8), device=cuda)
    pts = torch.zeros((100, 8), device=cuda)
    part = torch.empty((1, 4, 5), device=cuda)
    out = torch.empty((4, 5), device=cuda)
    qt, splits, q_res, smem = cb._launch_shape(4, 100, 5, 132, 4, 8)
    stream = torch.cuda.current_stream().cuda_stream
    for res, bad in ((q_res, smem + 16), (q_res, smem - 16),
                     (not q_res, smem)):
        err = lib.bruteforce_topk(qs.data_ptr(), pts.data_ptr(), None, 4, 100,
                                  8, 5, 0, qt, 1, int(res), bad,
                                  part.data_ptr(), part.data_ptr(),
                                  out.data_ptr(), out.data_ptr(), None, None,
                                  stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.check(lib, err, "bruteforce_topk")


def test_index_exact_route_uses_kernel(cuda):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    qs = rng.normal(size=(64, 32)).astype(np.float32)
    cfg = HnswConfig(dims=32, m=8, ef_construction=32, ef_search=32)
    gpu = HnswIndex(cfg, device=cuda)
    cpu = HnswIndex(cfg, device="cpu")
    for idx in (gpu, cpu):
        idx.build(pts)
        idx.delete(np.arange(0, 3000, 11))
    # k_run 12 at D = 32: the Hopper instance
    before = cb.LAUNCHES["bruteforce_topk_wgmma"]
    d, l, v = gpu.search(qs, 10)                   # auto -> exact route
    assert cb.LAUNCHES["bruteforce_topk_wgmma"] > before
    dc, lc, vc = cpu.search(qs, 10)
    assert (l == lc).mean() >= 0.99
    np.testing.assert_allclose(d, dc, rtol=1e-5)
    assert not np.isin(l[v], np.arange(0, 3000, 11)).any()


def test_bf16_storage_exact_route_uses_bf16_kernel(cuda):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    qs = rng.normal(size=(64, 32)).astype(np.float32)
    cfg = HnswConfig(dims=32, m=8, ef_construction=32, ef_search=32)
    gpu = HnswIndex(cfg, device=cuda, storage_dtype="bfloat16")
    cpu = HnswIndex(cfg, device="cpu", storage_dtype="bfloat16")
    for idx in (gpu, cpu):
        idx.build(pts)
    before = cb.LAUNCHES["bruteforce_topk_bf16_wgmma"]
    d, l, v = gpu.exact_search(qs, 10)
    assert cb.LAUNCHES["bruteforce_topk_bf16_wgmma"] == before + 1
    dc, lc, vc = cpu.exact_search(qs, 10)
    assert (l == lc).mean() >= 0.99
    np.testing.assert_allclose(d, dc, rtol=1e-5)


def test_wide_k_pages_on_card(cuda):
    """k_run above MAX_K_RUN runs the kernel in pages on the card: 2 launches
    at k=1500 (3 at k_run 2100, bf16 rows), whose concatenation is the
    plain twin's one list (ids except float64 near-ties, distances to rtol
    1e-5), and the exact entry's answer is the CPU run's."""
    from pg_embedding_tpu_torch.ops.bruteforce import exact_search
    g = torch.Generator().manual_seed(5)
    pts = torch.randn((6000, 32), generator=g)
    qs = torch.randn((40, 32), generator=g)
    dead = torch.rand(6000, generator=g) < 0.05
    before = dict(cb.LAUNCHES)
    got = cb.fused_exact_search(qs.to(cuda), pts.to(cuda), 1500,
                                deleted=dead.to(cuda))
    torch.cuda.synchronize()
    assert cb.LAUNCHES["bruteforce_topk"] == before["bruteforce_topk"] + 2
    assert got[1].shape == (40, 1500)
    _check(got, exact_search(qs, pts, 1500, deleted=dead))
    for corpus, k_run, metric in ((pts, 1502, 0),
                                  (pts.to(torch.bfloat16), 2100, 1)):
        c = corpus.to(cuda)
        got = cb.bruteforce_topk_paged(qs.to(cuda), c, k_run, metric, 5900,
                                       dead.to(cuda))
        want = cb._bruteforce_topk_plain(qs, corpus, k_run, metric, 5900,
                                         dead)
        torch.cuda.synchronize()
        _check(got, want)


def test_pq_encode_and_sweep_on_card(cuda):
    """pq_encode, train_pq and pq_sweep_search on the card against the
    CPU: codes agree except float64 near-ties; a codebook trained on the
    card reconstructs within 5% of the CPU's (atomic sums reorder, so a
    near-tied assignment may flip); the sweep's distances to rtol 1e-5 and
    its ids except near-ties."""
    from pg_embedding_tpu_torch.ops import pq
    from pg_embedding_tpu_torch.ops.pq_sweep import pq_sweep_search
    g = torch.Generator().manual_seed(6)
    centers = torch.randn((64, 64), generator=g) * 4
    pts = centers[torch.randint(0, 64, (20000,), generator=g)] + torch.randn(
        (20000, 64), generator=g)
    qs = pts[:300] + 0.1 * torch.randn((300, 64), generator=g)
    cb_cpu = pq.train_pq(pts[:8000], groups=16, iters=6)
    cb_gpu = pq.train_pq(pts[:8000].to(cuda), groups=16, iters=6)
    codes = pq.pq_encode(pts, cb_cpu)

    def recon(cb):
        rows = pq.pq_decode(pq.pq_encode(pts, cb), cb)
        return float(((rows - pts) ** 2).sum(1).mean())
    assert recon(cb_gpu.cpu()) <= 1.05 * recon(cb_cpu)
    codes_gpu = pq.pq_encode(pts.to(cuda), cb_cpu.to(cuda)).cpu()
    diff = (codes_gpu != codes).nonzero()
    assert len(diff) <= 1e-3 * codes.numel()
    sub = pts.view(20000, 16, 4).double()
    c64 = cb_cpu.double()
    for r, grp in diff.tolist():
        a = ((sub[r, grp] - c64[grp, codes[r, grp].long()]) ** 2).sum()
        b = ((sub[r, grp] - c64[grp, codes_gpu[r, grp].long()]) ** 2).sum()
        assert abs(float(a - b)) <= 1e-5 * max(float(a), 1e-12)
    dead = torch.rand(20000, generator=g) < 0.05
    want = pq_sweep_search(qs, codes, cb_cpu, None, pts, 10, pool=64,
                           deleted=dead)
    got = pq_sweep_search(qs.to(cuda), codes.to(cuda), cb_cpu.to(cuda),
                          None, pts.to(cuda), 10, pool=64,
                          deleted=dead.to(cuda))
    torch.cuda.synchronize()
    assert (got[1].cpu() == want[1]).float().mean() >= 0.99
    _check(got, want)


def _sharded_pair(cuda, **kw):
    from pg_embedding_tpu_torch import ShardedHnswIndex
    rng = np.random.default_rng(23)
    centers = rng.normal(scale=3.0, size=(40, 64)).astype(np.float32)
    pts = (centers[rng.integers(0, 40, 6001)] +
           rng.normal(size=(6001, 64))).astype(np.float32)
    qs = (centers[rng.integers(0, 40, 48)] +
          rng.normal(size=(48, 64))).astype(np.float32)
    cfg = HnswConfig(dims=64, m=8, ef_construction=32, ef_search=32)
    pair = [ShardedHnswIndex(cfg, 4, device=dev, **kw)
            for dev in (cuda, "cpu")]
    for idx in pair:
        idx.build(pts)
    return pair, pts, qs


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_sharded_exact_route_launches_once_per_shard(cuda, storage):
    """The sharded exact route on the card: one kernel launch per shard and
    call, the CPU index's answer (same rows, ragged shards, tombstones and
    a label filter)."""
    (gpu, cpu), pts, qs = _sharded_pair(cuda, storage_dtype=storage)
    # k_run 12 at D = 64 over each shard's rows: the Hopper instance
    name = cb._WGMMA_KERNELS[gpu._vectors.dtype]
    dead = np.arange(0, 6001, 11)
    allowed = np.arange(0, 6001, 2)
    for idx in (gpu, cpu):
        idx.delete(dead)
    for where in (None, allowed):
        before = cb.LAUNCHES[name]
        got = gpu.search(qs, 10, where=where)           # auto -> exact
        assert cb.LAUNCHES[name] == before + 4
        want = cpu.search(qs, 10, where=where)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        assert (got[1] == want[1]).mean() >= 0.99
        assert not np.isin(got[1], dead).any() and got[2].all()


def test_sharded_build_and_walk_match_cpu(cuda):
    """A sharded build on the card against the same build on the CPU: link
    rows equal on >= 95% of each shard's rows, graph answers on >= 95% of
    the slots (float32 sums in another order move near-ties)."""
    (gpu, cpu), pts, qs = _sharded_pair(cuda)
    assert gpu.shard_counts.tolist() == cpu.shard_counts.tolist()
    for i, n in enumerate(cpu.shard_counts):
        same = (gpu._links[i, :n].cpu() == cpu._links[i, :n]).all(dim=1)
        assert float(same.float().mean()) >= 0.95
    got, want = (idx.search(qs, 10, mode="graph") for idx in (gpu, cpu))
    assert (got[1] == want[1]).mean() >= 0.95
    gpu.check_integrity()


def test_tune_exact8_chunk_on_card(cuda, tmp_path, monkeypatch):
    """The chunk tuner times the exact8 sweep on the card and keeps the
    fastest chunk that ran; the cache entry is written under
    PG_EMB_TUNE_DIR with the "cuda" backend key, and a chunk tuned on the
    card gives the same build as the default."""
    import json

    import pg_embedding_tpu_torch.api as api_mod

    monkeypatch.setenv("PG_EMB_TUNE_DIR", str(tmp_path))
    monkeypatch.setattr(api_mod, "_EXACT8_CHUNK_CACHE", None)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(5000, 64)).astype(np.float32)
    cfg = HnswConfig(dims=64, m=8, ef_construction=32, ef_search=32)
    idx = HnswIndex(cfg, device=cuda)
    idx.build(pts)
    chunk = idx.tune_exact8_chunk(chunks=(512, 2048, 8192), reps=2)
    assert chunk in (512, 2048, 8192) and idx.exact8_chunk == chunk
    with open(tmp_path / "exact8_chunk.json") as f:
        cache = json.load(f)
    key = api_mod._exact8_chunk_key(64, idx.graph.capacity, "cuda")
    assert key.startswith("cuda:64:") and cache[key] == [chunk, 5000]
    again = HnswIndex(cfg, device=cuda)
    again.exact8_chunk = 512
    again.build(pts)
    same = (again.graph.links == idx.graph.links).all(dim=1)[:5000]
    assert float(same.float().mean()) >= 0.99


def test_two_ranks_share_the_card(cuda, tmp_path):
    """tests/test_torch_multiprocess.py's lifecycle as two gloo ranks on
    cuda:0 (4 of 8 shards each): both ranks give the same answers on every
    route; each exact call launches the kernel once per local shard; the
    exact routes equal the single-process index's on the card except
    float64 near-ties, graph answers agree on >= 95% of the slots and link
    rows on >= 95% of each shard's rows."""
    import test_torch_multiprocess as mp

    procs = mp.run_children(tmp_path, 2, device="cuda:0")
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    single = mp.lifecycle(str(single_dir), 2, device="cuda")
    mp.wait(procs, timeout=600)
    ranks = [dict(np.load(tmp_path / f"answers{r}.npz"))
             for r in range(mp.WORLD)]
    pts, qs = mp._data()
    for name in mp.ROUTES:
        for a, b in zip(mp.route(ranks[0], name), mp.route(ranks[1], name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for r in ranks:
        assert int(r["exact_launches"]) == mp.S // mp.WORLD
    assert int(single["exact_launches"]) == mp.S
    for name in ("exact", "exact_del", "mono_exact", "split_exact"):
        mp.assert_same_exact(mp.route(ranks[0], name),
                             mp.route(single, name), qs, pts)
    for name in ("graph", "graph_del", "mono_graph", "split_graph"):
        got, want = mp.route(ranks[0], name), mp.route(single, name)
        assert (got[1] == want[1]).mean() >= 0.95, name
    links = np.concatenate([r["links"] for r in ranks])
    for i, n in enumerate(single["counts"]):
        same = (links[i, :n] == single["links"][i, :n]).all(axis=1)
        assert same.mean() >= 0.95, (i, same.mean())


@pytest.fixture(scope="module")
def int_graphs():
    """The integer fixture's graphs (L2- and Manhattan-built), as numpy."""
    return {m: integer_graph(m) for m in ("l2", "manhattan")}


def _card_graph(arrays, dev):
    return graph_from_numpy(arrays["vectors"], arrays["links"],
                            arrays["link_counts"], arrays["deleted"],
                            arrays["n_nodes"], device=dev)


def _walk_pair(graph, qs, **kw):
    """(the kernel's walk, the plain twin's) on the card."""
    from pg_embedding_tpu_torch.core.search import _search_batch
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    before = cg.LAUNCHES["beam_walk"]
    got = cg.beam_walk(graph, qs, **kw)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["beam_walk"] == before + 1
    twin = dict(kw)
    twin["pcodes"] = twin.pop("records", None)
    want = _search_batch(graph, qs, **twin)
    return got, want


def _assert_bit_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("metric", ["l2", "manhattan"])
@pytest.mark.parametrize("ef,cap", QUEUES)
@pytest.mark.parametrize("width", [1, 4, 8])
def test_beam_walk_bit_equal_on_integers(cuda, int_graphs, metric, width, ef,
                                         cap):
    arrays, qs = int_graphs[metric]
    g = _card_graph(arrays, cuda)
    got, want = _walk_pair(g, torch.from_numpy(qs).to(cuda), ef=ef,
                           metric_value=METRICS[metric], cand_cap=cap,
                           expand_width=width)
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())


@pytest.mark.parametrize("case", ["B=1", "B=1000", "empty", "one node",
                                  "ef=320", "ef=321", "ef=4096",
                                  "ef=4097", "cap=8191", "ef=cap=8191",
                                  "ef=cap=5120 B=1000", "ef=cap=16384"])
def test_beam_walk_edges(cuda, int_graphs, case):
    """Batch sizes, an empty and a one-node graph, the widest queues of the
    table scheme and queues past them in the wide instances (one or both
    wide, up to the widest the API's widening reaches, in shared memory;
    the widening's landing width over 1,000 queries; ef = cand_cap =
    16,384, whose queues leave shared memory for device memory):
    bit-equal to the twin."""
    arrays, qs = int_graphs["l2"]
    arrays = dict(arrays)
    ef = cap = 64
    if case == "B=1":
        qs = qs[:1]
    elif case.endswith("B=1000"):
        qs = integer_data(seed=9, b=1000)[1]
    elif case == "empty":
        arrays["n_nodes"] = 0
        arrays["links"] = np.full_like(arrays["links"], -1)
        arrays["link_counts"] = np.zeros_like(arrays["link_counts"])
    elif case == "one node":
        arrays["n_nodes"] = 1
        arrays["links"] = np.full_like(arrays["links"], -1)
        arrays["link_counts"] = np.zeros_like(arrays["link_counts"])
    else:
        ef, cap = {"ef=320": (320, 320), "ef=321": (321, 64),
                   "ef=4096": (4096, 4096), "ef=4097": (4097, 64),
                   "cap=8191": (64, 8191), "ef=cap=8191": (8191, 8191),
                   "ef=cap=5120 B=1000": (5120, 5120),
                   "ef=cap=16384": (16384, 16384)}[case]
        from pg_embedding_tpu_torch.ops import cuda_graph as cg
        in_device = cg._walk_wide_words(ef, cap, 4, arrays["links"].shape[1],
                                        D, 64, False, None) > 0
        assert in_device == (ef == 16384)
    g = _card_graph(arrays, cuda)
    got, want = _walk_pair(g, torch.from_numpy(qs).to(cuda), ef=ef,
                           metric_value=0, cand_cap=cap, expand_width=4)
    _assert_bit_equal(got, want)
    if case == "empty":
        assert bool((got[1] == -1).all()) and bool((got[2] == 0).all())
    if case == "one node":
        assert bool((got[1][:, 0] == 0).all() and (got[1][:, 1:] == -1).all())
        assert bool((got[2] == 1).all()) and bool((got[3] == 0).all())


@pytest.mark.parametrize("metric", ["l2", "manhattan"])
@pytest.mark.parametrize("width,ef,cap", [(16, 64, 64), (16, 32, 128),
                                          (8, 64, 64), (320, 320, 320),
                                          (64, 4096, 4096)])
def test_beam_walk_repeated_links(cuda, int_graphs, metric, width, ef, cap):
    """Links that repeat within a popped row and across the rows of a
    step, at T = 16 (up to 256 slots, the 256-thread block), at T = 320
    with ef = cand_cap = 320 (5,120 slots), where the dedupe tables do
    not fit and the kernel compares instead, and at T = 64 with ef =
    cand_cap = 4096 in the wide instances (1,024 slots, four a thread):
    bit-equal to the twin."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs[metric]
    arrays = repeated_links(arrays)
    g = _card_graph(arrays, cuda)
    held = cg._walk_layout(ef, cap, width, g.max_m, D, None)[1]
    assert (held == 0) == (ef >= cg.MAX_WALK_QUEUE)
    assert (width == 320) == (held == 0 and ef <= cg.MAX_WALK_QUEUE)
    got, want = _walk_pair(g, torch.from_numpy(qs).to(cuda), ef=ef,
                           metric_value=METRICS[metric], cand_cap=cap,
                           expand_width=width)
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("visited", list(VISITED))
@pytest.mark.parametrize("metric", ["l2", "manhattan"])
@pytest.mark.parametrize("width,ef,cap", [(1, 16, 16), (4, 64, 128),
                                          (8, 64, 128), (4, 5120, 5120)])
def test_beam_walk_variants_bit_equal(cuda, int_graphs, monkeypatch, source,
                                      visited, metric, width, ef, cap):
    """Every row source under every visited set on the integer fixture:
    the kernel's ids, distances, hops and dist_evals equal the twin's on
    the card on the same operands (the twin writes the hash set's colliding
    ids deterministically, the highest slot winning), before and after
    finish_walk; the launch is counted under the variant's name.  At ef =
    cand_cap = 5120 (where the API's widening from ef_search 40 lands) the
    queues live in device memory.  A set in a table instance is walked in
    the placement the rule takes (shared memory, or device memory where
    it would cost an SM a block: the hash set beside a PQ table or staged
    rows at T = 8) and again in the other one, forced: the same answers;
    the wide instances keep it in device memory."""
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs[metric]
    g, q, kw = integer_operands(arrays, qs, source)
    walk = dict(ef=ef, metric_value=METRICS[metric], cand_cap=cap,
                expand_width=width, visited_slots=VISITED[visited])
    gc, kc = on_device(g, kw, cuda)
    q = q.to(cuda)
    name = f"{source}, {visited}"
    src = cg._check_walk_args(gc, q, ef, cap, width, METRICS[metric],
                              visited_slots=VISITED[visited], **kc)
    table_set = visited != "dense" and ef <= cg.MAX_WALK_QUEUE
    shared = cg._walk_launch(gc, src, ef, cap, width,
                             VISITED[visited]).visited_shared
    assert shared == (table_set and cg._walk_plan(
        ef, cap, width, gc.max_m, D, src.pq, gc.capacity, False, src.stage,
        cg._visited_words(gc, VISITED[visited]))[4])
    # float32 rows: every set is shared but the 8,192-slot hash set at
    # (64, 128) and T = 4 or 8, whose 5 blocks an SM would take more than
    # SET_SM_SMEM with it
    assert shared or not table_set or source != "rows f32" or (
        visited == "hash" and cap == 128 and width > 1)
    before = (cg.LAUNCHES["beam_walk"], cg.WALK_VARIANTS.get(name, 0))
    got = cg.beam_walk(gc, q, **walk, **kc)
    torch.cuda.synchronize()
    assert (cg.LAUNCHES["beam_walk"], cg.WALK_VARIANTS[name]) == (
        before[0] + 1, before[1] + 1)
    want = ts._search_batch(gc, q, **walk, **on_device(g, kw, cuda,
                                                        twin=True)[1])
    _assert_bit_equal(got, want)
    fin = dict(metric_value=METRICS[metric], hashed=VISITED[visited] > 0,
               rerank=source not in ("rows f32", "rows bf16", "records f32"))
    _assert_bit_equal(ts.finish_walk(gc, q, *got[:2], **fin),
                      ts.finish_walk(gc, q, *want[:2], **fin))
    assert bool((got[2] > 1).all())
    if table_set:
        if shared:
            sets_in_device_memory(monkeypatch)
        else:
            sets_in_shared_memory(monkeypatch)
        assert cg._walk_launch(gc, src, ef, cap, width,
                               VISITED[visited]).visited_shared != shared
        _assert_bit_equal(cg.beam_walk(gc, q, **walk, **kc), want)


@pytest.mark.parametrize("source", ["records int8", "records bf16"])
@pytest.mark.parametrize("case", ["T=1", "T=8", "wide", "past the room",
                                  "unaligned base"])
def test_records_staging_placements(cuda, int_graphs, source, case):
    """The int8 and bf16 records walks where phase 1 stages each popped
    row's record in shared memory (T 1 and 8 at (64, 128), the wide
    instance at (5120, 5120)) and where it does not: T = 256 at (256, 256),
    whose popped records do not fit beside the block's queues and tables,
    and records whose base is 8 bytes off 16 (the bulk copy's alignment),
    read from the records as before.  Each is bit-equal to the twin (ids,
    distances, hops, dist_evals) under L2."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["l2"]
    g, q, kw = integer_operands(arrays, qs, source)
    width, ef, cap = {"T=1": (1, 64, 128), "T=8": (8, 64, 128),
                      "wide": (4, 5120, 5120), "past the room": (256, 256,
                                                                 256),
                      "unaligned base": (8, 64, 128)}[case]
    gc, kc = on_device(g, kw, cuda)
    if case == "unaligned base":
        rec = kc["records"]
        pad = 8 // rec.element_size()
        buf = torch.empty(rec.numel() + pad, dtype=rec.dtype, device=cuda)
        kc["records"] = buf[pad:].view(rec.shape)
        kc["records"].copy_(rec)
        assert kc["records"].data_ptr() % 16 == 8
    walk = dict(ef=ef, metric_value=0, cand_cap=cap, expand_width=width)
    stage = cg._check_walk_args(gc, q.to(cuda), ef, cap, width, 0,
                                **kc).stage
    staged = cg.records_staging(ef, cap, width, gc.max_m, gc.dims, stage)
    assert (staged > 0) == (case not in ("past the room", "unaligned base"))
    got, want = _walk_pair(gc, q.to(cuda)[:64], **walk, **kc)
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())


# the int8 / bf16 rows walks' placements on the integer fixture: (T, ef,
# cand_cap) staged in a table instance and the wide one, past the room (T =
# 256 popped rows' slots do not fit beside the queues and tables), and
# rows whose base is 8 bytes off 16 (read from the rows)
ROW_PLACEMENTS = {"T=4": (4, 64, 128), "T=8": (8, 64, 128),
                  "wide": (4, 5120, 5120), "past the room": (256, 256, 256),
                  "unaligned base T=4": (4, 64, 128),
                  "unaligned base T=8": (8, 64, 128)}


@pytest.mark.parametrize("source", ["rows int8", "rows bf16"])
@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("case", list(ROW_PLACEMENTS))
def test_rows_staging_placements(cuda, int_graphs, source, metric, case):
    """The int8 rows (x scales) and bf16 corpus rows walks where phase 2
    stages each processed slot's row in shared memory as the dedupe keeps
    it (T 4 and 8 at (64, 128), the wide instance at (5120, 5120)) and
    where it does not (T = 256 at (256, 256); rows whose base is 8 bytes
    off 16, at T 4 and 8), under L2, cosine (bf16 rows: |p|^2 rounded to bf16, the
    staged instance's round_pp) and Manhattan: each bit-equal to the twin
    (ids, distances, hops, dist_evals)."""
    import dataclasses
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["manhattan" if metric == "manhattan" else "l2"]
    g, q, kw = integer_operands(arrays, qs, source)
    width, ef, cap = ROW_PLACEMENTS[case]
    gc, kc = on_device(g, kw, cuda)
    if case.startswith("unaligned base"):
        rows = kc["qvectors"] if source == "rows int8" else gc.vectors
        pad = 8 // rows.element_size()
        buf = torch.empty(rows.numel() + pad, dtype=rows.dtype, device=cuda)
        off = buf[pad:].view(rows.shape)
        off.copy_(rows)
        assert off.data_ptr() % 16 == 8
        if source == "rows int8":
            kc["qvectors"] = off
        else:
            gc = dataclasses.replace(gc, vectors=off)
    qc = q.to(cuda)[:64]
    stage = cg._check_walk_args(gc, qc, ef, cap, width, METRICS[metric],
                                **kc).stage
    assert stage.rows
    staged = cg.records_staging(ef, cap, width, gc.max_m, gc.dims, stage)
    assert (staged > 0) == (case in ("T=4", "T=8", "wide"))
    got, want = _walk_pair(gc, qc, ef=ef, metric_value=METRICS[metric],
                           cand_cap=cap, expand_width=width, **kc)
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())


@pytest.mark.parametrize("source", ["records int8", "records bf16",
                                    "rows int8", "rows bf16", "records f32"])
def test_records_walk_takes_the_launchs_placement(cuda, int_graphs, source):
    """A records or rows walk that can stage is staged or not as the
    shared bytes the launch passes say (ops/cuda_graph._records_place's
    choice): both bit-equal to the twin, an SM holds a positive number of
    blocks of each instance (the runtime's occupancy, beam_walk_blocks),
    and a figure that is neither layout is refused."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.graph_probe import walk, walk_blocks
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["l2"]
    g, q, kw = integer_operands(arrays, qs, source)
    gc, kc = on_device(g, kw, cuda)
    qc = q.to(cuda)[:64]
    lib = _kernels.load_library()
    shape = dict(ef=64, cand_cap=128, t=8, metric_value=0)
    _, want = _walk_pair(gc, qc, ef=64, metric_value=0, cand_cap=128,
                         expand_width=8, **kc)
    src = cg._check_walk_args(gc, qc, 64, 128, 8, 0, **kc)
    plain = cg._walk_smem_bytes(64, 128, 8, gc.max_m, gc.dims, None)
    rec = cg.records_staging(64, 128, 8, gc.max_m, gc.dims, src.stage)
    assert rec > 0
    for staged, smem in ((True, plain + rec), (False, plain)):
        _assert_bit_equal(walk(lib, gc, qc, **shape, staged=staged, **kc),
                          want)
        assert walk_blocks(lib, src.elem, staged, 8, gc.max_m, smem) > 0
    with pytest.raises(RuntimeError):
        cg._launch_walk(lib, gc, qc, src, **shape,
                        plan=cg.WalkLaunch(plain + rec + 16, False, 0, 0))


# the float32 records ring on the integer fixture (maxM 16, D 32): the
# rule's ring, T maxM rows, which holds every step's processed rows, and a
# ring of RING_SMALL rows (graph_probe.walk's ``ring``: a launch of fewer
# shared bytes), which steps that process more rows overflow
RING_SMALL = 4


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("visited", list(VISITED))
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("ring", ["holds every step", "overflows"])
def test_float32_records_ring_bit_equal(cuda, int_graphs, metric, visited,
                                        width, ring):
    """The float32 records walk through its ring (kElemF32Staged: phase 2
    copies the first K processed slots' record rows to shared memory, L2
    is asked for the rest, phase 3 reads the ring below K and the records
    past it) under L2, cosine and Manhattan, the dense dedupe and the
    bitmap and hash sets, at T 4 and 8, at ef = 64, cand_cap = 128: its
    ids, distances, hops and dist_evals equal the twin's on the card.  The
    rule's ring (through the wrapper, counted under its variant) holds T
    maxM rows (its launch counted in RING_WALKS); the small one is
    overflowed by some query's steps (its dist_evals a hop pass
    RING_SMALL)."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.graph_probe import walk
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["manhattan" if metric == "manhattan" else "l2"]
    g, q, kw = integer_operands(arrays, qs, "records f32")
    gc, kc = on_device(g, kw, cuda)
    qc = q.to(cuda)
    slots = VISITED[visited]
    shape = dict(ef=64, metric_value=METRICS[metric], cand_cap=128,
                 visited_slots=slots)
    src = cg._check_walk_args(gc, qc, 64, 128, width, METRICS[metric],
                              visited_slots=slots, **kc)
    tm = width * gc.max_m
    assert src.stage == cg.RecordsStage(4, False, True, False, tm)
    assert cg.records_staging(64, 128, width, gc.max_m, gc.dims,
                              src.stage) == tm * 4 * gc.dims
    if ring == "overflows":
        got = walk(_kernels.load_library(), gc, qc, t=width,
                   ring=RING_SMALL, **shape, **kc)
    else:
        name = f"records f32, {visited}"
        before = cg.WALK_VARIANTS.get(name, 0), cg.RING_WALKS
        got = cg.beam_walk(gc, qc, expand_width=width, **shape, **kc)
        assert (cg.WALK_VARIANTS[name], cg.RING_WALKS) == (
            before[0] + 1, before[1] + 1)
    want = ts._search_batch(gc, qc, expand_width=width, **shape,
                            **on_device(g, kw, cuda, twin=True)[1])
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())
    per_hop = got[3].float() / got[2].float()
    if ring == "overflows":
        assert bool((per_hop > RING_SMALL).any())


@pytest.mark.parametrize("case", ["wide", "unaligned base", "256 threads"])
def test_float32_records_without_a_ring(cuda, int_graphs, case):
    """Float32 records read from the records where no ring is placed: the
    wide instances (ef = cand_cap = 5120), records whose base is 8 bytes
    off 16 (the bulk copy's alignment) and a 256-thread block (T = 16 at
    maxM 16), where the rule keeps no ring: bit-equal to the twin.  The
    256-thread ring instance, reached by a forced placement (graph_probe
    walk's "forced": a whole step's rows, and 8 rows, which steps
    overflow), is bit-equal too."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.graph_probe import walk
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["l2"]
    g, q, kw = integer_operands(arrays, qs, "records f32")
    gc, kc = on_device(g, kw, cuda)
    width, ef, cap = {"wide": (4, 5120, 5120), "unaligned base": (8, 64, 128),
                      "256 threads": (16, 64, 128)}[case]
    if case == "unaligned base":
        rec = kc["records"]
        buf = torch.empty(rec.numel() + 2, dtype=rec.dtype, device=cuda)
        kc["records"] = buf[2:].view(rec.shape)
        kc["records"].copy_(rec)
        assert kc["records"].data_ptr() % 16 == 8
    qc = q.to(cuda)[:64]
    stage = cg._check_walk_args(gc, qc, ef, cap, width, 0, **kc).stage
    assert cg.records_staging(ef, cap, width, gc.max_m, gc.dims, stage) == 0
    rings = cg.RING_WALKS
    got, want = _walk_pair(gc, qc, ef=ef, metric_value=0, cand_cap=cap,
                           expand_width=width, **kc)
    assert cg.RING_WALKS == rings
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())
    if case == "256 threads":
        assert cg._walk_threads(width, gc.max_m) == 256
        lib = _kernels.load_library()
        for rows in (None, 8):
            _assert_bit_equal(walk(lib, gc, qc, ef=ef, cand_cap=cap, t=width,
                                   metric_value=0, staged="forced",
                                   ring=rows, **kc), want)


@pytest.mark.parametrize("dims,groups", [(32, 2), (32, 4), (32, 16),
                                         (32, 32), (24, 3)])
@pytest.mark.parametrize("source", ["records pq", "records pq rotated"])
@pytest.mark.parametrize("metric", ["l2", "manhattan"])
@pytest.mark.parametrize("width,ef,cap", [(8, 64, 128), (4, 5120, 5120)])
def test_pq_walk_table_bit_equal_by_groups(cuda, int_graphs, dims, groups,
                                           source, metric, width, ef, cap):
    """The PQ walk reads each row's codes through the query's distance
    table in shared memory, at the group widths beside G = 8's (which
    test_beam_walk_variants_bit_equal walks): D = 32 at G = 2 (16
    elements a group, each record's codes copied byte by byte), 4 (8), 16
    (2: the table's build reads the codebook an element at a time) and 32
    (1), and D = 24 (the fixture's first 24 dims) at G = 3, with and
    without OPQ's signed permutation, in a table instance and the wide one
    (5120, 5120): on integer codebooks its ids, distances, hops and
    dist_evals equal the twin's decode-then-distance walk."""
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs[metric]
    arrays = dict(arrays, vectors=np.ascontiguousarray(
        arrays["vectors"][:, :dims]))
    qs = np.ascontiguousarray(qs[:, :dims])
    g, q, kw = integer_operands(arrays, qs, source, groups=groups)
    assert kw["pq_codebook"].shape == (groups, 256, dims // groups)
    walk = dict(ef=ef, metric_value=METRICS[metric], cand_cap=cap,
                expand_width=width)
    gc, kc = on_device(g, kw, cuda)
    q = q.to(cuda)
    got = cg.beam_walk(gc, q, **walk, **kc)
    torch.cuda.synchronize()
    want = ts._search_batch(gc, q, **walk, **on_device(g, kw, cuda,
                                                        twin=True)[1])
    _assert_bit_equal(got, want)
    assert bool((got[2] > 1).all())


@pytest.mark.parametrize("groups", [8, 32])
@pytest.mark.parametrize("width,ef,cap", [(8, 64, 64), (4, 5120, 5120)])
def test_pq_walk_table_cosine(cuda, int_graphs, groups, width, ef, cap):
    """Cosine through the PQ table (a float2 an entry: the dot product and
    the centroid's sum of squares): rsqrt is not the CPU's, so ids, hops
    and evals equal the twin's on >= 99% of queries, every other one at a
    near-tie, as for the float32 rows."""
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, _ = int_graphs["l2"]
    qs = integer_data(seed=10, b=256)[1]
    g, q, kw = integer_operands(arrays, qs, "records pq", groups=groups)
    walk = dict(ef=ef, metric_value=1, cand_cap=cap, expand_width=width)
    gc, kc = on_device(g, kw, cuda)
    q = q.to(cuda)
    got = cg.beam_walk(gc, q, **walk, **kc)
    want = ts._search_batch(gc, q, **walk, **on_device(g, kw, cuda,
                                                        twin=True)[1])
    (dk, ik, hk, ek), (dp, ip, hp, ep) = [[x.cpu().numpy() for x in r]
                                          for r in (got, want)]
    same = (ik == ip).all(axis=1) & (hk == hp) & (ek == ep)
    assert same.mean() >= 0.99, same.mean()

    def near_tie(row):
        d = np.sort(row[np.isfinite(row)])
        return bool(np.any(np.diff(d) <= 1e-5 * np.abs(d[1:])))
    for i in np.nonzero(~same)[0]:
        assert near_tie(dk[i]) or near_tie(dp[i]), i
    np.testing.assert_allclose(dk[same], dp[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric,groups", list(WIDE_ROW_PQ))
@pytest.mark.parametrize("ef", [64, 5120])
def test_pq_walk_at_wide_rows(cuda, metric, groups, ef):
    """PQ walks whose table and staged codes do not both fit a block
    (1536-d, T = 8, maxM = 32): cosine at G = 96 and L2 at G = 192 keep the
    table in shared memory and read each row's codes from the records;
    cosine at G = 192 and L2 at G = 384 build the table in the query's
    device memory; in a table instance (ef = cand_cap = 64) and the wide
    one (5120).  On integer codebooks the L2 walk's ids, distances, hops
    and dist_evals equal the twin's; cosine's rsqrt is not the CPU's, so
    its ids, hops and evals equal the twin's on >= 98% of queries, every
    other one at a near-tie."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    m = METRICS[metric]
    g, q, kw = wide_row_operands(groups, b=128 if ef == 64 else 32)
    words = [cg._walk_wide_words(ef, ef, 8, g.max_m, g.dims, g.capacity,
                                 True, pq)
             for pq in (None, cg.PqTable(groups, m))]
    table_words = 256 * groups * (2 if metric == "cosine" else 1)
    assert (words[1] - words[0] >= table_words) == (
        WIDE_ROW_PQ[metric, groups] == "device")
    walk = dict(ef=ef, metric_value=m, cand_cap=ef, expand_width=8)
    gc, kc = on_device(g, kw, cuda)
    q = q.to(cuda)
    got, want = _walk_pair(gc, q, **walk, **kc)
    if metric == "l2":
        _assert_bit_equal(got, want)
        assert bool((got[2] > 1).all())
        return
    (dk, ik, hk, ek), (dp, ip, hp, ep) = [[x.cpu().numpy() for x in r]
                                          for r in (got, want)]
    same = (ik == ip).all(axis=1) & (hk == hp) & (ek == ep)
    assert same.mean() >= 0.98, same.mean()

    def near_tie(row):
        d = np.sort(row[np.isfinite(row)])
        return bool(np.any(np.diff(d) <= 1e-5 * np.abs(d[1:])))
    for i in np.nonzero(~same)[0]:
        assert near_tie(dk[i]) or near_tie(dp[i]), i
    np.testing.assert_allclose(dk[same], dp[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("visited", list(VISITED))
def test_wide_walks_in_a_row(cuda, int_graphs, visited):
    """Two wide walks in a row at (5120, 5120) on other queries, then the
    first again (the wrapper zeroes each launch's held set): every walk is
    bit-equal to the twin."""
    arrays, _ = int_graphs["l2"]
    g = _card_graph(arrays, cuda)
    walk = dict(ef=5120, metric_value=0, cand_cap=5120, expand_width=8,
                visited_slots=VISITED[visited])
    for seed in (11, 12, 11):
        q = torch.from_numpy(integer_data(seed=seed, b=96)[1]).to(cuda)
        got, want = _walk_pair(g, q, **walk)
        _assert_bit_equal(got, want)
        assert bool((got[2] > 1).all())


def test_widening_past_4096_runs_the_kernel(cuda):
    """A filtered graph search that widens from ef_search = 40 to 5120 (past
    MAX_WALK_QUEUE) runs every walk in the kernel, none in the twin, and
    finds the masked exact sweep's answers."""
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    rng = np.random.default_rng(14)
    pts = rng.normal(size=(5000, 32)).astype(np.float32)
    qs = rng.normal(size=(8, 32)).astype(np.float32)
    idx = HnswIndex(HnswConfig(dims=32, m=8, ef_construction=32,
                               ef_search=40), device=cuda)
    idx.build(pts)
    where = np.zeros(5000, bool)
    where[rng.choice(5000, 12, replace=False)] = True
    plain, launches = ts.PLAIN_WALKS_ON_CARD, cg.LAUNCHES["beam_walk"]
    widenings = idx.counters["n_widenings"]
    d, l, v = idx.search(qs, 10, mode="graph", where=where)
    assert idx.counters["n_widenings"] - widenings == 7     # 40 -> 5120
    assert cg.LAUNCHES["beam_walk"] - launches == 8
    assert ts.PLAIN_WALKS_ON_CARD == plain
    de, le, ve = idx.search(qs, 10, mode="exact", where=where)
    assert bool(v.all()) and bool(ve.all())
    assert (np.sort(l, axis=1) == np.sort(le, axis=1)).all()


def test_beam_walk_small_hash_table(cuda, int_graphs, monkeypatch):
    """A 64-slot hash table: ids collide on a slot within a step, entries
    are overwritten and walks re-expand nodes (their dist_evals leave the
    dense walk's); bit-equal to the twin on the card, where the highest
    slot's write wins as it does on the CPU, with the table in the block's
    shared memory (the rule's placement: 256 bytes) and forced into device
    memory."""
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    for device in (False, True):
        if device:
            sets_in_device_memory(monkeypatch)
        for metric in ("l2", "manhattan"):
            arrays, qs = int_graphs[metric]
            g = _card_graph(arrays, cuda)
            q = torch.from_numpy(qs).to(cuda)
            for width in (1, 4, 8):
                walk = dict(ef=32, metric_value=METRICS[metric],
                            cand_cap=32, expand_width=width,
                            visited_slots=64)
                src = cg._check_walk_args(g, q, 32, 32, width,
                                          METRICS[metric], visited_slots=64)
                assert cg._walk_launch(g, src, 32, 32, width,
                                       64).visited_shared != device
                got, want = _walk_pair(g, q, **walk)
                _assert_bit_equal(got, want)
                dense = ts._search_batch(g, q, **dict(walk,
                                                      visited_slots=-1))
                assert bool((want[3] != dense[3]).any())
                cpu = ts._search_batch(on_device(g, {}, "cpu")[0], q.cpu(),
                                       **walk)
                _assert_bit_equal([x.cpu() for x in want], cpu)


@pytest.mark.parametrize("visited_slots,ef", [(0, 32), (8192, 32),
                                               (-1, 5120), (0, 5120)])
def test_beam_walk_chunks_the_visited_sets(cuda, int_graphs, monkeypatch,
                                           visited_slots, ef):
    """A batch whose visited sets in device memory and wide queues pass
    SCRATCH_BYTES is walked in chunks of queries, a launch each, with the
    answers of one launch.  The fixture's sets at ef 32 fit the block's
    shared memory, so those cases force them into device memory."""
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["l2"]
    g, q, _ = integer_operands(arrays, qs, "rows f32")
    g, _ = on_device(g, {}, cuda)
    q = q.to(cuda)
    walk = dict(ef=ef, metric_value=0, cand_cap=ef, expand_width=4,
                visited_slots=visited_slots)
    if visited_slots >= 0 and ef <= cg.MAX_WALK_QUEUE:
        sets_in_device_memory(monkeypatch)
    whole = cg.beam_walk(g, q, **walk)
    words = cg._walk_wide_words(ef, ef, 4, g.max_m, D, g.capacity,
                                visited_slots < 0, None) + (
        cg._visited_words(g, visited_slots) if visited_slots >= 0 else 0)
    src = cg._check_walk_args(g, q, ef, ef, 4, 0, visited_slots=visited_slots)
    assert cg._walk_launch(g, src, ef, ef, 4, visited_slots).words == words
    monkeypatch.setattr(cg, "SCRATCH_BYTES", 4 * words * 10)
    before = cg.LAUNCHES["beam_walk"]
    got = cg.beam_walk(g, q, **walk)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["beam_walk"] == before + -(-len(qs) // 10)
    _assert_bit_equal(got, whole)


@pytest.mark.parametrize("visited_slots", [0, 8192])
def test_shared_set_takes_no_device_set(cuda, int_graphs, monkeypatch,
                                        visited_slots):
    """A walk whose visited set is in the block's shared memory allocates
    no device set (the blocks fill their own); one forced into device
    memory has the wrapper fill one a launch.  Both bit-equal to the twin;
    a launch that names the other placement (shared bytes counting the set
    beside a device set, or a device layout without one) is refused.  At
    (ef, cand_cap) = (16, 16), T = 8 the rule keeps both sets shared (at
    (64, 128) the 8,192-slot one would take more than SET_SM_SMEM an
    SM)."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["l2"]
    g = _card_graph(arrays, cuda)
    q = torch.from_numpy(qs).to(cuda)
    fills = []
    fill = cg._device_visited
    monkeypatch.setattr(cg, "_device_visited",
                        lambda *a: fills.append(a) or fill(*a))
    walk = dict(ef=16, metric_value=0, cand_cap=16, expand_width=8,
                visited_slots=visited_slots)
    got, want = _walk_pair(g, q, **walk)
    _assert_bit_equal(got, want)
    assert fills == []
    src = cg._check_walk_args(g, q, 16, 16, 8, 0,
                              visited_slots=visited_slots)
    plan = cg._walk_launch(g, src, 16, 16, 8, visited_slots)
    assert plan.visited_shared and plan.words == 0
    lib = _kernels.load_library()
    shape = dict(ef=16, cand_cap=16, t=8, metric_value=0,
                 visited_slots=visited_slots)
    plain = cg._walk_smem_bytes(16, 16, 8, g.max_m, D, None)
    words = cg._visited_words(g, visited_slots)
    for wrong in (cg.WalkLaunch(plan.smem, False, 0, words),
                  cg.WalkLaunch(plain, True, 0, 0)):
        with pytest.raises(RuntimeError):
            cg._launch_walk(lib, g, q, src, plan=wrong, **shape)
    assert len(fills) == 1
    sets_in_device_memory(monkeypatch)
    got = cg.beam_walk(g, q, **walk)
    _assert_bit_equal(got, want)
    assert len(fills) == 2 and fills[-1][:2] == (len(q),
                                                 cg._visited_words(
                                                     g, visited_slots))


def test_beam_walk_bf16_rows_cosine(cuda, int_graphs):
    """Cosine over bf16 corpus rows: |p|^2 rounded to bf16 as the twin's
    _sum_sq rounds it; ids, hops and evals equal on >= 99% of queries,
    every other one at a near-tie (rsqrt is not the CPU's)."""
    arrays, _ = int_graphs["l2"]
    qs = integer_data(seed=10, b=1000)[1]
    g, q, _ = integer_operands(arrays, qs, "rows bf16")
    gc, _ = on_device(g, {}, cuda)
    for width in (1, 8):
        got, want = _walk_pair(gc, q.to(cuda), ef=64, metric_value=1,
                               cand_cap=64, expand_width=width)
        (dk, ik, hk, ek), (dp, ip, hp, ep) = [[x.cpu().numpy() for x in r]
                                              for r in (got, want)]
        same = (ik == ip).all(axis=1) & (hk == hp) & (ek == ep)
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(dk[same], dp[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [1, 4, 8])
def test_beam_walk_cosine(cuda, int_graphs, width):
    """Cosine scores are not exact: ids, hops and evals equal on >= 99% of
    queries, every other one at a near-tie."""
    arrays, _ = int_graphs["l2"]
    qs = integer_data(seed=10, b=1000)[1]
    g = _card_graph(arrays, cuda)
    got, want = _walk_pair(g, torch.from_numpy(qs).to(cuda), ef=64,
                           metric_value=1, cand_cap=64, expand_width=width)
    (dk, ik, hk, ek), (dp, ip, hp, ep) = [[x.cpu().numpy() for x in r]
                                          for r in (got, want)]
    same = (ik == ip).all(axis=1) & (hk == hp) & (ek == ep)
    assert same.mean() >= 0.99, same.mean()

    def near_tie(row):
        d = np.sort(row[np.isfinite(row)])
        return bool(np.any(np.diff(d) <= 1e-5 * np.abs(d[1:])))
    for q in np.nonzero(~same)[0]:
        assert near_tie(dk[q]) or near_tie(dp[q]), q
    np.testing.assert_allclose(dk[same], dp[same], rtol=1e-5, atol=1e-5)


def test_packed_f32_walk_equals_rows_walk(cuda):
    """float32 records hold the rows' own values, so the kernel's walk over
    them gives the rows walk's ids, distances and counters bit for bit
    (gaussian data: the equality does not rest on exact sums)."""
    from pg_embedding_tpu_torch.core.graph import pack_records
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(4000, 48)).astype(np.float32)
    qs = torch.from_numpy(rng.normal(size=(300, 48)).astype(np.float32))
    idx = HnswIndex(HnswConfig(dims=48, m=8, ef_construction=32,
                               ef_search=32), device=cuda)
    idx.build(pts)
    g = idx.graph
    recs = pack_records(g.vectors, g.links)
    for metric in (0, 1, 2):
        kw = dict(ef=48, metric_value=metric, cand_cap=64, expand_width=4)
        rows = cg.beam_walk(g, qs.to(cuda), **kw)
        packed = cg.beam_walk(g, qs.to(cuda), records=recs, **kw)
        _assert_bit_equal(packed, rows)


@pytest.mark.parametrize("c,nn", [(1, 1), (31, 16), (33, 32), (33, 16),
                                  (129, 16), (129, 1), (20, 32), (300, 24)])
@pytest.mark.parametrize("b", [1, 301])
@pytest.mark.parametrize("symmetric", [True, False])
def test_prune_scan_adversarial(cuda, c, nn, b, symmetric):
    """Ties, repeated ids, invalid and empty sets, unpruned sets, nn = 1,
    C off the warp's width, B = 1 and B odd (a block holds two sets), a
    pair matrix that is not symmetric, sets past 256 candidates (their bits
    in shared memory, not registers): the wrapper bit-equal to the twin."""
    from pg_embedding_tpu_torch.core import build as tb
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    cand_d, cand_i, pair = prune_case_adversarial(c * 11 + nn, max(b, 8), c,
                                                  symmetric)
    cand_d, cand_i, pair = cand_d[:b], cand_i[:b], pair[:b]
    _, order, d_s, valid_s, do_prune = tb._prune_order(cand_d, cand_i, nn)
    want = tb._prune_scan_plain(d_s, valid_s, order, pair, do_prune, nn)
    args = [x.to(cuda).contiguous() for x in (d_s, valid_s, order, pair,
                                              do_prune)]
    got = cg.prune_scan(*args, nn)
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)


@pytest.mark.parametrize("c", [33, 128, 256])
@pytest.mark.parametrize("nn", [16, 32])
def test_prune_scan_bit_equal(cuda, c, nn):
    from pg_embedding_tpu_torch.core import build as tb
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    cand_d, cand_i, pair = prune_case(c + nn, 300, c)
    _, order, d_s, valid_s, do_prune = tb._prune_order(cand_d, cand_i, nn)
    want = tb._prune_scan_plain(d_s, valid_s, order, pair, do_prune, nn)
    before = cg.LAUNCHES["prune_scan"]
    shape = cg.PRUNE_SHAPES.get((c, nn), 0)
    got = cg.prune_scan(*(x.to(cuda) for x in (d_s, valid_s, order, pair,
                                               do_prune)), nn)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["prune_scan"] == before + 1
    assert cg.PRUNE_SHAPES[c, nn] == shape + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    plain_card = tb._prune_scan_plain(*(x.to(cuda) for x in (
        d_s, valid_s, order, pair, do_prune)), nn)
    for a, b in zip(got, plain_card):
        assert torch.equal(a, b)
    assert not bool(do_prune.all()) and bool((want[1] < nn).any())


def test_graph_route_launches_beam_walk(cuda):
    """search(mode="graph") on a small index: the walk kernel, no plain
    walk, and the CPU index's answers (near-ties aside); the build ran the
    prune kernel."""
    from pg_embedding_tpu_torch.core import search as ts
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    qs = rng.normal(size=(64, 32)).astype(np.float32)
    cfg = HnswConfig(dims=32, m=8, ef_construction=32, ef_search=32)
    before = dict(cg.LAUNCHES)
    gpu = HnswIndex(cfg, device=cuda)
    gpu.build(pts)
    assert cg.LAUNCHES["prune_scan"] > before["prune_scan"]
    plain = ts.PLAIN_WALKS_ON_CARD
    d, l, v = gpu.search(qs, 10, mode="graph")
    assert cg.LAUNCHES["beam_walk"] > before["beam_walk"]
    assert ts.PLAIN_WALKS_ON_CARD == plain
    cpu = HnswIndex(cfg, device="cpu")
    cpu.build(pts)
    dc, lc, vc = cpu.search(qs, 10, mode="graph")
    assert (l == lc).mean() >= 0.95


def test_walk_and_prune_refuse_out_of_scope_arguments(cuda, int_graphs):
    """What the kernels do not take raises on the card, and the C side
    refuses a shared-memory figure other than its own."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, qs = int_graphs["l2"]
    g = _card_graph(arrays, cuda)
    q = torch.from_numpy(qs).to(cuda)
    kw = dict(ef=16, metric_value=0, cand_cap=16, expand_width=4)
    for bad in (dict(ef=cg.MAX_WIDE_QUEUE + 1), dict(expand_width=32),
                dict(metric_value=3)):
        with pytest.raises(ValueError):
            cg.beam_walk(g, q, **dict(kw, **bad))
    with pytest.raises(ValueError):
        cg.beam_walk(g, q.double(), **kw)
    gb = _card_graph(arrays, cuda)
    gb.vectors = gb.vectors.to(torch.float16)
    with pytest.raises(ValueError, match="float32"):
        cg.beam_walk(gb, q, **kw)
    with pytest.raises(ValueError, match="float32"):
        cg.beam_walk(g, q, records=torch.zeros(
            (g.capacity, g.max_m, D), dtype=torch.float16, device=cuda),
            **kw)
    with pytest.raises(ValueError, match="power of 2"):
        cg.beam_walk(g, q, visited_slots=2, **kw)
    lib = _kernels.load_library()
    smem = cg._walk_smem_bytes(16, 16, 4, g.max_m, D, None)
    out = torch.empty((len(qs), 16), device=cuda)
    cnt = torch.empty(len(qs), dtype=torch.int32, device=cuda)
    for bad in (smem + 16, smem - 16):
        err = lib.beam_walk(g.links.data_ptr(), g.link_counts.data_ptr(),
                            g.vectors.data_ptr(), None, None, q.data_ptr(),
                            out.data_ptr(), None, None, 0, 0, 1, len(qs), D,
                            g.max_m, 4, 16, 16, 0, 0, -1, 0, g.capacity,
                            bad, 0,
                            out.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                            cnt.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.check(lib, err, "beam_walk")
    z = torch.zeros((4, 8), device=cuda)
    order = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cg.prune_scan(z, z.bool(), order.int(), torch.zeros((4, 8, 8),
                                                            device=cuda),
                      z[:, 0].bool(), 4)
    with pytest.raises(ValueError):
        cg.prune_scan(z, z.bool(), order, torch.zeros((4, 8, 8),
                                                      device=cuda),
                      z[:, 0].bool(), 0)


# --- the build's candidate sweep: the int8 instance and sweep_pool ---------

def shadow_case(seed, n, d, b, pow2=True):
    """An int8 shadow (qvec i8[n, d] in [-127, 127], qscale f32[n]) and
    queries f32[b, d].  With ``pow2`` the scales are powers of two and the
    queries integers in [-8, 8]: every product and partial sum of a score
    is then exact in float32 whatever the order, and |p|^2 stays under
    2^24 units at d = 960; else quantize_rows' scales of normal rows and
    normal queries."""
    rng = np.random.default_rng(seed)
    if pow2:
        qv = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        qs = np.exp2(rng.integers(-3, 4, size=n)).astype(np.float32)
        pts = rng.integers(-8, 9, size=(b, d)).astype(np.float32)
        return torch.from_numpy(qv), torch.from_numpy(qs), torch.from_numpy(
            pts)
    from pg_embedding_tpu_torch.core.build import quantize_rows
    qv, qs = quantize_rows(torch.from_numpy(
        rng.normal(size=(n, d)).astype(np.float32)))
    return qv, qs, torch.from_numpy(rng.normal(size=(b, d)).astype(
        np.float32))


def _assert_pool_bit_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def _assert_pool_near(got, want, rows, pts, metric, rtol):
    """Distances at ``rtol``; ids equal except where both rows' float64
    distances lie within 1e-5 relative of each other."""
    (dk, ik), (dp, ip) = [(d.cpu().numpy(), i.cpu().numpy())
                          for d, i in (got, want)]
    np.testing.assert_array_equal(np.isinf(dk), np.isinf(dp))
    fin = np.isfinite(dp)
    np.testing.assert_allclose(dk[fin], dp[fin], rtol=rtol, atol=1e-6)
    diff = ik != ip
    if diff.any():
        r = rows.double()
        q = pts.double().to(r.device)

        def d64(ids):
            p = r[torch.as_tensor(ids).clamp(min=0).long().to(r.device)]
            if metric == 0:
                return torch.sqrt(((p - q[:, None]) ** 2).sum(-1))
            if metric == 2:
                return (p - q[:, None]).abs().sum(-1)
            return 1 - (p * q[:, None]).sum(-1) / torch.sqrt(
                (p * p).sum(-1) * (q * q).sum(-1)[:, None])
        a, b = d64(ik).cpu().numpy(), d64(ip).cpu().numpy()
        assert np.all(np.abs(a[diff] - b[diff]) <= 1e-5 * np.abs(b[diff]))


@pytest.mark.parametrize("b", [1, 63, 65, 256])
@pytest.mark.parametrize("keep", [130, 256, 1024, 1500])
@pytest.mark.parametrize("base", ["1", "keep-1", "keep", "131075"])
def test_q8_kernel_bit_equal_on_integers(cuda, b, keep, base):
    """The int8 instances (through sweep_pool, pages past 1024) against
    their plain twin on integer rows at power-of-two scales, D = 30 / 960
    (element loads: D % 16 != 0, and 16-byte copies) and 128, L2 bit for
    bit: bruteforce_topk_q8, and at D = 128 up to a pool of 256 the Hopper
    instance the rule takes there (launch_instance names it).  Cosine's
    score rounds 1 - dot * rsqrt once (the sweep's shared epilogue
    contracts it to an FMA) where the twin rounds twice: distances within
    1e-6 relative and ids except at float64 near-ties."""
    n = {"1": 1, "keep-1": keep - 1, "keep": keep, "131075": 131_075}[base]
    for d in (30, 128, 960):
        qv, qs, pts = (t.to(cuda) for t in shadow_case(n + d + keep, n + 37,
                                                      d, b))
        for metric in (0, 1):
            name = cb.launch_instance(pts, (qv, qs), keep, metric,
                                      page=keep > cb.MAX_K_RUN)[0]
            assert name == ("bruteforce_topk_q8_wgmma"
                            if d == 128 and keep <= cb.WIDE_MAX_K
                            else "bruteforce_topk_q8")
            before = cb.LAUNCHES[name]
            got = cb.sweep_pool(pts, (qv, qs), keep, metric, n)
            torch.cuda.synchronize()
            assert cb.LAUNCHES[name] == before + (
                1 if keep <= cb.MAX_K_RUN else 2)
            want = cb._bruteforce_topk_plain(pts, (qv, qs), keep, metric, n)
            live = min(n, keep)
            assert bool((got[1][:, :live] >= 0).all())
            assert bool((got[1][:, live:] == -1).all())
            if metric == 0:
                _assert_pool_bit_equal(got, want)
            else:
                rows = cb.dequantize_rows(qv[:n], qs[:n]).float()
                _assert_pool_near(got, want, rows, pts, metric, 1e-6)


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("d,keep", [(128, 256), (100, 130), (960, 256),
                                    (128, 1500)])
def test_q8_kernel_real_scales(cuda, metric, d, keep):
    """Scales that are not powers of two (quantize_rows of normal rows):
    an element that slipped by one bf16 ulp would move scores far past
    rtol 1e-6."""
    qv, qs, pts = (t.to(cuda) for t in shadow_case(d + keep, 131_075, d,
                                                  256, pow2=False))
    n = 131_000
    got = cb.sweep_pool(pts, (qv, qs), keep, metric, n)
    want = cb._bruteforce_topk_plain(pts, (qv, qs), keep, metric, n)
    rows = cb.dequantize_rows(qv[:n], qs[:n]).float()
    _assert_pool_near(got, want, rows, pts, metric, 1e-6)


def test_q8_kernel_on_shard_views(cuda):
    """Each shard's view of a stacked [S, cap, D] shadow, with its own
    count: a view's base lies s cap D bytes in (not 16-byte aligned at D =
    24), and a D = 128 view that starts one byte in takes element loads
    too."""
    qv, qs, pts = shadow_case(31, 3 * 5003, 24, 65)
    qv, qs = qv.view(3, 5003, 24).to(cuda), qs.view(3, 5003).to(cuda)
    pts = pts.to(cuda)
    for s, n in enumerate((5003, 4000, 17)):
        got = cb.sweep_pool(pts, (qv[s], qs[s]), 256, 0, n)
        _assert_pool_bit_equal(got, cb._bruteforce_topk_plain(
            pts, (qv[s], qs[s]), 256, 0, n))
    qv, qs, pts = (t.to(cuda) for t in shadow_case(32, 9001, 128, 64))
    off = qv.view(-1)[1:1 + 9000 * 128].view(9000, 128)
    got = cb.sweep_pool(pts, (off, qs[:9000]), 256, 0, 8999)
    _assert_pool_bit_equal(got, cb._bruteforce_topk_plain(
        pts, (off, qs[:9000]), 256, 0, 8999))


# --- the int8 Hopper instance (bruteforce_topk_q8_wgmma) -------------------

Q8_WGMMA_BASES = {"1": lambda k: 1, "keep-1": lambda k: k - 1,
                  "keep": lambda k: k, "131075": lambda k: 131_075}


@pytest.mark.parametrize("b", [1, 63, 65, 256])
@pytest.mark.parametrize("keep", [1, 63, 64, 130, 256])
@pytest.mark.parametrize("base", list(Q8_WGMMA_BASES))
def test_q8_wgmma_bit_equal_on_integers(cuda, b, keep, base):
    """bruteforce_topk_q8_wgmma (bf16 wgmma, the query split in three bf16
    parts) through sweep_pool against the plain twin on integer rows at
    power-of-two scales, D = 32 / 64 / 96 / 128: one launch of the Hopper
    instance a call (none at base 0), L2 bit for bit; cosine within 1e-6
    relative and ids except at float64 near-ties."""
    n = Q8_WGMMA_BASES[base](keep)
    for d in (32, 64, 96, 128):
        qv, qs, pts = (t.to(cuda) for t in shadow_case(n + d + keep + b,
                                                      n + 37, d, b))
        for metric in (0, 1):
            assert cb.launch_instance(pts, (qv, qs), keep, metric) == (
                "bruteforce_topk_q8_wgmma", True)
            before = dict(cb.LAUNCHES)
            got = cb.sweep_pool(pts, (qv, qs), keep, metric, n)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in cb.LAUNCHES.items() if v
                   != before[k]}
            assert ran == ({"bruteforce_topk_q8_wgmma": 1} if n else {})
            want = cb._bruteforce_topk_plain(pts, (qv, qs), keep, metric, n)
            live = min(n, keep)
            assert bool((got[1][:, :live] >= 0).all())
            assert bool((got[1][:, live:] == -1).all())
            if metric == 0:
                _assert_pool_bit_equal(got, want)
            elif n:
                rows = cb.dequantize_rows(qv[:n], qs[:n]).float()
                _assert_pool_near(got, want, rows, pts, metric, 1e-6)


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("keep", [1, 64, 256])
def test_q8_wgmma_real_scales(cuda, metric, d, keep):
    """The Hopper instance on quantize_rows' scales of normal rows and
    normal queries: distances at rtol 1e-6 (the three bf16 passes are as
    exact as a float32 product), ids except at float64 near-ties within
    1e-5 relative."""
    qv, qs, pts = (t.to(cuda) for t in shadow_case(d + keep + 7, 131_075, d,
                                                  256, pow2=False))
    n = 131_000
    before = cb.LAUNCHES["bruteforce_topk_q8_wgmma"]
    got = cb.sweep_pool(pts, (qv, qs), keep, metric, n)
    assert cb.LAUNCHES["bruteforce_topk_q8_wgmma"] == before + 1
    want = cb._bruteforce_topk_plain(pts, (qv, qs), keep, metric, n)
    rows = cb.dequantize_rows(qv[:n], qs[:n]).float()
    _assert_pool_near(got, want, rows, pts, metric, 1e-6)


def test_q8_wgmma_masks_rows(cuda):
    """n_valid < N and tombstones through bruteforce_topk (the exact
    route's masks, which the build's sweep does not use): no masked row
    admitted, the twin's pool."""
    qv, qs, pts = (t.to(cuda) for t in shadow_case(5, 100_000, 128, 70,
                                                  pow2=False))
    dead = torch.from_numpy(np.random.default_rng(5).random(100_000)
                            < 0.1).to(cuda)
    for metric in (0, 1):
        got = cb.bruteforce_topk(pts, (qv, qs), 200, metric, 80_000, dead)
        want = cb._bruteforce_topk_plain(pts, (qv, qs), 200, metric, 80_000,
                                         dead)
        rows = cb.dequantize_rows(qv, qs).float()
        _assert_pool_near(got, want, rows, pts, metric, 1e-6)
        ids = got[1][got[1] >= 0].long()
        assert bool((ids < 80_000).all()) and not bool(dead[ids].any())


def test_q8_wgmma_on_shard_views(cuda):
    """Each shard's view of a stacked [S, cap, D] shadow at D = 128 (its
    base cap D bytes on, 16-byte aligned, and its scales' cap 4 bytes on)
    takes the Hopper instance and equals the twin bit for bit; a view one
    byte in keeps bruteforce_topk_q8, and so does a view whose scales
    start 4 bytes in."""
    qv, qs, pts = shadow_case(33, 3 * 5004, 128, 65)
    qv, qs = qv.view(3, 5004, 128).to(cuda), qs.view(3, 5004).to(cuda)
    pts = pts.to(cuda)
    for s, n in enumerate((5004, 4000, 17)):
        view = (qv[s], qs[s])
        assert cb.launch_instance(pts, view, 256, 0)[0] == (
            "bruteforce_topk_q8_wgmma")
        before = cb.LAUNCHES["bruteforce_topk_q8_wgmma"]
        got = cb.sweep_pool(pts, view, 256, 0, n)
        assert cb.LAUNCHES["bruteforce_topk_q8_wgmma"] == before + 1
        _assert_pool_bit_equal(got, cb._bruteforce_topk_plain(pts, view,
                                                              256, 0, n))
    flat_v, flat_s = qv.view(-1), qs.view(-1)
    for view in ((flat_v[1:1 + 5000 * 128].view(5000, 128), flat_s[:5000]),
                 (flat_v[:5000 * 128].view(5000, 128), flat_s[1:5001])):
        assert cb.launch_instance(pts, view, 256, 0) == (
            "bruteforce_topk_q8", False)
        before = cb.LAUNCHES["bruteforce_topk_q8"]
        got = cb.sweep_pool(pts, view, 256, 0, 4999)
        assert cb.LAUNCHES["bruteforce_topk_q8"] == before + 1
        _assert_pool_bit_equal(got, cb._bruteforce_topk_plain(pts, view,
                                                              256, 0, 4999))


def test_q8_wgmma_launch_refuses_what_the_rule_keeps_off(cuda):
    """The C entry refuses, rather than run, k_run 257, D = 136, a base
    one byte in, scales 4 bytes in, a page floor, Manhattan and a bound
    rank j with S j < k_run; the same launch in scope runs."""
    from pg_embedding_tpu_torch import _kernels
    lib = _kernels.load_library()
    b, n, splits = 8, 10_000, 4
    qv = torch.zeros((n + 16) * 136, dtype=torch.int8, device=cuda)
    sc = torch.ones(n + 16, device=cuda)
    qs = torch.zeros((b, 136), device=cuda)
    part = torch.empty((splits, b, 300), device=cuda)
    out = torch.empty((b, 300), device=cuda)
    floor = torch.zeros(b, device=cuda)
    bound = torch.full((b, splits), float("inf"), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(k=256, d=128, row_off=0, scale_off=0, metric=0, floor_at=None,
               rank=64):
        smem = cb._smem_bytes(64, k, 1, d, True, wgmma=True)
        return lib.bruteforce_topk_q8_wgmma(
            qs.data_ptr(), qv.data_ptr() + row_off, sc.data_ptr() + scale_off,
            None, b, n, d, k, metric, 64, splits, 1, smem, part.data_ptr(),
            part.data_ptr(), out.data_ptr(), out.data_ptr(), floor_at,
            floor_at, bound.data_ptr(), rank, stream)
    _kernels.check(lib, launch(), "bruteforce_topk_q8_wgmma")
    torch.cuda.synchronize()
    for kw in (dict(k=257, rank=65), dict(d=136), dict(row_off=1),
               dict(scale_off=4), dict(metric=2),
               dict(floor_at=floor.data_ptr()), dict(rank=63)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.check(lib, launch(**kw), "bruteforce_topk_q8_wgmma")


def _build_counts(cuda, **kw):
    """A 3,000-row build on the card in batches of 256: the sweep's
    launches by instance and the torch-op sweeps on the card."""
    from pg_embedding_tpu_torch.core import build as core_build
    rng = np.random.default_rng(41)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    idx = HnswIndex(HnswConfig(dims=32, m=8, ef_construction=32,
                               ef_search=32, metric=kw.pop("metric", "l2")),
                    device=cuda, **kw)
    before = dict(cb.LAUNCHES), core_build.PLAIN_SWEEPS_ON_CARD
    idx.build(pts)
    launches = {k: v - before[0][k] for k, v in cb.LAUNCHES.items()}
    return idx, pts, launches, core_build.PLAIN_SWEEPS_ON_CARD - before[1]


@pytest.mark.parametrize("mode,storage,name", [
    ("exact8", "float32", "bruteforce_topk_q8"),
    ("exact", "float32", "bruteforce_topk_wide"),
    ("exact", "bfloat16", "bruteforce_topk_bf16_wide")])
@pytest.mark.parametrize("metric", ["l2", "cosine", "manhattan"])
def test_build_sweep_is_one_launch_a_batch(cuda, mode, storage, name,
                                           metric):
    """Every build batch past the first (base 0: the empty pool, no
    launch) is one launch of its mode's instance (Manhattan's own:
    bruteforce_topk_q8_l1, _l1, _bf16_l1), and no sweep runs the torch-op
    loop on the card; the links match a CPU build's."""
    if metric == "manhattan":
        name = {"bruteforce_topk_q8": "bruteforce_topk_q8_l1",
                "bruteforce_topk_wide": "bruteforce_topk_l1",
                "bruteforce_topk_bf16_wide": "bruteforce_topk_bf16_l1"}[name]
    elif mode == "exact8":
        # D = 32 and a pool of 2 cand_cap = 64: the rule's Hopper instance
        name = "bruteforce_topk_q8_wgmma"
    idx, pts, launches, plain = _build_counts(
        cuda, build_candidates=mode, storage_dtype=storage, metric=metric)
    assert launches[name] == 11 and plain == 0
    assert sum(launches.values()) == 11
    cpu = HnswIndex(idx.config, device="cpu", build_candidates=mode,
                    storage_dtype=storage)
    cpu.build(pts)
    same = (idx.graph.links.cpu() == cpu.graph.links).all(dim=1)[:3000]
    assert float(same.float().mean()) >= 0.95


def test_manhattan_build_counts_its_loop(cuda):
    """Manhattan's sweep on the card is the kernel's (the CUDA cores' sum):
    no torch-op loop counted in the build (the default exact8: one
    bruteforce_topk_q8_l1 launch a batch past the first) nor in a direct
    call over the stored rows (one bruteforce_topk_l1 launch)."""
    from pg_embedding_tpu_torch.core import build as core_build
    idx, _, launches, plain = _build_counts(cuda, metric="manhattan")
    assert plain == 0 and launches["bruteforce_topk_q8_l1"] == 11
    assert sum(launches.values()) == 11
    before = core_build.PLAIN_SWEEPS_ON_CARD, cb.LAUNCHES["bruteforce_topk_l1"]
    core_build._exact_candidates(
        idx.graph.vectors, idx.graph.vectors[:8], idx.n_nodes, cand_cap=64,
        metric_value=2)
    assert core_build.PLAIN_SWEEPS_ON_CARD == before[0]
    assert cb.LAUNCHES["bruteforce_topk_l1"] == before[1] + 1


# the Manhattan instances' row types and the pools they are held at
L1_KINDS = ["float32", "bfloat16", "int8"]


def _l1_corpus(kind, seed, n, d, b, cuda):
    """Integer rows (int8: at power-of-two scales) and queries in [-8, 8]:
    every partial sum of a Manhattan score is exact in float32."""
    if kind == "int8":
        qv, qs, pts = (t.to(cuda) for t in shadow_case(seed, n, d, b))
        return (qv, qs), pts
    rows, qs = integer_data(seed, n, b)
    rows, qs = torch.from_numpy(rows), torch.from_numpy(qs)
    if d != rows.shape[1]:
        rng = np.random.default_rng(seed)
        rows = torch.from_numpy(rng.integers(-8, 9, size=(n, d)).astype(
            np.float32))
        qs = torch.from_numpy(rng.integers(-8, 9, size=(b, d)).astype(
            np.float32))
    return rows.to(getattr(torch, kind)).to(cuda), qs.to(cuda)


@pytest.mark.parametrize("kind", L1_KINDS)
@pytest.mark.parametrize("k_run", [1, 12, 130, 256, 257, 1024])
def test_l1_kernels_bit_equal_on_integers(cuda, kind, k_run):
    """bruteforce_topk_l1 / _bf16_l1 / _q8_l1 against their plain twin on
    integer rows: the wide selection with the shared bound to 256, the
    insertion into shared memory past it (QT = 16), tombstones and n_valid
    past the live rows' tiles, D = 30 (element loads) and 128; ids and
    distances bit for bit, one launch of the instance."""
    name = cb._L1_KERNELS[getattr(torch, kind) if kind != "int8"
                          else torch.int8]
    for d in (30, 128):
        corpus, qs = _l1_corpus(kind, k_run + d, 20_000, d, 65, cuda)
        g = torch.Generator().manual_seed(k_run)
        dead = (torch.rand(20_000, generator=g) < 0.05).to(cuda)
        before = dict(cb.LAUNCHES)
        got = cb.bruteforce_topk(qs, corpus, k_run, 2, 19_937, dead)
        torch.cuda.synchronize()
        before[name] += 1
        assert cb.LAUNCHES == before
        want = cb._bruteforce_topk_plain(qs, corpus, k_run, 2, 19_937, dead)
        _assert_pool_bit_equal(got, want)
        assert not bool(dead[got[1][got[1] >= 0].long()].any())


@pytest.mark.parametrize("kind", L1_KINDS)
def test_l1_kernels_pages_after_the_floor(cuda, kind):
    """k_run 1500: two pages, the second launch admitting only rows after
    the first page's floor (the after floor), and the exact route's
    fused_exact_search at k = 1500 under Manhattan; bit for bit against
    the twin, which has the whole list at once."""
    corpus, qs = _l1_corpus(kind, 77, 9000, 32, 40, cuda)
    got = cb.bruteforce_topk_paged(qs, corpus, 1500, 2, 9000)
    want = cb._bruteforce_topk_plain(qs, corpus, 1500, 2, 9000)
    _assert_pool_bit_equal(got, want)
    if kind != "int8":
        fd, fi = cb.fused_exact_search(qs, corpus, 1500, "manhattan")
        _assert_pool_bit_equal((fd, fi), want)


@pytest.mark.parametrize("kind", L1_KINDS)
@pytest.mark.parametrize("d", [1, 31, 33, 127])
def test_l1_kernels_at_the_edges(cuda, kind, d):
    """The register tile at the shapes' edges (tests/test_torch_manhattan
    .py models its schedule on the CPU): D 1, 31, 33 and 127 (element
    loads, a part step, one past a step); 1, 127 and 129 rows and 3,000;
    B 1, 63 and 65; tombstones; k_run 1, 12, 256 (the shared bound), 257
    (QT = 16) and 1500 (two pages, the second after the first's floor);
    bit for bit against the twin on integer rows."""
    for n, b in ((1, 1), (127, 63), (129, 65), (3000, 65)):
        corpus, qs = _l1_corpus(kind, n + d, n, d, b, cuda)
        g = torch.Generator().manual_seed(n + d)
        dead = (torch.rand(n, generator=g) < 0.05).to(cuda)
        for k_run in (1, 12, 256, 257, 1500):
            got = cb.bruteforce_topk_paged(qs, corpus, k_run, 2, n, dead)
            want = cb._bruteforce_topk_plain(qs, corpus, k_run, 2, n, dead)
            _assert_pool_bit_equal(got, want)


def test_manhattan_exact_route_uses_the_kernel(cuda):
    """The index's exact route, search(mode="exact"), the sharded index
    (one launch a shard) and the table's <~> seq scan under Manhattan:
    every call launches the Manhattan instance, no torch-op loop runs, and
    the labels equal a CPU index's but at float64 near-ties."""
    from pg_embedding_tpu_torch import ShardedHnswIndex
    from pg_embedding_tpu_torch.ops import bruteforce as bf
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    qs = rng.normal(size=(64, 32)).astype(np.float32)
    cfg = HnswConfig(dims=32, m=8, ef_construction=32, ef_search=32,
                     metric="manhattan")
    gpu, cpu = HnswIndex(cfg, device=cuda), HnswIndex(cfg, device="cpu")
    gpu.build(pts)
    cpu.build(pts)
    # the CPU's answer first: its route is the torch-op loop
    dc, lc, _ = cpu.exact_search(qs, 10)
    calls = []
    orig = bf.sweep_min_k
    bf.sweep_min_k = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        before = dict(cb.LAUNCHES)
        dg, lg, _ = gpu.exact_search(qs, 10)
        before["bruteforce_topk_l1"] += 1
        assert cb.LAUNCHES == before and not calls
        same = lg == lc
        assert same.mean() >= 0.99
        np.testing.assert_allclose(dg, dc, rtol=1e-5, atol=1e-5)
        sharded = ShardedHnswIndex(cfg, 4, device=cuda)
        sharded.build(pts)
        before = cb.LAUNCHES["bruteforce_topk_l1"]
        ds, ls, _ = sharded.exact_search(qs, 10)
        assert cb.LAUNCHES["bruteforce_topk_l1"] == before + 4
        np.testing.assert_allclose(ds, dc, rtol=1e-5, atol=1e-5)
        assert not calls
    finally:
        bf.sweep_min_k = orig


def test_build_sweep_keeps_tombstones(cuda):
    """Tombstones stay candidates (deletes filter results, not waypoints):
    an insert point equal to a deleted row finds it at distance 0."""
    from pg_embedding_tpu_torch.core import build as core_build
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    idx = HnswIndex(HnswConfig(dims=32, m=8, ef_construction=32,
                               ef_search=32), device=cuda)
    idx.build(pts)
    dead = np.arange(0, 3000, 7)
    idx.delete(dead)
    qv, qs = idx._ensure_quantized()
    batch = torch.as_tensor(pts[dead[:256]], device=cuda)
    for kw in (dict(qvec=qv, qscale=qs), {}):
        before = dict(cb.LAUNCHES)
        d, i = core_build._exact_candidates(idx.graph.vectors, batch, 3000,
                                            cand_cap=64, metric_value=0,
                                            **kw)
        assert sum(cb.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(i[:, 0].cpu(), torch.as_tensor(
            dead[:256], dtype=torch.int32))
        assert bool((d[:, 0] == 0).all())


# --- the wide selection: the float32 / bf16 wide instances, the shared bound

def integer_rows(seed, n, d, b, dtype, lo=-8, hi=8):
    """Rows dtype[n, d] and queries f32[b, d] of integers in [lo, hi]:
    every L2 score is exact in float32 (and the rows exact in bf16), so
    the kernel and its twin agree bit for bit."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(lo, hi + 1, size=(n, d)).astype(np.float32)
    pts = rng.integers(lo, hi + 1, size=(b, d)).astype(np.float32)
    return torch.from_numpy(rows).to(dtype), torch.from_numpy(pts)


@pytest.mark.parametrize("b", [1, 63, 65, 256])
@pytest.mark.parametrize("keep", [130, 256])
@pytest.mark.parametrize("base", ["1", "keep-1", "keep", "131075"])
def test_wide_kernel_bit_equal_on_integers(cuda, b, keep, base):
    """bruteforce_topk_wide / _bf16_wide (through sweep_pool) against the
    plain twin on integer rows, D = 30 / 128 / 960, L2 bit for bit; cosine
    (one rounding of 1 - dot * rsqrt where the twin rounds twice) within
    1e-6 relative and ids except at float64 near-ties."""
    n = {"1": 1, "keep-1": keep - 1, "keep": keep, "131075": 131_075}[base]
    for d in (30, 128, 960):
        for dtype in (torch.float32, torch.bfloat16):
            rows, pts = (t.to(cuda) for t in integer_rows(
                n + d + keep, n + 37, d, b, dtype))
            name = cb._WIDE_KERNELS[dtype]
            for metric in (0, 1):
                before = cb.LAUNCHES[name]
                got = cb.sweep_pool(pts, rows, keep, metric, n)
                torch.cuda.synchronize()
                assert cb.LAUNCHES[name] == before + 1
                want = cb._bruteforce_topk_plain(pts, rows, keep, metric, n)
                live = min(n, keep)
                assert bool((got[1][:, :live] >= 0).all())
                assert bool((got[1][:, live:] == -1).all())
                if metric == 0:
                    _assert_pool_bit_equal(got, want)
                else:
                    _assert_pool_near(got, want, rows[:n].float(), pts,
                                      metric, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", [0, 1])
def test_wide_kernel_masks_rows(cuda, dtype, metric):
    """The wide instances with n_valid < N and tombstones (the exact route's
    masks, which the build's sweep does not use), normal rows."""
    g = torch.Generator(device=cuda).manual_seed(61 + metric)
    pts = torch.randn((200_000, 100), generator=g, device=cuda).to(dtype)
    qs = torch.randn((300, 100), generator=g, device=cuda)
    dead = torch.rand(200_000, generator=g, device=cuda) < 0.1
    for k_run in (cb.WIDE_MIN_K, 102, 130, 256):
        name = cb._WIDE_KERNELS[dtype]
        before = cb.LAUNCHES[name]
        got = cb.bruteforce_topk(qs, pts, k_run, metric, 150_000, dead)
        assert cb.LAUNCHES[name] == before + 1
        _check(got, cb._bruteforce_topk_plain(qs, pts, k_run, metric,
                                              150_000, dead))
        ids = got[1][got[1] >= 0].long()
        assert bool((ids < 150_000).all()) and not bool(dead[ids].any())


def _wide_source(kind, rows):
    """``rows`` f32[n, d] as the sweep_pool source of ``kind``: the int8
    shadow of the rounded rows at unit scales, or the rows in float32 /
    bf16."""
    if kind == "q8":
        return (rows.round().clamp(-127, 127).to(torch.int8),
                torch.ones(len(rows), device=rows.device))
    return rows.to({"float32": torch.float32, "bf16": torch.bfloat16}[kind])


@pytest.mark.parametrize("kind", ["q8", "float32", "bf16"])
@pytest.mark.parametrize("keep", [130, 256])
def test_wide_pool_of_equal_rows(cuda, kind, keep):
    """Every row equal: every score ties, and the pool is rows 0..keep-1
    in id order (the lowest ids win a tie, whatever split each lies in)."""
    n, d = 131_075, 128
    rows = torch.full((n, d), 3.0, device=cuda)
    pts = torch.from_numpy(np.random.default_rng(keep).integers(
        -8, 9, size=(256, d)).astype(np.float32)).to(cuda)
    dist, ids = cb.sweep_pool(pts, _wide_source(kind, rows), keep, 0, n)
    assert torch.equal(ids, torch.arange(keep, dtype=torch.int32,
                                         device=cuda).expand(256, -1))
    assert bool((dist == dist[:, :1]).all())


@pytest.mark.parametrize("kind", ["q8", "float32", "bf16"])
@pytest.mark.parametrize("data", ["normal", "ties"])
def test_wide_pool_repeats(cuda, kind, data):
    """Five launches on one input give identical pools: the bound the
    splits share changes which rows a split admits with the timing, never
    the merged pool."""
    n, d, keep = 300_000, 128, 256 if kind == "q8" else 130
    if data == "normal":
        g = torch.Generator(device=cuda).manual_seed(71)
        rows = torch.randn((n, d), generator=g, device=cuda) * 20
        pts = torch.randn((256, d), generator=g, device=cuda) * 20
    else:
        rows, pts = (t.to(cuda) for t in integer_rows(72, n, d, 256,
                                                       torch.float32, -2, 2))
    src = _wide_source(kind, rows)
    pools = [cb.sweep_pool(pts, src, keep, 0, n) for _ in range(5)]
    for again in pools[1:]:
        _assert_pool_bit_equal(again, pools[0])
    want = cb._bruteforce_topk_plain(pts, src, keep, 0, n)
    if data == "ties":
        _assert_pool_bit_equal(pools[0], want)
    else:               # float queries: float32 sums in another order
        dense = (src[0].float() if kind == "q8" else src.float())
        _assert_pool_near(pools[0], want, dense, pts, 0, 1e-5)


def test_wide_launch_refuses_out_of_scope_arguments(cuda):
    """The wide entries refuse a bound rank j with S j < k_run, a bound
    past 256 entries, and a query tile other than 64."""
    from pg_embedding_tpu_torch import _kernels
    lib = _kernels.load_library()
    b, n, d, k_run, splits = 8, 10_000, 32, 100, 4
    qs = torch.zeros((b, d), device=cuda)
    pts = torch.zeros((n, d), device=cuda)
    part = torch.empty((splits, b, 300), device=cuda)
    out = torch.empty((b, 300), device=cuda)
    bound = torch.full((b, splits), float("inf"), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(k, qt, rank):
        smem = cb._smem_bytes(qt, k, 4, d, True)
        return lib.bruteforce_topk_wide(
            qs.data_ptr(), pts.data_ptr(), None, b, n, d, k, 0, qt, splits,
            1, smem, part.data_ptr(), part.data_ptr(), out.data_ptr(),
            out.data_ptr(), None, None, bound.data_ptr(), rank, stream)
    _kernels.check(lib, launch(k_run, 64, 25), "bruteforce_topk_wide")
    for k, qt, rank in ((k_run, 64, 24), (k_run, 64, 101), (300, 16, 75),
                        (k_run, 16, 25), (k_run, 64, 0)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.check(lib, launch(k, qt, rank), "bruteforce_topk_wide")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [62, 100, 254])
def test_exact_route_takes_the_wide_instances(cuda, dtype, k):
    """The exact entry at k_run = k + 2 >= WIDE_MIN_K launches the wide
    instance once, with n_valid < N and tombstones, and answers as the
    CPU's exact entry does over the same rows."""
    from pg_embedding_tpu_torch.ops.cuda_bruteforce import fused_exact_search
    rng = np.random.default_rng(k)
    pts = torch.from_numpy(rng.normal(size=(50_000, 64)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(100, 64)).astype(np.float32))
    dead = torch.from_numpy(rng.random(50_000) < 0.1)
    name = cb._WIDE_KERNELS[dtype]
    before = dict(cb.LAUNCHES)
    got = fused_exact_search(qs, pts.to(dtype).to(cuda), k, "l2",
                             n_valid=40_000, deleted=dead.to(cuda))
    assert cb.LAUNCHES[name] == before[name] + 1
    assert sum(cb.LAUNCHES.values()) == sum(before.values()) + 1
    want = fused_exact_search(qs, pts.to(dtype), k, "l2", n_valid=40_000,
                              deleted=dead)
    _check(got, want)
    ids = got[1][got[1] >= 0].long().cpu()
    assert bool((ids < 40_000).all()) and not bool(dead[ids].any())


# --- the build's wiring: connect_batch ---------------------------------------

# (maxM, D, b, base) of each tier of csrc/connect_batch.cu: the warp tier
# (maxM 8; the main path's maxM 32 at D 8 and 128; its widest set, C = 64;
# rows of 7 elements, no multiple of 16 bytes: copied an element a lane);
# the block tier one past it (C = 65) and at the default m = 100, rows and
# masks staged; masks only (rows too wide to stage); neither (masks in
# device memory)
CONNECT_TIERS = {"warp 8": (8, 8, 16, 300), "warp 32": (32, 8, 32, 300),
                 "warp 32 D128": (32, 128, 32, 300),
                 "warp widest": (63, 8, 16, 300),
                 "warp unaligned": (32, 7, 32, 300),
                 "staged 64": (64, 8, 16, 300),
                 "staged 200": (200, 8, 16, 300),
                 "masks only": (200, 400, 16, 300),
                 "device masks": (1400, 8, 4, 1500)}


@pytest.fixture
def exact_bf16_matmul():
    """bf16 matmuls that accumulate in float32 and round once (the twin's
    cosine dot): without this cuBLAS may round partial sums to bf16."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.parametrize("tier", list(CONNECT_TIERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", list(METRICS))
def test_connect_batch_bit_equal_on_integers(cuda, exact_bf16_matmul, tier,
                                             dtype, metric):
    """One connect_batch launch wires the batch exactly as the plain twin
    (core/build._connect_batch_plain) does on the card, on integer rows
    (every sum exact): links and counts bit for bit, for every metric,
    float32 and bf16 rows and each tier (the warp tier to its widest set
    and the block tier from one past it), with chains whose target is a
    member of the batch, members no chain targets, members past n_insert,
    invalid kept slots and -1 slots inside full rows."""
    from connect_operands import kernel_and_twin, wiring_case
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    max_m, dims, b, base = CONNECT_TIERS[tier]
    want = tier.split()[0] if tier.startswith(("warp", "staged")) else tier
    assert cg._connect_layout(max_m + 1, dims,
                              dtype.itemsize).tier == want
    arrays, meta = wiring_case(max_m + dims + METRICS[metric], max_m, b=b,
                               n_insert=b - 3, base=base, dims=dims)
    (kl, kc), (pl, pc), launches = kernel_and_twin(
        arrays, meta, METRICS[metric], cuda, dtype)
    assert launches == 1 and cg.LAST_CONNECT_LAUNCH.tier == want
    assert torch.equal(kc, pc)
    assert torch.equal(kl, pl)
    full = torch.from_numpy(arrays[2] == max_m)
    assert bool((pc.cpu()[full] < max_m).any())         # re-prunes pruned
    base, n_insert, m = meta
    tgt = core_build._back_link_targets(torch.from_numpy(arrays[3]),
                                        torch.from_numpy(arrays[4]),
                                        n_insert, m=m)
    members, targets = set(range(base, base + n_insert)), set(tgt.tolist())
    assert members - targets
    assert n_insert < 8 or members & targets


@pytest.mark.parametrize("case", ["no valid op", "first batch",
                                  "nothing inserted", "one member",
                                  "ragged"])
def test_connect_batch_edges(cuda, case):
    """Batches with nothing to wire still make one launch that changes only
    the forward rows, as the twin's: no valid op, node 0's first batch, no
    member inserted; a batch of one member; and n_insert < b with every
    member's ops valid (the members past n_insert wire nothing)."""
    from connect_operands import kernel_and_twin, wiring_case
    arrays, (base, n_insert, m) = wiring_case(3, 8, b=8, n_insert=8)
    vectors, links, counts, kept, cnt = arrays
    if case == "no valid op":
        kept[:] = -1
    elif case == "first batch":
        base, counts[:], links[:] = 0, 0, -1
        cnt[:] = 0
    elif case == "nothing inserted":
        n_insert = 0
    elif case == "one member":
        kept, cnt, n_insert = kept[:1], cnt[:1], 1
    else:
        cnt[:], n_insert = kept.shape[1], 5
    (kl, kc), (pl, pc), launches = kernel_and_twin(
        (vectors, links, counts, kept, cnt), (base, n_insert, m), 0, cuda)
    assert launches == 1
    assert torch.equal(kc, pc) and torch.equal(kl, pl)


def test_connect_batch_makes_no_host_sync(cuda):
    """core/build._connect_batch on the card, the wiring of
    insert_batch_core, under torch.cuda.set_sync_debug_mode("error"): the
    forward rows, the chain sort and the launch make no host sync."""
    from connect_operands import wiring_case, wiring_tensors
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.core import build as core_build
    _kernels.load_library()
    arrays, (base, n_insert, m) = wiring_case(5, 32, b=32)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        core_build._connect_batch(vectors, links, counts, base, kept, cnt,
                                  n_insert, m=m, max_m=32, metric_value=0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_builds_wire_in_the_kernel(cuda, storage):
    """A build on the card wires every batch in one connect_batch launch
    (the first, node 0's, too) and never runs the plain twin
    (PLAIN_CONNECTS_ON_CARD); the sharded index's batches too, a launch a
    shard's batch."""
    from pg_embedding_tpu_torch import ShardedHnswIndex
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    rng = np.random.default_rng(17)
    pts = rng.normal(size=(3000, 32)).astype(np.float32)
    cfg = HnswConfig(dims=32, m=8, ef_construction=32, ef_search=32)
    plain, before = core_build.PLAIN_CONNECTS_ON_CARD, \
        cg.LAUNCHES["connect_batch"]
    idx = HnswIndex(cfg, device=cuda, storage_dtype=storage)
    idx.build(pts)
    batches = len(core_build.build_schedule(3000, idx.max_insert_batch))
    assert cg.LAUNCHES["connect_batch"] == before + batches
    s = ShardedHnswIndex(cfg, n_shards=4, device=cuda)
    s.build(pts)
    assert cg.LAUNCHES["connect_batch"] > before + batches
    assert core_build.PLAIN_CONNECTS_ON_CARD == plain
    cpu = HnswIndex(cfg, device="cpu", storage_dtype=storage)
    cpu.build(pts)
    same = (idx.graph.links.cpu() == cpu.graph.links).all(dim=1)[:3000]
    assert float(same.float().mean()) >= 0.95


def test_connect_batch_refuses_out_of_scope_arguments(cuda):
    """What the kernel does not take raises ValueError on the card (the
    rows, links, counts, keys and perm, and the members' kept_i and
    kept_cnt: their type, shape, layout, and an n_insert or base outside
    the batch), and the C side refuses a shared-memory figure other than
    its own, for the warp tier and the block tier."""
    from connect_operands import wiring_case, wiring_tensors
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, (base, n_insert, m) = wiring_case(6, 8)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, cuda)
    keys, perm = core_build._chain_order(core_build._back_link_targets(
        kept, cnt, n_insert, m=m))
    kw = dict(base=base, n_insert=n_insert, m=m, max_m=8, metric_value=0)
    ok = (vectors, links, counts, keys, perm, kept, cnt)

    def swap(i, x):
        return tuple(x if j == i else a for j, a in enumerate(ok))
    bad = [(swap(0, vectors.half()), kw), (swap(1, links.long()), kw),
           (swap(2, counts[:-1]), kw), (swap(3, keys.long()), kw),
           (swap(4, perm.int()), kw),
           (swap(1, links.t().contiguous().t()), kw),
           ((vectors, links, counts, keys[:-1], perm[:-1], kept, cnt), kw),
           (swap(5, kept.long()), kw), (swap(5, kept[:, :-1].contiguous()),
                                        kw),
           (swap(5, kept.t().contiguous().t()), kw),
           (swap(6, cnt.long()), kw), (swap(6, cnt[:-1]), kw),
           (swap(6, cnt.cpu()), kw),
           ((vectors, links, counts, keys[:-m], perm[:-m], kept[:-1], cnt),
            kw),
           (ok, dict(kw, metric_value=3)), (ok, dict(kw, m=9)),
           (ok, dict(kw, base=-1)), (ok, dict(kw, n_insert=-1)),
           (ok, dict(kw, n_insert=kept.shape[0] + 1)),
           (ok, dict(kw, base=vectors.shape[0] - n_insert + 1))]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            cg.connect_batch(*args, **kwargs)
    lib = _kernels.load_library()
    for max_m in (8, 200):                       # the warp and block tiers
        lay = cg._connect_layout(max_m + 1, vectors.shape[1])
        assert lay.tier == ("warp" if max_m == 8 else "staged")
        wide = torch.full((vectors.shape[0], max_m), -1, dtype=torch.int32,
                          device=cuda)
        for wrong in (lay.smem + 16, lay.smem - 16):
            err = lib.connect_batch(
                vectors.data_ptr(), 0, wide.data_ptr(), counts.data_ptr(),
                keys.data_ptr(), perm.data_ptr(), kept.data_ptr(),
                cnt.data_ptr(), kept.shape[0], m, base, n_insert, max_m,
                vectors.shape[1], 0, wrong, 4, None, None,
                torch.cuda.current_stream().cuda_stream)
            with pytest.raises(RuntimeError, match="CUDA error"):
                _kernels.check(lib, err, "connect_batch")


def test_connect_batch_allocates_nothing_on_the_warp_tier(cuda):
    """The warp tier's launch allocates no device memory (the block tier's
    masks in device memory are its only scratch), and repeated launches on
    fresh copies give the same rows."""
    from connect_operands import wiring_case, wiring_tensors
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    _kernels.load_library()
    arrays, (base, n_insert, m) = wiring_case(7, 32, b=32)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, cuda)
    keys, perm = core_build._chain_order(core_build._back_link_targets(
        kept, cnt, n_insert, m=m))
    kw = dict(base=base, n_insert=n_insert, m=m, max_m=32, metric_value=0)
    assert cg._connect_layout(33, vectors.shape[1]).tier == "warp"
    start_links, start_counts = links.clone(), counts.clone()
    cg.connect_batch(vectors, links, counts, keys, perm, kept, cnt, **kw)
    want = links.clone(), counts.clone()
    for _ in range(3):
        links.copy_(start_links)
        counts.copy_(start_counts)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        cg.connect_batch(vectors, links, counts, keys, perm, kept, cnt, **kw)
        after = torch.cuda.memory_stats()["allocation.all.allocated"]
        assert after == before
        assert torch.equal(links, want[0]) and torch.equal(counts, want[1])


def test_connect_batch_fills_rows_then_reprunes(cuda):
    """Targets one slot short of full, each hit by several ops: the first
    op of a chain appends (the count reaches maxM), the next re-prunes.
    Repeated launches on fresh copies equal the twin every time (the
    block decides append or re-prune from one read of the count)."""
    from connect_operands import kernel_and_twin, wiring_case
    for rep in range(20):
        arrays, (base, n_insert, m) = wiring_case(40 + rep, 32, b=64,
                                                  n_insert=64)
        vectors, links, counts, kept, cnt = arrays
        rng = np.random.default_rng(rep)
        for i in range(base):
            links[i] = -1
            links[i, :31] = rng.choice(np.delete(np.arange(base), i), 31,
                                       replace=False)
        counts[:base] = 31
        hubs = rng.choice(base, 40, replace=False)
        kept[:] = np.stack([rng.choice(hubs, m, replace=False)
                            for _ in range(64)])
        cnt[:] = m
        (kl, kc), (pl, pc), launches = kernel_and_twin(
            (vectors, links, counts, kept, cnt), (base, n_insert, m), 0,
            cuda)
        assert launches == 1
        assert torch.equal(kc, pc) and torch.equal(kl, pl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", list(METRICS))
def test_connect_batch_long_chains(cuda, exact_bf16_matmul, metric, dtype):
    """Chains of more than 32 ops (a warp reads its chain 32 ops at a
    time) that append, re-prune, append where a re-prune left room and
    re-prune again: bit-equal to the twin on integer rows."""
    from connect_operands import kernel_and_twin, long_chain_case
    arrays, meta = long_chain_case(METRICS[metric])
    (kl, kc), (pl, pc), launches = kernel_and_twin(
        arrays, meta, METRICS[metric], cuda, dtype)
    assert launches == 1
    assert torch.equal(kc, pc) and torch.equal(kl, pl)


def test_connect_batch_widest_config(cuda, exact_bf16_matmul):
    """The widest sets a config admits (m = MAX_M: maxM 8,192, C = 8,193,
    the masks in device memory) on integer rows: three full targets
    re-pruned among 4,096 back-links of one member, equal to the twin."""
    from connect_operands import kernel_and_twin
    from pg_embedding_tpu_torch.config import MAX_M
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    max_m, m, dims, base = 2 * MAX_M, MAX_M, 8, 8300
    assert cg._connect_layout(max_m + 1, dims).tier == "device masks"
    rng = np.random.default_rng(29)
    vectors = rng.integers(-2, 3, size=(base + 6, dims)).astype(np.float32)
    links = np.full((base + 6, max_m), -1, np.int32)
    counts = np.zeros(base + 6, np.int32)
    full = rng.choice(base, 3, replace=False)
    for i in full:
        links[i] = rng.choice(np.delete(np.arange(base), i), max_m,
                              replace=False)
        counts[i] = max_m
    kept = np.full((2, m), -1, np.int32)
    kept[0] = np.concatenate([full, rng.choice(
        np.setdiff1d(np.arange(base), full), m - 3, replace=False)])
    cnt = np.array([m, 0], np.int32)
    for metric in METRICS.values():
        for dtype in (torch.float32, torch.bfloat16):
            (kl, kc), (pl, pc), launches = kernel_and_twin(
                (vectors, links, counts, kept, cnt), (base, 2, m), metric,
                cuda, dtype)
            assert launches == 1
            assert torch.equal(kc, pc) and torch.equal(kl, pl)
            assert bool((pc.cpu()[full] < max_m).all())


def test_connect_batch_counters(cuda):
    """ops/cuda_graph.CONNECT_STATS, when set, collects a launch's counts:
    chains, ops, re-prunes and the longest chain equal what a replay on
    the CPU counts, pruned re-prunes are among them, pairs and valid
    candidates follow; unset, the launch counts nothing."""
    from connect_operands import wiring_case, wiring_tensors
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph as cg
    arrays, (base, n_insert, m) = wiring_case(9, 32, b=32)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    core_build._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                              max_m=32)
    keys, perm = core_build._chain_order(core_build._back_link_targets(
        kept, cnt, n_insert, m=m))
    ops = keys[keys != core_build.NO_TARGET]
    reprunes = 0
    for q, t in enumerate(ops.tolist()):
        if int(counts[t]) >= 32:
            reprunes += 1
        core_build._replay_chains(vectors, links, counts, keys[q:q + 1],
                                  perm[q:q + 1], base=base, m=m, max_m=32,
                                  metric_value=0)
    _, chain_len = torch.unique_consecutive(ops, return_counts=True)
    stats = torch.zeros(8, dtype=torch.int64, device=cuda)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, cuda)
    cg.CONNECT_STATS = stats
    try:
        core_build._connect_batch(vectors, links, counts, base, kept, cnt,
                                  n_insert, m=m, max_m=32, metric_value=0)
    finally:
        cg.CONNECT_STATS = None
    got = stats.tolist()
    assert got[:3] == [len(chain_len), len(ops), reprunes] and reprunes
    assert got[6] == int(chain_len.max())
    assert 0 < got[3] <= got[2] and got[4] > 0 and got[5] >= 32 * got[3]
    core_build._connect_batch(*wiring_tensors(arrays, cuda)[:3], base,
                              kept, cnt, n_insert, m=m, max_m=32,
                              metric_value=0)
    assert stats.tolist() == got


# --- the compressed sweep's pool: the PQ kernel ----------------------------

def pq_case(seed, n, d, groups, b, integer=True):
    """Codes u8[n, G], a codebook f32[G, 256, d / G] and queries f32[b, d].
    With ``integer`` the codebook and the queries are integers in [-4, 4]:
    every product and partial sum of a score is exact in float32 whatever
    the order (|p|^2, |q|^2 <= 16 d), and equal distances are frequent;
    else normal values."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=(n, groups)).astype(np.uint8)
    shape = (groups, 256, d // groups)
    if integer:
        book = rng.integers(-4, 5, size=shape).astype(np.float32)
        qs = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    else:
        book = rng.normal(size=shape).astype(np.float32)
        qs = rng.normal(size=(b, d)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (codes, book, qs))


def _pq_pools(cuda, codes, book, qs, rotation, n_valid, dead, pool,
              metric):
    """The kernel's pool (_pq_pool on the card, its calls counted: one a
    page, and one more for a page whose candidate segments overflowed) and
    the twin's (_pq_pool_plain on the card)."""
    from pg_embedding_tpu_torch.ops import pq_sweep
    kw = dict(pool=pool, metric_value=metric, chunk=4096)
    before = cb.LAUNCHES["bruteforce_topk_pq"]
    got = pq_sweep._pq_pool(qs, codes, book, rotation, n_valid, dead, **kw)
    torch.cuda.synchronize()
    pages = 1 if pool <= cb.MAX_K_RUN else 2
    assert pages <= cb.LAUNCHES["bruteforce_topk_pq"] - before <= 2 * pages
    want = pq_sweep._pq_pool_plain(qs, codes, book, rotation, n_valid, dead,
                                   **kw)
    return got, want


# (D, G): sub = D / G of 12, 8, 6 and 3 dims (12, 6 and 3 do not divide
# the 64-dim step), G = 32 at D = 128 (the smoke's), and G % 4 != 0 with
# D % 64 != 0 (byte loads of the code rows, a step past D)
PQ_SHAPES = [(96, 8), (96, 12), (96, 16), (96, 32), (128, 32), (30, 6)]


@pytest.mark.parametrize("d,groups", PQ_SHAPES)
@pytest.mark.parametrize("pool", [1, 32, 256, 257, 512, 1024, 1500])
def test_pq_kernel_bit_equal_on_integers(cuda, d, groups, pool):
    """bruteforce_topk_pq (through _pq_pool: one call, two pages past
    1024) against its twin _pq_pool_plain on integer codebooks and queries:
    pools with the own list's bound (to 32) and the shared one, pages,
    tombstones, n_valid not a multiple of 128, B = 65 (not a multiple of
    the query tile); ids and distances bit for bit, L2 and cosine (the
    kernel rounds its score's every operation as the twin's torch ops do)
    and Manhattan (the CUDA cores' sum: every partial sum an exact
    integer)."""
    codes, book, qs = (t.to(cuda) for t in pq_case(d + groups + pool,
                                                   20_000, d, groups, 65))
    g = torch.Generator().manual_seed(pool)
    dead = (torch.rand(20_000, generator=g) < 0.05).to(cuda)
    for metric in (0, 1, 2):
        got, want = _pq_pools(cuda, codes, book, qs, None, 19_937, dead,
                              pool, metric)
        assert bool((got[1] >= 0).all())
        _assert_pool_bit_equal(got, want)


@pytest.mark.parametrize("metric", [0, 1, 2])
@pytest.mark.parametrize("d,groups,pool,rotate", [
    (128, 32, 32, False), (128, 16, 256, True), (96, 12, 1024, False),
    (960, 32, 64, False), (100, 25, 130, True)])
def test_pq_kernel_float_codebooks(cuda, metric, d, groups, pool, rotate):
    """Normal codebooks and queries, OPQ's rotation in two cases: the
    kernel's pool against the twin's, distances at rtol 1e-5 and ids
    except float64 near-ties over the decoded bf16 rows."""
    from pg_embedding_tpu_torch.ops.distance import _matmul
    from pg_embedding_tpu_torch.ops.pq import pq_decode
    n = 30_000
    codes, book, qs = (t.to(cuda) for t in pq_case(d + pool, n, d, groups,
                                                   300, integer=False))
    rotation = None
    if rotate:
        g = torch.Generator().manual_seed(d)
        rotation = torch.linalg.qr(torch.randn((d, d), generator=g))[0]
        rotation = rotation.to(cuda)
    got, want = _pq_pools(cuda, codes, book, qs, rotation, n - 3, None,
                          pool, metric)
    rows = pq_decode(codes[:n - 3], book).to(torch.bfloat16).float()
    q = qs if rotation is None else _matmul(qs, rotation)
    _assert_pool_near(got, want, rows, q, metric, 1e-5)


def test_pq_pool_routes_counts_and_refuses(cuda):
    """Manhattan launches the kernel on the card, one call, counted under
    its name and nothing else; out-of-scope arguments (a metric past
    Manhattan's among them) raise in the wrapper, a wrong shared-memory
    figure, an unaligned table, a bound rank past 32 or S j < k_run in the
    C call."""
    from pg_embedding_tpu_torch import _kernels
    from pg_embedding_tpu_torch.ops import pq_sweep
    codes, book, qs = (t.to(cuda) for t in pq_case(5, 3000, 32, 8, 16))
    before = dict(cb.LAUNCHES)
    d, i = pq_sweep._pq_pool(qs, codes, book, None, 3000, None, pool=64,
                             metric_value=2, chunk=1024)
    torch.cuda.synchronize()
    before["bruteforce_topk_pq"] += 1
    assert cb.LAUNCHES == before and i.shape == (16, 64)
    table = cb.pq_table(book)
    # rows 2 bytes past a 16-byte boundary
    unaligned = torch.empty(table.numel() + 1, dtype=torch.bfloat16,
                            device=cuda)[1:].view(table.shape)
    unaligned.copy_(table)
    ok = dict(queries=qs, codes=codes, table=table, k_run=10,
              metric_value=0, n_valid=3000)
    cb.pq_topk(**ok)
    for bad in (dict(k_run=0), dict(k_run=1025), dict(metric_value=3),
                dict(table=table[:, :128].contiguous()),
                dict(table=table.float()),
                dict(table=unaligned), dict(codes=codes[:, :6].contiguous()),
                dict(codes=codes.to(torch.int8)),
                dict(codes=codes.t().contiguous().t()),
                dict(queries=qs.double()),
                dict(deleted=torch.zeros(10, dtype=torch.bool, device=cuda))):
        with pytest.raises(ValueError):
            cb.pq_topk(**{**ok, **bad})
    lib = _kernels.load_library()
    assert lib.pq_topk_smem_bytes() == cb.PQ_SMEM
    buf = torch.empty((16, 1, 512, 2), dtype=torch.int32, device=cuda)
    counts = torch.empty((16, 1), dtype=torch.int32, device=cuda)
    bound = torch.full((16, 1), float("inf"), device=cuda)
    out = torch.empty((16, 10), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(tab=table, fig=cb.PQ_SMEM, metric=0, rank=10, k=10, s=1):
        return lib.bruteforce_topk_pq(
            qs.data_ptr(), codes.data_ptr(), tab.data_ptr(), None, 16, 3000,
            32, 8, k, metric, s, fig, buf.data_ptr(), 512,
            counts.data_ptr(), bound.data_ptr(), rank, out.data_ptr(),
            out.data_ptr(), None, None, None, None, stream)
    assert call() == 0
    for bad in (dict(fig=cb.PQ_SMEM + 16), dict(fig=cb.PQ_SMEM - 16),
                dict(tab=unaligned), dict(metric=3), dict(rank=33, k=33),
                dict(rank=4, k=10, s=2), dict(rank=0)):
        err = call(**bad)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _kernels.check(lib, err, "bruteforce_topk_pq")


@pytest.mark.parametrize("metric", [0, 1, 2])
def test_pq_overflow_reruns_the_query(cuda, monkeypatch, metric):
    """A codebook whose every entry is 1: every row scores the same, so a
    split admits each of its live rows (each equals the bound) and its
    segment, forced to 64 entries, overflows on every query: the call runs
    again with segments of a split's rows, a second counted call, and the
    pool stays the twin's bit for bit (the lowest live ids)."""
    monkeypatch.setattr(cb, "_PQ_CAP_MIN", 64)
    codes, book, qs = (t.to(cuda) for t in pq_case(9, 20_000, 96, 12, 65))
    book = torch.ones_like(book)
    g = torch.Generator().manual_seed(9)
    dead = (torch.rand(20_000, generator=g) < 0.05).to(cuda)
    splits, _, cap, per = cb._pq_launch_shape(65, 19_990, 16, 132)
    assert cap == 64 < 128 <= per
    before = cb.LAUNCHES["bruteforce_topk_pq"]
    got = cb.pq_topk(qs, codes, cb.pq_table(book), 16, metric, 19_990, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["bruteforce_topk_pq"] == before + 2
    from pg_embedding_tpu_torch.ops import pq_sweep
    want = pq_sweep._pq_pool_plain(qs, codes, book, None, 19_990, dead,
                                   pool=16, metric_value=metric, chunk=4096)
    _assert_pool_bit_equal(got, want)


@pytest.mark.parametrize("metric", ["l2", "manhattan"])
def test_sweep_pq_search_launches_the_pq_instance(cuda, metric):
    """search(mode="sweep_pq") on the card, L2 and Manhattan: one
    bruteforce_topk_pq launch a call and no other kernel, and the CPU
    index's labels except float64 near-ties; the sharded index launches it
    once a shard."""
    from pg_embedding_tpu_torch import ShardedHnswIndex
    rng = np.random.default_rng(17)
    pts = rng.normal(size=(6000, 32)).astype(np.float32)
    qs = rng.normal(size=(40, 32)).astype(np.float32)
    cfg = HnswConfig(dims=32, m=8, ef_construction=32, ef_search=32,
                     metric=metric)
    kw = dict(pq_groups=8)
    gpu = HnswIndex(cfg, device=cuda, **kw)
    cpu = HnswIndex(cfg, device="cpu", **kw)
    for idx in (gpu, cpu):
        idx.build(pts)
    # the CPU's codebook and codes on both: the pools then differ only at
    # float32 near-ties
    gpu._pq_codebook = cpu._ensure_pq_codebook().to(cuda)
    gpu._pq_codes = cpu._ensure_pq_codes().to(cuda)
    before = dict(cb.LAUNCHES)
    dg, lg, _ = gpu.search(qs, 10, mode="sweep_pq")
    before["bruteforce_topk_pq"] += 1
    assert cb.LAUNCHES == before
    dc, lc, _ = cpu.search(qs, 10, mode="sweep_pq")
    same = lg == lc
    assert same.mean() >= 0.99
    np.testing.assert_allclose(dg[same], dc[same], rtol=1e-5, atol=1e-6)
    sharded = ShardedHnswIndex(cfg, 4, device=cuda, **kw)
    sharded.build(pts)
    before = cb.LAUNCHES["bruteforce_topk_pq"]
    sharded.search(qs, 10, mode="sweep_pq")
    assert cb.LAUNCHES["bruteforce_topk_pq"] == before + 4


def test_rerank_pad_on_the_card(cuda):
    """The exact route's rerank pad against cancellation on the card
    (tests/rerank_band.band_case; the CPU's routes and the JAX package's:
    tests/test_torch_rerank_pad.py): fused_exact_search under L2 answers
    with the exact rerank of the kernel's own k + 2 pool (one launch of
    the instance the rule takes for it), its distances the float64 oracle's at
    rtol 1e-5, every oracle row it loses a band row outside that pool, as
    the reference's routes lose them."""
    from rerank_band import BAND, K, band_case, lost_rows, oracle, pool_rerank
    pts, qs = band_case()
    d64, want = oracle(pts, qs)
    p, q = torch.from_numpy(pts).to(cuda), torch.from_numpy(qs).to(cuda)
    before = dict(cb.LAUNCHES)
    d, ids = cb.fused_exact_search(q, p, K, "l2")
    before[cb.launch_instance(q, p, K + 2, 0)[0]] += 1
    assert cb.LAUNCHES == before
    pool = cb.bruteforce_topk(q, p, K + 2, 0, len(pts))[1].cpu().numpy()
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    np.testing.assert_allclose(
        d, np.take_along_axis(d64, ids.astype(np.int64), axis=1), rtol=1e-5)
    rerank = pool_rerank(d64, pool.astype(np.int64))
    for j, (g, r) in enumerate(zip(ids, rerank)):
        assert set(g) == set(r), j
    for j, rows in enumerate(lost_rows(ids, want)):
        band = set(range(30 * j + K - 1, 30 * j + K - 1 + BAND))
        assert rows <= band and not rows & set(pool[j]), j
