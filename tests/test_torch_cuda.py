"""The CUDA kernel on the card: ops/cuda_bruteforce.bruteforce_topk (float32
and bfloat16 corpus) against its plain twin, and the index's exact route
through it.  A CUDA kernel has
no CPU mode, so every test here skips without a CUDA device; run them on
the card with ``python -m pytest tests/ -m cuda``.

Tolerances: distances rtol 1e-5; ids equal except where the two sides'
distances at that rank are within 1e-5 relative (float32 sums in another
order may swap near-tied rows)."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch import HnswConfig, HnswIndex
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

pytestmark = pytest.mark.cuda


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
    before = cb.LAUNCHES["bruteforce_topk"]
    got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["bruteforce_topk"] == before + 1
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
    before = dict(cb.LAUNCHES)
    got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["bruteforce_topk_bf16"] == (
        before["bruteforce_topk_bf16"] + 1)
    assert cb.LAUNCHES["bruteforce_topk"] == before["bruteforce_topk"]
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
    name = cb._KERNELS[dt]
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
    before = cb.LAUNCHES["bruteforce_topk"]
    d, l, v = gpu.search(qs, 10)                   # auto -> exact route
    assert cb.LAUNCHES["bruteforce_topk"] > before
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
    before = cb.LAUNCHES["bruteforce_topk_bf16"]
    d, l, v = gpu.exact_search(qs, 10)
    assert cb.LAUNCHES["bruteforce_topk_bf16"] == before + 1
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
    name = cb._KERNELS[gpu._vectors.dtype]
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
