"""Manhattan in the sweep kernel's row instances (bruteforce_topk_l1,
_bf16_l1, _q8_l1 of csrc/bruteforce_topk.cu) on the CPU: the exact route
(ops/cuda_bruteforce.fused_exact_search) and its kernel's plain twin
(bruteforce_topk_paged on CPU tensors) against the JAX package's
pallas_exact_search in interpret mode, with tombstones, n_valid and k past
one launch (pages); the kernel's order of summation rendered in torch
against the twin; the routing: on a tensor that is not on the CPU, the
build's candidate sweep and the exact route reach the kernel's wrapper and
never the torch-op loops (_sweep_loop, sweep_min_k, exact_search), shown
on meta tensors with the wrapper's launch stubbed; the instances' entries
and their shared bound.  (The build's Manhattan candidates against the
JAX _exact_candidates: tests/test_torch_sweep_pool.py.)

Tolerances: distances rtol 1e-5; ids equal except where the two sides'
distances at that rank are within 1e-5 relative, judged in float64
(float32 sums in another order may swap near-tied rows); on integer rows
(every partial sum exact) bit for bit."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops.pallas_bruteforce import pallas_exact_search
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.ops import bruteforce as bf
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

MANHATTAN = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dist64(rows, qs, ids):
    """float64 Manhattan distances of each query to its rows ``ids`` (inf
    for -1)."""
    p = rows[np.maximum(ids, 0)].astype(np.float64)
    d = np.abs(p - qs.astype(np.float64)[:, None, :]).sum(-1)
    return np.where(ids >= 0, d, np.inf)


def _near(got, want, rows, qs):
    """Distances at rtol 1e-5 (infs where the other has them) and ids
    equal but at float64 near-ties."""
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)
    diff = gi != wi
    a, b = _dist64(rows, qs, gi), _dist64(rows, qs, wi)
    assert np.all(np.abs(a[diff] - b[diff]) <= 1e-5 * np.abs(b[diff]))


# (n, d, k, n_valid, tombstones, corpus dtype): k past 1022 takes pages
EXACT_CASES = [(500, 24, 10, None, 0, "float32"),
               (700, 100, 7, 650, 40, "float32"),
               (2000, 16, 1030, 1900, 60, "float32"),
               (600, 40, 12, None, 25, "bfloat16"),
               (1500, 8, 1100, None, 0, "bfloat16")]


@pytest.mark.parametrize("n,d,k,n_valid,dead,dtype", EXACT_CASES)
def test_exact_route_matches_pallas(n, d, k, n_valid, dead, dtype):
    """fused_exact_search (a CPU tensor: ops/bruteforce.exact_search) and
    the kernel's plain twin (bruteforce_topk_paged, what the card's
    Manhattan instances compute, in pages past 1024) against
    pallas_exact_search in interpret mode on the same numpy inputs."""
    rng = np.random.default_rng(n + d + k)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(9, d)).astype(np.float32)
    deleted = None
    if dead:
        deleted = np.zeros(n, bool)
        deleted[rng.choice(n, dead, replace=False)] = True
    corpus = torch.from_numpy(pts).to(getattr(torch, dtype))
    rows = corpus.float().numpy()
    jd, ji = pallas_exact_search(qs, corpus.float().numpy(), k, "manhattan",
                                 n_valid=n_valid, deleted=deleted, tile_n=128)
    want = (np.asarray(jd), np.asarray(ji))
    nv = n if n_valid is None else n_valid
    tdel = None if deleted is None else torch.from_numpy(deleted)
    got = cb.bruteforce_topk_paged(torch.from_numpy(qs), corpus, k, MANHATTAN,
                                   nv, tdel)
    _near((got[0].numpy(), got[1].numpy()), want, rows, qs)
    fd, fi = cb.fused_exact_search(qs, corpus, k, "manhattan",
                                   n_valid=n_valid, deleted=deleted)
    _near((fd.numpy(), fi.numpy()), want, rows, qs)
    live = nv - (0 if deleted is None else int(deleted[:nv].sum()))
    assert ((got[1].numpy() >= 0).sum(1) == min(k, live)).all()
    if deleted is not None:
        assert not np.isin(got[1].numpy(), np.nonzero(deleted)[0]).any()


def _l1_tile(qt):
    """L1Tile<QT> of csrc/bruteforce_topk.cu: (row groups RG, query groups
    QG, queries a thread RQ, rows a thread RN) of a QT x 128 block tile of
    256 threads."""
    rg = 16 if qt >= 64 else 32
    qg = 256 // rg
    return rg, qg, qt // qg, 128 // rg


def _tile_pairs(qt):
    """The (query, row) of each thread's sums in a QT x 128 block tile,
    each [256, RQ, RN]: lane l of warp w takes rg = l % 8 + 8 (w % (RG /
    8)) and qg = l / 8 + 4 (w / (RG / 8)), then queries qg + QG i and rows
    rg + RG j."""
    rgs, qgs, rq, rn = _l1_tile(qt)
    tid = torch.arange(256)
    warp, lane = tid // 32, tid % 32
    rg = lane % 8 + 8 * (warp % (rgs // 8))
    qg = lane // 8 + 4 * (warp // (rgs // 8))
    q = qg[:, None, None] + qgs * torch.arange(rq)[None, :, None]
    r = rg[:, None, None] + rgs * torch.arange(rn)[None, None, :]
    return q.expand(-1, rq, rn), r.expand(-1, rq, rn)


def _widen_elements():
    """(row, dim) of the elements each thread widens in a landed 128 x 32
    chunk (widen_chunk: row t / 2, dims 16 (t % 2) to + 16), [256, 16]."""
    tid = torch.arange(256)
    return ((tid // 2)[:, None].expand(-1, 16),
            16 * (tid % 2)[:, None] + torch.arange(16)[None, :])


def _l1_schedule(qs, rows, qt=64):
    """The kernel's Manhattan sums rendered in torch: the block tiles of
    QT queries x 128 rows, each (query, row) summed by the thread whose
    register tile holds it (_tile_pairs: each pair of a tile once), over
    32-dim steps, four dims at a time (l1_tile), so dims ascend; the
    queries' dim pairs swapped where they land (swap_dim_pairs), dim d
    read back from d ^ 1; every difference and sum rounded on its own in
    float32, dims and rows past the edges zero (+0 added)."""
    b, d = qs.shape
    width = 32 * -(-d // 32)
    order = [c + k0 + j for c in range(0, width, 32) for k0 in range(0, 32, 4)
             for j in range(4)]
    assert order == list(range(width))
    q_pad, n_pad = qt * -(-b // qt), 128 * -(-len(rows) // 128)
    q = torch.zeros((q_pad, width))
    q[:b, :d] = qs
    q = q.view(q_pad, -1, 2).flip(-1).reshape(q_pad, width)
    p = torch.zeros((n_pad, width))
    p[:len(rows), :d] = rows.float()
    tq, tr = (t.reshape(-1) for t in _tile_pairs(qt))
    cover = torch.zeros((qt, 128), dtype=torch.int64)
    cover.index_put_((tq, tr), torch.ones_like(tq), accumulate=True)
    assert (cover == 1).all()
    er, ed = (t.reshape(-1) for t in _widen_elements())
    cover = torch.zeros((128, 32), dtype=torch.int64)
    cover.index_put_((er, ed), torch.ones_like(er), accumulate=True)
    assert (cover == 1).all()
    # every block tile's pairs, by the thread that sums them
    q0 = torch.arange(0, q_pad, qt)[:, None, None]
    r0 = torch.arange(0, n_pad, 128)[None, :, None]
    qi, ri = (q0 + tq).expand(-1, n_pad // 128, -1), (r0 + tr).expand(
        q_pad // qt, -1, -1)
    acc = torch.zeros(qi.shape, dtype=torch.float32)
    for k in order:
        acc = acc + (q[qi, k ^ 1] - p[ri, k]).abs()
    out = torch.empty((q_pad, n_pad), dtype=torch.float32)
    out[qi, ri] = acc
    return out[:b, :len(rows)]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_summation_order_against_the_twin(kind):
    """The kernel's order of summation (_l1_schedule) over the rows as the
    instance widens them (int8: bf16(bf16(q) * bf16(scale)), the L2
    path's dequantisation) against the twin's scores (_scores: cdist, as
    pairwise_dist): bit for bit on integer rows, at rtol 1e-5 on normal
    ones, where the twin's pool differs only at float64 near-ties."""
    rng = np.random.default_rng(len(kind))
    for integer in (True, False):
        if integer:
            pts = rng.integers(-8, 9, size=(900, 40)).astype(np.float32)
            qs = rng.integers(-8, 9, size=(7, 40)).astype(np.float32)
        else:
            pts = rng.normal(size=(900, 40)).astype(np.float32)
            qs = rng.normal(size=(7, 40)).astype(np.float32)
        tp, tq = torch.from_numpy(pts), torch.from_numpy(qs)
        if kind == "int8":
            corpus = ((tp.to(torch.int8), torch.ones(900)) if integer
                      else tb.quantize_rows(tp))
            rows = cb.dequantize_rows(*corpus)
        else:
            corpus = rows = tp.to(getattr(torch, kind))
        got = _l1_schedule(tq, rows)
        want = cb._scores(tq, rows, MANHATTAN)
        if integer:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
        order = torch.sort(got, dim=1, stable=True).indices[:, :50]
        twin = cb._bruteforce_topk_plain(tq, corpus, 50, MANHATTAN, 900)
        r = rows.float().numpy()
        _near((torch.gather(got, 1, order).numpy(), order.numpy()),
              (twin[0].numpy(), twin[1].numpy()), r, qs)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [1, 31, 33, 127])
def test_tile_schedule_at_the_edges(kind, d):
    """The register tile's schedule (_l1_schedule: each pair of a tile
    once, dims ascending) at both query tiles against the twin's scores at
    the shapes' edges: D 1, 31, 33 and 127 (a part step, one past a step);
    1, 127 and 129 rows (a part tile, one past a tile); B 1, 63 and 65
    (one past QT = 64, part tiles of QT = 16); bit for bit on integer
    rows, rtol 1e-5 on normal ones."""
    rng = np.random.default_rng(d)
    for n, b in ((1, 1), (127, 63), (129, 65)):
        for integer in (True, False):
            if integer:
                pts = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
                qs = rng.integers(-8, 9, size=(b, d)).astype(np.float32)
            else:
                pts = rng.normal(size=(n, d)).astype(np.float32)
                qs = rng.normal(size=(b, d)).astype(np.float32)
            tp, tq = torch.from_numpy(pts), torch.from_numpy(qs)
            if kind == "int8":
                corpus = ((tp.to(torch.int8), torch.ones(n)) if integer
                          else tb.quantize_rows(tp))
                rows = cb.dequantize_rows(*corpus)
            else:
                rows = tp.to(getattr(torch, kind))
            want = cb._scores(tq, rows, MANHATTAN)
            for qt in (64, 16):
                got = _l1_schedule(tq, rows, qt)
                if integer:
                    assert torch.equal(got, want)
                else:
                    np.testing.assert_allclose(got.numpy(), want.numpy(),
                                               rtol=1e-5)


def test_instances_and_their_bound():
    """Manhattan takes its own entry for each row type, the wide selection
    with the shared bound up to WIDE_MAX_K (the int8 instance's way) and
    the insertion into shared memory past it (no bound, (None, 0));
    launches are counted under each name.  In the C source they are
    compile-time instances (sweep_kernel_l1, kL1), and the exact route's
    kernel instantiates the sweep with kL1 left false."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    for dtype, name in ((f32, "bruteforce_topk_l1"),
                        (bf16, "bruteforce_topk_bf16_l1"),
                        (i8, "bruteforce_topk_q8_l1")):
        assert name in cb.LAUNCHES
        for k_run in (1, 12, 130, 256):
            assert cb._instance(dtype, k_run, manhattan=True) == (name, True)
            got, scratch, args = cb._entry(dtype, k_run, 5, 33, "cpu",
                                           manhattan=True)
            assert got == name and scratch.shape == (5, 33)
            assert args == (scratch.data_ptr(), -(-k_run // 33))
        assert cb._instance(dtype, 257, manhattan=True) == (name, False)
        assert cb._entry(dtype, 1024, 5, 33, "cpu", manhattan=True) == (
            name, None, (None, 0))
    src = open(cb.__file__.replace("ops/cuda_bruteforce.py",
                                   "csrc/bruteforce_topk.cu")).read()
    assert "sweep_block<QT, kQRes, true, T, true>(" in src
    assert "sweep_block<QT, kQRes, false>(q, p, nullptr, del" in src
    assert "bool kL1 = false>" in src
    # the body: bf16 / int8 chunks widened once, then the register tile
    # (_l1_schedule's model), its sums stored at (query, row)
    assert "widen_chunk(p_s, scale_s, p_wide, tid);" in src
    assert ("l1_tile<QT>(q_s + l1_qg * qs, qs, p_f + l1_rg * kWStride, "
            "l1_acc);") in src
    assert "part(qv[i], c ^ 1)," in src and "swap_dim_pairs(" in src
    assert ("score_s[(l1_qg + T1::QG * i) * kSStride + l1_rg + T1::RG * j] ="
            in src)
    assert "l1_chunk" not in src


def _no_loops(monkeypatch):
    """The torch-op loops a Manhattan sweep could run, each made to fail
    the test."""
    def loop(*a, **k):
        raise AssertionError("a torch-op loop ran")
    monkeypatch.setattr(tb, "_sweep_loop", loop)
    monkeypatch.setattr(bf, "sweep_min_k", loop)
    monkeypatch.setattr(cb, "sweep_min_k", loop)
    monkeypatch.setattr(cb, "exact_search", loop)


def _stub_launch(monkeypatch, calls):
    """The kernel's wrapper (bruteforce_topk) stubbed past its argument
    checks: records (row dtype, k_run, metric, n_valid, mask, floor) and
    returns tensors of the kernel's shapes on the queries' device."""
    wrapper = cb.bruteforce_topk

    def launch(queries, points, k_run, metric_value, n_valid, deleted=None,
               after=None):
        cb._check_args(queries, points, k_run, metric_value, deleted, after)
        rows = points[0] if isinstance(points, tuple) else points
        calls.append((rows.dtype, k_run, metric_value, n_valid,
                      deleted is not None, after is not None))
        b = queries.shape[0]
        return (torch.empty((b, k_run), device=queries.device),
                torch.empty((b, k_run), dtype=torch.int32,
                            device=queries.device))
    monkeypatch.setattr(cb, "bruteforce_topk", launch)
    return wrapper


@pytest.mark.parametrize("kind", ["exact", "exact8"])
def test_build_sweep_routes_to_the_kernel(monkeypatch, kind):
    """_exact_candidates under Manhattan on a tensor not on the CPU: one
    call of the kernel's wrapper (through sweep_pool: no chunk loop), the
    stored rows or the int8 shadow, keep 2 cand_cap or cand_cap + 2; on
    the CPU the chunk loop, its route."""
    calls = []
    vectors = torch.randn((300, 16))
    pts = torch.randn((8, 16))
    qv, qs = tb.quantize_rows(vectors)
    shadow = dict(qvec=qv, qscale=qs) if kind == "exact8" else {}
    cpu = tb._exact_candidates(vectors, pts, 300, cand_cap=16,
                               metric_value=MANHATTAN, chunk=64, **shadow)
    assert (cpu[1] >= 0).all()
    _no_loops(monkeypatch)
    _stub_launch(monkeypatch, calls)
    meta = {k: v.to("meta") for k, v in shadow.items()}
    d, i = tb._exact_candidates(vectors.to("meta"), pts.to("meta"), 300,
                                cand_cap=16, metric_value=MANHATTAN,
                                chunk=64, **meta)
    assert d.shape == i.shape == (8, 16)
    keep = 32 if kind == "exact8" else 18
    dtype = torch.int8 if kind == "exact8" else torch.float32
    assert calls == [(dtype, keep, MANHATTAN, 300, False, False)]


def test_exact_route_routes_to_the_kernel(monkeypatch):
    """fused_exact_search under Manhattan on a tensor not on the CPU: the
    kernel's wrapper at k_run = k with the tombstones and no rerank, in
    pages past 1024 (each page a launch with the floor), bf16 rows too;
    a CPU tensor still takes ops/bruteforce.exact_search."""
    calls = []
    _no_loops(monkeypatch)
    wrapper = _stub_launch(monkeypatch, calls)
    meta = torch.randn((500, 8)).to("meta")
    dead = torch.zeros(500, dtype=torch.bool).to("meta")
    d, i = cb.fused_exact_search(torch.randn((4, 8)).to("meta"), meta, 10,
                                 "manhattan", n_valid=480, deleted=dead)
    assert d.shape == i.shape == (4, 10)
    d, i = cb.fused_exact_search(torch.randn((4, 8)).to("meta"),
                                 meta.to(torch.bfloat16), 1500, "manhattan")
    assert i.shape == (4, 1500)
    # the wrapper itself launches or raises on a tensor not on the CPU
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wrapper(torch.randn((4, 8)).to("meta"), meta, 10, MANHATTAN, 500)
    assert calls == [(torch.float32, 10, MANHATTAN, 480, True, False),
                     (torch.bfloat16, 750, MANHATTAN, 500, False, True),
                     (torch.bfloat16, 750, MANHATTAN, 500, False, True)]
    with pytest.raises(AssertionError, match="torch-op loop"):
        cb.fused_exact_search(torch.randn((4, 8)), torch.randn((50, 8)), 3,
                              "manhattan")
