"""The slice as a whole: pg_embedding_tpu_torch.HnswIndex against the JAX
package's HnswIndex on the same 2k-row data, on the CPU.

Tolerances: >= 95% identical link rows (the matmul-form distances of the
pruning heuristic may flip at float32 near-ties), graph recall@10 within
0.01 of the JAX index's, exact and auto results identical."""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu_torch import HnswConfig, HnswIndex
from pg_embedding_tpu_torch.convert import index_from_numpy

N, D, K = 2000, 24, 10
CFG = dict(dims=D, m=8, ef_construction=48, ef_search=48)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = rng.normal(scale=3.0, size=(50, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 50, N)] +
           rng.normal(size=(N, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 50, 64)] +
          rng.normal(size=(64, D))).astype(np.float32)
    return pts, qs


@pytest.fixture(scope="module")
def pair(data):
    pts, _ = data
    labels = np.arange(N, dtype=np.uint64) * 3 + 7
    ji = JaxIndex(JaxConfig(**CFG))
    ji.build(pts, labels)
    ti = HnswIndex(HnswConfig(**CFG), device="cpu")
    ti.build(pts, labels)
    return ji, ti


def _recall(got_l, got_v, want_l, want_v, k=K):
    return float(np.mean([len(set(got_l[r][got_v[r]]) &
                              set(want_l[r][want_v[r]])) / k
                          for r in range(len(got_l))]))


def test_same_graph(pair):
    ji, ti = pair
    assert ti.graph.capacity == ji.graph.capacity
    assert ti.n_nodes == ji.n_nodes == N
    same = np.all(np.asarray(ji.graph.links)[:N] ==
                  ti.graph.links.numpy()[:N], axis=1)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(ti.labels, ji.labels)


def test_graph_recall(pair, data):
    ji, ti = pair
    _, qs = data
    _, el, ev = ji.exact_search(qs, K)
    jr = _recall(*ji.search(qs, K, mode="graph")[1:], el, ev)
    tr = _recall(*ti.search(qs, K, mode="graph")[1:], el, ev)
    assert abs(tr - jr) <= 0.01, (tr, jr)
    assert tr >= 0.9


def test_exact_and_auto(pair, data):
    ji, ti = pair
    _, qs = data
    for fn in ("exact_search", "search"):      # auto: batch 64 -> exact
        jd, jl, jv = getattr(ji, fn)(qs, K)
        td, tl, tv = getattr(ti, fn)(qs, K)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    assert ti.counters["n_exact_routed"] == len(qs)


def test_filters_match(pair, data):
    ji, ti = pair
    _, qs = data
    allowed = ji.labels[::3]                   # 33% selective: exact route
    mask = np.zeros(N, bool)
    mask[::2] = True                           # 50%: also the exact route
    for where in (allowed, mask):
        for mode in ("auto", "graph"):
            jd, jl, jv = ji.search(qs[:8], K, mode=mode, where=where)
            td, tl, tv = ti.search(qs[:8], K, mode=mode, where=where)
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tv, jv)
    _, tl, tv = ti.search(qs[:8], K, where=allowed)
    assert np.isin(tl[tv], allowed).all()


def test_delete_and_widening(data):
    """Tombstones never surface on either route, and the widening loop
    refills k live results like the JAX index's."""
    pts, qs = data
    pts, qs = pts[:600], qs[:8]
    cfg = dict(CFG, ef_search=8)
    ji = JaxIndex(JaxConfig(**cfg))
    ji.build(pts)
    ti = HnswIndex(HnswConfig(**cfg), device="cpu")
    ti.build(pts)
    _, top, _ = ti.exact_search(qs, 3)
    dead = np.unique(top)
    assert ti.delete(dead) == ji.delete(dead) == len(dead)
    assert ti.delete(dead) == 0                 # already tombstoned
    assert ti.delete_where(np.arange(600) == 599) == 1
    ji.delete_where(np.arange(600) == 599)
    dead = np.append(dead, 599)
    for mode in ("exact", "graph"):
        jd, jl, jv = ji.search(qs, 32, mode=mode)
        td, tl, tv = ti.search(qs, 32, mode=mode)
        assert not np.isin(tl[tv], dead).any()
        np.testing.assert_array_equal(tl, jl)
        assert tv.sum(axis=1).min() == 32
    assert ti.counters["n_widenings"] == ji.counters["n_widenings"] > 0
    assert ti.counters["n_deleted"] == len(dead)
    for key in ("n_inserted", "n_searches", "n_hops", "n_dist_evals"):
        assert ti.counters[key] == ji.counters[key], key


def test_widening_capped(data):
    """A filter that starves the walk widens only up to max_widen_ef."""
    pts, qs = data
    ti = HnswIndex(HnswConfig(**dict(CFG, ef_search=8)), device="cpu")
    ti.build(pts[:300])
    ti.max_widen_ef = 32
    keep = np.zeros(300, bool)
    keep[:3] = True
    ti.filter_exact_selectivity = 0.0          # force the graph route
    _, _, v = ti.search(qs[:4], 10, where=keep)
    assert ti.counters["n_widenings"] == 2      # ef 8 -> 16 -> 32
    assert v.sum(axis=1).max() <= 3


def test_search_ids_and_add(data):
    pts, qs = data
    ti = HnswIndex(HnswConfig(**CFG), device="cpu", initial_capacity=64)
    ji = JaxIndex(JaxConfig(**CFG), initial_capacity=64)
    for off in (0, 300, 600):                   # grows capacity 3 times
        ids_t = ti.add(pts[off:off + 300])
        ids_j = ji.add(pts[off:off + 300])
        np.testing.assert_array_equal(ids_t, ids_j)
    assert ti.graph.capacity == ji.graph.capacity
    d, i = ti.search_ids(qs[:5], ef=20)
    jd, ji_ = ji.search_ids(qs[:5], ef=20)
    assert d.shape == (5, 20)
    np.testing.assert_array_equal(i, ji_)


def test_errors_and_empty_index():
    idx = HnswIndex(HnswConfig(dims=8), device="cpu")
    with pytest.raises(ValueError, match="wrong number of dimensions"):
        idx.add(np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="unknown search mode"):
        idx.search(np.zeros((1, 8), np.float32), 3, mode="nope")
    for mode in ("auto", "graph", "exact"):
        d, l, v = idx.search(np.zeros((40, 8), np.float32), 3, mode=mode)
        assert not v.any() and np.isinf(d).all()
    idx.build(np.eye(8, dtype=np.float32))
    with pytest.raises(RuntimeError, match="empty index"):
        idx.build(np.eye(8, dtype=np.float32))


@pytest.mark.parametrize("kwargs", [
    dict(packed_dtype="pq"),
    dict(packed_dtype="pq", packed_traversal=True),
    dict(packed_dtype="pq", quantized_traversal=True)])
def test_unported_knobs_raise(kwargs, data):
    """The PQ knobs, once unported, now build and answer: each
    packed_dtype="pq" variant serves the graph route like the JAX index
    with the same knobs and codebook; pq_groups is taken, and a dims % G
    mismatch raises the JAX package's ValueError."""
    pts, qs = data
    pts, qs = pts[:400, :8], qs[:4, :8]
    cfg = dict(dims=8, m=6, ef_construction=24, ef_search=24)
    with pytest.raises(ValueError, match="not divisible by pq_groups 3"):
        HnswIndex(HnswConfig(**cfg), device="cpu", pq_groups=3, **kwargs)
    ji = JaxIndex(JaxConfig(**cfg), pq_groups=8, **kwargs)
    ji.pq_train_iters = 3
    ji.build(pts)
    jd, jl, jv = ji.search(qs, 5, mode="graph")
    ji._ensure_pq_codebook()
    g = ji.graph
    ti = index_from_numpy(HnswConfig(**cfg), g.vectors, g.links,
                          g.link_counts, g.deleted, ji.n_nodes, ji.labels,
                          pq_codebook=ji._pq_codebook, **kwargs)
    assert ti.pq_groups == 8 and ti.packed_dtype == "pq"
    td, tl, tv = ti.search(qs, 5, mode="graph")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    own = HnswIndex(HnswConfig(**cfg), device="cpu", pq_groups=8, **kwargs)
    own.build(pts)
    assert own.search(qs, 5, mode="graph")[2].all()


@pytest.mark.parametrize("call", ["pq_sweep_search", "sweep_pq"])
def test_unported_methods_raise(call, data):
    """pq_sweep_search and search(mode="sweep_pq"), once unported, now
    answer with the JAX package's labels on the same codebook."""
    pts, qs = data
    cfg = dict(dims=D, m=6, ef_construction=24, ef_search=24)
    ji = JaxIndex(JaxConfig(**cfg), pq_groups=8)
    ti = HnswIndex(HnswConfig(**cfg), device="cpu", pq_groups=8)
    for idx in (ji, ti):
        idx.build(pts[:500])
        idx.delete(np.arange(0, 500, 9))
    ji.pq_train_iters = 3
    ji._ensure_pq_codes()
    ti._pq_codebook = torch.tensor(np.asarray(ji._pq_codebook))
    for idx in (ji, ti):
        if call == "sweep_pq":
            got = idx.search(qs[:8], K, mode="sweep_pq")
        else:
            got = idx.pq_sweep_search(qs[:8], K, pool=32)
        if idx is ji:
            jd, jl, jv = got
    td, tl, tv = got
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    assert tv.all() and not np.isin(tl, np.arange(0, 500, 9)).any()


def test_wide_k_answers_in_pages(pair, data, monkeypatch):
    """k above one launch's k_run cap (1024) answers on the exact route in
    two pages of the kernel's function (its plain twin on the CPU), with
    the JAX index's labels."""
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

    ji, ti = pair
    _, qs = data
    pages = []
    topk = cb.bruteforce_topk

    def counted(*args):
        pages.append(args[2])
        return topk(*args)
    monkeypatch.setattr(cb, "bruteforce_topk", counted)
    jd, jl, jv = ji.search(qs[:40], 1500)
    td, tl, tv = ti.search(qs[:40], 1500)
    assert pages == [751, 751]
    assert td.shape == (40, 1500) and tv.all()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    diff = tl != jl                 # only at float32 near-ties
    assert np.allclose(td[diff], jd[diff], rtol=1e-5)
    assert diff.mean() < 1e-3
    # one launch's cap still holds
    with pytest.raises(ValueError, match="k_run=1025"):
        topk(torch.from_numpy(qs[:2]), ti.graph.vectors[:N], 1025, 0, N)


def test_exact_engines(pair, data):
    """exact_search takes the JAX package's engine names; every engine
    gives the same answer, and an unknown one its ValueError."""
    ji, ti = pair
    _, qs = data
    jd, jl, jv = ji.exact_search(qs, K)
    for engine in ("auto", "jnp", "pallas"):
        td, tl, tv = ti.exact_search(qs, K, engine=engine)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    for idx in (ji, ti):
        with pytest.raises(ValueError, match="unknown exact engine: 'tpu'"):
            idx.exact_search(qs, K, engine="tpu")


def test_index_from_numpy(pair, data):
    ji, ti = pair
    _, qs = data
    g = ji.graph
    conv = index_from_numpy(ti.config, g.vectors, g.links, g.link_counts,
                            g.deleted, ji.n_nodes, ji.labels)
    jd, jl, jv = ji.search(qs, K, mode="graph")
    td, tl, tv = conv.search(qs, K, mode="graph")
    assert (tl == jl).all(axis=1).mean() >= 0.99


def test_readers_and_a_writer_do_not_overlap(data):
    """MURSIW: searches running beside add() see whole batches only.  A
    batch links its rows before it raises n_nodes, so a search that
    overlapped a batch could return an id at or above n_nodes as read
    right after the search; the lock rules that out."""
    pts, qs = data
    idx = HnswIndex(HnswConfig(**CFG), device="cpu", max_insert_batch=64)
    idx.build(pts[:200])
    errors = []

    def reader():
        try:
            for _ in range(12):
                _, ids = idx.search_ids(qs[:4], ef=16)
                assert ids.max() < idx.n_nodes
        except Exception as e:                 # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        idx.add(pts[200:600])
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert idx.n_nodes == 600
    assert (idx.graph.link_counts[1:600] > 0).all()


def test_import_pulls_no_jax():
    code = ("import sys, pg_embedding_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'pg_embedding_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
