"""The serving variants and maintenance surface of the port against the JAX
package, on the CPU, over one JAX-built graph handed across with
convert.index_from_numpy: quantized and packed (int8 / bf16 / float32
records) walks, the visited-set modes, scan cursors, ef tuning, compact,
vacuum and check_integrity.

Tolerances: ids and validity equal, distances to rtol 1e-5 / atol 1e-6
(float32 sums in another order); float32 records equal the plain walk
exactly (same arithmetic on the same values); compacted graphs share
>= 95% of their link rows (the build tests' near-tie rule)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu.core.search import search_graph as jax_search
from pg_embedding_tpu_torch import (HnswConfig, HnswIndex, TuneResult,
                                    TuneTargetMissed)
from pg_embedding_tpu_torch.convert import index_from_numpy
from pg_embedding_tpu_torch.core import search as tsearch

N, D, K = 1500, 16, 8
CFG = dict(dims=D, m=6, ef_construction=32, ef_search=32)
DEAD = np.arange(0, N, 23, dtype=np.uint64)


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
    rng = np.random.default_rng(41)
    centers = rng.normal(scale=3.0, size=(30, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 30, N)] +
           rng.normal(size=(N, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 30, 48)] +
          rng.normal(size=(48, D))).astype(np.float32)
    return pts, qs


@pytest.fixture(scope="module")
def jidx(data):
    pts, _ = data
    ji = JaxIndex(JaxConfig(**CFG))
    ji.build(pts)
    ji.delete(DEAD)
    return ji


def _port(ji, **knobs):
    g = ji.graph
    cfg = HnswConfig.from_dict(ji.config.to_dict())
    return index_from_numpy(cfg, g.vectors, g.links, g.link_counts,
                            g.deleted, ji.n_nodes, ji.labels, **knobs)


@contextlib.contextmanager
def _knobs(ji, **knobs):
    """Serve the shared JAX index with some knobs, then restore them."""
    old = {k: getattr(ji, k) for k in knobs}
    for k, v in knobs.items():
        setattr(ji, k, v)
    ji._pcodes = ji._pscales = None
    try:
        yield ji
    finally:
        for k, v in old.items():
            setattr(ji, k, v)
        ji._pcodes = ji._pscales = None


def _same_search(ji, ti, qs, k=K):
    jd, jl, jv = ji.search(qs, k, mode="graph")
    td, tl, tv = ti.search(qs, k, mode="graph")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    _, ji_ids = ji.search_ids(qs, 48)
    _, ti_ids = ti.search_ids(qs, 48)
    np.testing.assert_array_equal(ti_ids, ji_ids)


VARIANTS = {
    "quantized": dict(quantized_traversal=True),
    "packed_int8": dict(packed_traversal=True, packed_dtype="int8"),
    "packed_bf16": dict(packed_traversal=True, packed_dtype="bfloat16"),
    "packed_f32": dict(packed_traversal=True, packed_dtype="float32"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(jidx, data, variant):
    _, qs = data
    ti = _port(jidx, **VARIANTS[variant])
    with _knobs(jidx, **VARIANTS[variant]):
        _same_search(jidx, ti, qs)
    if ti.packed_traversal:
        want = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                "float32": torch.float32}[ti.packed_dtype]
        assert ti._pcodes.dtype == want
        assert ti._pcodes.shape == (ti.graph.capacity, ti.config.max_m, D)


def test_packed_f32_is_the_plain_walk(jidx, data):
    _, qs = data
    plain = _port(jidx)
    packed = _port(jidx, packed_traversal=True, packed_dtype="float32")
    for ef in (32, 64):
        dp, ip = plain.search_ids(qs, ef)
        dk, ik = packed.search_ids(qs, ef)
        np.testing.assert_array_equal(ik, ip)
        np.testing.assert_array_equal(dk, dp)      # bit for bit
    # switching the record type rebuilds the records
    packed.packed_dtype = "int8"
    packed.search_ids(qs[:2])
    assert packed._pcodes.dtype == torch.int8 and packed._pscales is not None


def test_records_dropped_after_add(jidx, data):
    """add() drops the packed records; the rebuilt ones serve the grown
    graph exactly as the JAX package's do."""
    pts, qs = data
    knobs = VARIANTS["packed_int8"]
    ji = JaxIndex(JaxConfig(**CFG), **knobs)
    ji.build(pts[:400])
    ti = HnswIndex(HnswConfig(**CFG), device="cpu", **knobs)
    ti.build(pts[:400])
    _same_search(ji, ti, qs[:16])
    for idx in (ji, ti):
        idx.add(pts[400:460])
    assert ti._pcodes is None
    _same_search(ji, ti, qs[:16])


@pytest.mark.parametrize("mode", ["bitmap", "hash", "auto"])
def test_visited_modes(jidx, data, mode):
    """bitmap (the cross-check oracle) and hash give the dense walk's ids,
    as in the JAX package."""
    _, qs = data
    dense = _port(jidx)
    ti = _port(jidx)
    ti.visited_mode = mode
    with _knobs(jidx, visited_mode=mode):
        _same_search(jidx, ti, qs)
    np.testing.assert_array_equal(ti.search_ids(qs)[1],
                                  dense.search_ids(qs)[1])


def test_small_hash_table_walk_matches_jax(jidx, data):
    """A 64-slot table overwrites often: re-expansions, the hop cap and the
    final duplicate pass all run, and match the JAX walk."""
    _, qs = data
    ti = _port(jidx)
    jd, ji_, js = jax_search(jidx.graph, jnp.asarray(qs), ef=32,
                             metric_value=0, expand_width=4,
                             visited_slots=64)
    td, ti_, ts = tsearch.search_graph(ti.graph, torch.from_numpy(qs),
                                       ef=32, metric_value=0,
                                       expand_width=4, visited_slots=64)
    np.testing.assert_array_equal(ti_.numpy(), np.asarray(ji_))
    np.testing.assert_array_equal(ts.hops.numpy(), np.asarray(js.hops))
    np.testing.assert_array_equal(ts.dist_evals.numpy(),
                                  np.asarray(js.dist_evals))
    with pytest.raises(ValueError, match="power of 2"):
        tsearch.search_graph(ti.graph, torch.from_numpy(qs), ef=32,
                             metric_value=0, visited_slots=48)


def test_hash_bucket_and_slot_values():
    """The bucket and slot of an id are the JAX package's uint32 hashes
    (core/search.py _buckets/_slot_choice), computed here in int64."""
    ids = np.array([0, 1, 2, 31, 1000, 12345, 99991, 1 << 20,
                    (1 << 31) - 1, 2_000_000_001], np.int64)
    for slots in (64, 8192, 1 << 16):
        h = ((jnp.asarray(ids).astype(jnp.uint32) *
              jnp.uint32(2654435761)) & jnp.uint32(slots - 1) &
             ~jnp.uint32(3))
        want_b = np.asarray(h)[:, None].astype(np.int64) + np.arange(4)
        got_b = tsearch._hash_buckets(torch.from_numpy(ids), slots).numpy()
        np.testing.assert_array_equal(got_b, want_b)
    want_s = np.asarray((jnp.asarray(ids).astype(jnp.uint32) *
                         jnp.uint32(0x9E3779B1)) >> 30).astype(np.int64)
    got_s = tsearch._hash_slot_choice(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got_s, want_s)


def test_scan_matches_jax(jidx, data):
    pts, qs = data
    ti = _port(jidx)
    allowed = jidx.labels[::2]
    for where in (None, allowed):
        js = jidx.open_scan(qs[0], ef=8, where=where)
        ts = ti.open_scan(qs[0], ef=8, where=where)
        seen = []
        for n in (3, 5, 8, 8, 13):
            jd, jl = js.next(n)
            td, tl = ts.next(n)
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
            seen.extend(tl.tolist())
        assert len(seen) == len(set(seen)) == 37     # each row once
        assert not np.isin(seen, DEAD).any()
        if where is not None:
            assert np.isin(seen, allowed).all()
    with pytest.raises(ValueError, match="exactly one"):
        ti.open_scan(qs[:2])
    with pytest.raises(ValueError, match="n >= 1"):
        ti.open_scan(qs[0]).next(0)


def test_scan_sees_rows_added_after_open(data):
    """Rows added after open stay excluded under a where-filter (it was
    snapshotted) and surface without one; tombstones are re-read."""
    pts, qs = data
    ti = HnswIndex(HnswConfig(**CFG), device="cpu", initial_capacity=32)
    ti.build(pts[:200])
    filtered = ti.open_scan(qs[0], where=np.arange(200, dtype=np.uint64))
    plain = ti.open_scan(qs[0])
    ti.add(pts[:50] + 1e-3, np.arange(1000, 1050))   # grows capacity
    _, first = plain.next(1)
    ti.delete(first)
    _, fl = filtered.next(150)
    _, pl = plain.next(300)
    assert not np.isin(fl, np.arange(1000, 1050)).any()
    assert np.isin(pl, np.arange(1000, 1050)).any()
    assert first[0] not in pl


def test_tune_ef_search_matches_jax(data):
    pts, qs = data
    ji = JaxIndex(JaxConfig(**dict(CFG, ef_search=8)))
    ti = HnswIndex(HnswConfig(**dict(CFG, ef_search=8)), device="cpu")
    for idx in (ji, ti):
        idx.build(pts[:600])
        idx.delete(np.arange(0, 600, 13))
    for target in (0.9, 0.999):
        want = ji.tune_ef_search(qs, target_recall=target, k=K)
        got = ti.tune_ef_search(qs, target_recall=target, k=K)
        assert isinstance(got, TuneResult)
        assert got == want
        assert ti.config.ef_search == ji.config.ef_search == got.ef
    with pytest.raises(TuneTargetMissed):
        ti.tune_ef_search(qs, target_recall=1.01, k=K, max_ef=16,
                          strict=True)


def test_compact_matches_jax(jidx, data):
    _, qs = data
    knobs = dict(packed_traversal=True, packed_dtype="bfloat16",
                 search_expand_width=2)
    ti = _port(jidx, **knobs)
    ti.visited_mode = "bitmap"
    with _knobs(jidx, **knobs):
        jc = jidx.compact()
    tc = ti.compact()
    for key, val in knobs.items():
        assert getattr(tc, key) == val
    assert tc.visited_mode == "bitmap" and tc.device == ti.device
    n = N - len(DEAD)
    assert tc.n_nodes == jc.n_nodes == n
    np.testing.assert_array_equal(tc.labels, jc.labels)
    assert not np.isin(tc.labels, DEAD).any()
    same = (tc.graph.links.numpy()[:n] ==
            np.asarray(jc.graph.links)[:n]).all(axis=1)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(tc.exact_search(qs, K)[1],
                                  jc.exact_search(qs, K)[1])
    assert ti.n_nodes == N                        # the source is untouched


def test_vacuum_and_integrity_match_jax(jidx):
    ti = _port(jidx)
    assert ti.vacuum() == jidx.vacuum()
    assert ti.check_integrity() == jidx.check_integrity()
    # corrupt both copies the same way: a self-link, a duplicate, an id out
    # of range, a link in a padding slot, a count over maxM
    links = np.asarray(jidx.graph.links).copy()
    cnts = np.asarray(jidx.graph.link_counts).copy()
    links[5, 0] = 5
    links[7, 1] = links[7, 0]
    links[9, 0] = N + 3
    links[11, cnts[11]] = 2
    cnts[13] = ti.config.max_m + 1
    bad_j = JaxIndex(jidx.config)
    bad_j._graph = jidx.graph._replace(links=jnp.asarray(links),
                                       link_counts=jnp.asarray(cnts))
    bad_j._count = N
    bad_t = _port(jidx)
    bad_t.graph.links = torch.from_numpy(links)
    bad_t.graph.link_counts = torch.from_numpy(cnts)
    want = bad_j.check_integrity(raise_on_error=False)
    assert all(want.values())
    assert bad_t.check_integrity(raise_on_error=False) == want
    with pytest.raises(AssertionError, match="violations"):
        bad_t.check_integrity()


def test_knobs(jidx, data):
    _, qs = data
    ti = _port(jidx, packed_traversal=True)
    ti.set_ef_search(64)
    ti.set_ef_construction(40)
    assert (ti.config.ef_search, ti.config.ef_construction) == (64, 40)
    assert ti.config.m == CFG["m"]
    # packed traversal lowers the exact-route crossover
    ti.exact_threshold_packed = N - 1
    ti.search(qs, K)
    assert "n_exact_routed" not in ti.counters
    ti.packed_traversal = False
    ti.search(qs, K)
    assert ti.counters["n_exact_routed"] == len(qs)
    with pytest.raises(ValueError, match="packed_dtype"):
        HnswIndex(HnswConfig(dims=D), device="cpu", packed_dtype="int4")
