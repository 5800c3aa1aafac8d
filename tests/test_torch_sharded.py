"""The port's sharded index against the JAX package's, on the CPU.

The JAX ShardedHnswIndex runs on a 4-device slice of the 8 virtual CPU
devices; the port holds its 4 shards on the CPU device.  Three kinds of
check:

  * the merges against the JAX functions on planted ties and +inf pads
    (ids and order equal);
  * a build from the same rows in both packages: counts, capacities, labels
    and insert positions equal, link rows equal on >= 95% of the rows of
    every shard (the near-tie bar of test_torch_serving's compact test; on
    this data they are all equal);
  * the JAX index's state carried over with
    convert.sharded_index_from_numpy, then both serve the same calls:
    labels and validity equal, distances to rtol 1e-5 / atol 1e-6 (float32
    sums in another order).  On the exact route a label may differ only
    where float64 cannot separate the two rows either (rtol 1e-6).  The
    int8 / bf16 walks rerank exactly and are held to recall within 0.005
    of the JAX walk's; plain and float32-record walks are held to equal
    labels and order.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import ShardedHnswIndex as JaxSharded
from pg_embedding_tpu.ops import pq as jax_pq
from pg_embedding_tpu.parallel import sharded as jax_sharded
from pg_embedding_tpu_torch import (HnswConfig, HnswIndex, ShardedHnswIndex,
                                    TuneResult, TuneTargetMissed)
from pg_embedding_tpu_torch.convert import sharded_index_from_numpy
from pg_embedding_tpu_torch.parallel import sharded as tsharded

N, D, K, S = 2003, 16, 8, 4          # N is not a multiple of S
CFG = dict(dims=D, m=8, ef_construction=32, ef_search=32)
DEAD = np.arange(0, N, 17, dtype=np.uint64)


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
    qs = (centers[rng.integers(0, 30, 40)] +
          rng.normal(size=(40, D))).astype(np.float32)
    return pts, qs


def _jax_index(s=S, cfg=CFG, **kw):
    return JaxSharded(JaxConfig(**cfg), mesh=jax_sharded.default_mesh(s),
                      **kw)


def _port_index(s=S, cfg=CFG, **kw):
    return ShardedHnswIndex(HnswConfig(**cfg), s, device="cpu", **kw)


@pytest.fixture(scope="module")
def jidx(data):
    """The shared JAX index: built once, some rows tombstoned."""
    pts, _ = data
    ji = _jax_index()
    ji.build(pts)
    ji.delete(DEAD)
    return ji


def _carry(ji, **knobs):
    """The port's index over the JAX index's state."""
    vec, lnk, cnt, dlt, _ = (np.asarray(a) for a in ji._arrays)
    cb = None if ji._pq_codebook is None else np.asarray(ji._pq_codebook)
    rot = None if ji._pq_rot is None else np.asarray(ji._pq_rot)
    ti = sharded_index_from_numpy(
        HnswConfig.from_dict(ji.config.to_dict()), vec, lnk, cnt, dlt,
        ji.shard_counts, ji._labels, ji._positions, device="cpu",
        pq_codebook=cb, pq_rot=rot, **knobs)
    ti.counters["n_deleted"] = ji.counters["n_deleted"]
    return ti


@contextlib.contextmanager
def _knobs(ji, **knobs):
    """Serve the shared JAX index with some knobs, then restore them."""
    old = {k: getattr(ji, k) for k in knobs}
    for k, v in knobs.items():
        setattr(ji, k, v)
    ji._packed = ji._quant = None
    try:
        yield ji
    finally:
        for k, v in old.items():
            setattr(ji, k, v)
        ji._packed = ji._quant = None


def _recall(got, want):
    (_, gl, gv), (_, wl, wv) = got, want
    return np.mean([len(set(gl[r][gv[r]]) & set(wl[r][wv[r]])) /
                    max(wv[r].sum(), 1) for r in range(len(gl))])


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def _assert_same_exact(got, want, qs, pts, labels_of=None):
    """Exact-route answers: distances to rtol 1e-5, labels equal except
    where the two rows' float64 distances agree to rtol 1e-6 (the sweeps
    order such near-ties differently)."""
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    rows, cols = np.nonzero((got[1] != want[1]) & want[2])
    if len(rows):
        row_of = (np.arange(len(pts)) if labels_of is None else labels_of)
        q = qs[rows].astype(np.float64)
        dg = np.linalg.norm(q - pts[row_of[got[1][rows, cols]]], axis=1)
        dw = np.linalg.norm(q - pts[row_of[want[1][rows, cols]]], axis=1)
        np.testing.assert_allclose(dg, dw, rtol=1e-6)


# ---------------------------------------------------------------------- #
# merges
# ---------------------------------------------------------------------- #

def _planted(s, b, w, seed):
    """Per-shard ascending candidate sets with ties across and within
    shards and +inf / -1 pads at the tails."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 12, size=(s, b, w)).astype(np.float32) / 4,
                axis=2)
    g = rng.permutation(s * b * w).reshape(s, b, w).astype(np.int32)
    pad = rng.integers(0, w // 2 + 1, size=(s, b))
    tail = np.arange(w)[None, None, :] >= (w - pad)[:, :, None]
    return np.where(tail, np.inf, d).astype(np.float32), np.where(tail, -1, g)


@pytest.mark.parametrize("s,b,w,k", [(4, 5, 8, 8), (8, 3, 6, 10),
                                     (2, 4, 3, 10), (1, 2, 5, 5)])
def test_topk_merge_matches_jax(s, b, w, k):
    d, g = _planted(s, b, w, seed=s * 100 + w)
    jd, jg = jax_sharded._topk_merge(jnp.asarray(d), jnp.asarray(g), k)
    td, tg = tsharded._topk_merge(torch.from_numpy(d), torch.from_numpy(g), k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert td.shape == (b, k)
    if s * w < k:
        assert np.isinf(td.numpy()[:, s * w:]).all()
        assert (tg.numpy()[:, s * w:] == -1).all()


@pytest.mark.parametrize("slices", [2, 4])
def test_gather_merge_hierarchy(slices):
    """dcn_slices > 1 merges inside groups of consecutive shards, then
    across the groups in slice order: the JAX function's two gathers, here
    replayed with its own _topk_merge.  Distances equal the flat merge's;
    ids too wherever a distance is not tied."""
    s, b, w, k = 8, 6, 8, 10
    d, g = _planted(s, b, w, seed=7)
    td, tg = tsharded._gather_merge(torch.from_numpy(d), torch.from_numpy(g),
                                    k, s, slices)
    per = s // slices
    firsts = [jax_sharded._topk_merge(jnp.asarray(d[i * per:(i + 1) * per]),
                                      jnp.asarray(g[i * per:(i + 1) * per]),
                                      k) for i in range(slices)]
    jd, jg = jax_sharded._topk_merge(jnp.stack([f[0] for f in firsts]),
                                     jnp.stack([f[1] for f in firsts]), k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    fd, fg = tsharded._gather_merge(torch.from_numpy(d), torch.from_numpy(g),
                                    k, s, None)
    np.testing.assert_array_equal(td.numpy(), fd.numpy())
    # untied data: the hierarchy returns the flat merge's ids too
    d2 = d + np.random.default_rng(3).random(d.shape).astype(np.float32) / 16
    flat = tsharded._gather_merge(torch.from_numpy(d2), torch.from_numpy(g),
                                  k, s, 1)
    hier = tsharded._gather_merge(torch.from_numpy(d2), torch.from_numpy(g),
                                  k, s, slices)
    assert torch.equal(flat[0], hier[0]) and torch.equal(flat[1], hier[1])


def test_validation_errors():
    with pytest.raises(ValueError, match="dcn_slices"):
        _port_index(dcn_slices=3)
    with pytest.raises(ValueError, match="dcn_slices"):
        _port_index(dcn_slices=0)
    with pytest.raises(ValueError, match="n_shards"):
        _port_index(0)
    for bad in (dict(build_candidates="sweep"), dict(storage_dtype="int8"),
                dict(packed_dtype="int4")):
        with pytest.raises(ValueError, match=next(iter(bad))):
            _port_index(**bad)
    with pytest.raises(ValueError, match="pq_groups"):
        _port_index(packed_dtype="pq", pq_groups=5)
    with pytest.raises(ValueError, match="pq_opq"):
        _port_index(cfg=dict(CFG, metric="manhattan"), pq_opq=True)
    idx = _port_index()
    with pytest.raises(ValueError, match="dimensions"):
        idx.add(np.zeros((3, D + 1), np.float32))
    with pytest.raises(ValueError, match="length mismatch"):
        idx.add(np.zeros((3, D), np.float32), labels=[1, 2])
    with pytest.raises(ValueError, match="unknown search mode"):
        idx.search(np.zeros((1, D), np.float32), 3, mode="beam")


@pytest.mark.parametrize("cap", [1, 32, 33, 1024, 8192, 8193, 250_128])
def test_pad_cap_matches_jax(cap):
    assert ShardedHnswIndex._pad_cap(cap) == JaxSharded._pad_cap(cap)


def test_defaults_match_jax():
    ji, ti = _jax_index(2), _port_index(2)
    for key in ("max_insert_batch", "search_expand_width",
                "build_expand_width", "build_candidates", "slab_batches",
                "exact_build_threshold", "exact8_build_threshold",
                "build_cand_cap", "exact_threshold", "exact_threshold_packed",
                "filter_exact_selectivity", "max_widen_ef", "storage_dtype",
                "packed_dtype", "pq_groups", "pq_opq", "pq_train_sample",
                "pq_train_iters", "pq_sweep_pool", "dcn_slices", "n_shards",
                "capacity_per_shard", "counters"):
        assert getattr(ti, key) == getattr(ji, key), key
    assert ti.device.type == "cpu" and len(ti) == 0


# ---------------------------------------------------------------------- #
# build
# ---------------------------------------------------------------------- #

def _assert_same_state(ti, ji, min_same=0.95):
    np.testing.assert_array_equal(ti.shard_counts, ji.shard_counts)
    assert ti.capacity_per_shard == ji.capacity_per_shard
    assert ti.n_nodes == ji.n_nodes
    np.testing.assert_array_equal(ti._labels, ji._labels)
    np.testing.assert_array_equal(ti._positions, ji._positions)
    jl = np.asarray(ji._arrays[1])
    jc = np.asarray(ji._arrays[2])
    for i, n in enumerate(ti.shard_counts):
        same = (ti._links[i, :n].numpy() == jl[i, :n]).all(axis=1)
        assert same.mean() >= min_same, (i, same.mean())
        assert (ti._link_counts[i, :n].numpy() == jc[i, :n]).mean() >= \
            min_same
    assert ti.counters["n_inserted"] == ji.counters["n_inserted"]


@pytest.mark.parametrize("mode", ["exact8", "exact", "beam"])
def test_build_matches_jax(data, mode):
    pts, _ = data
    ji, ti = (_jax_index(build_candidates=mode),
              _port_index(build_candidates=mode))
    for idx in (ji, ti):
        assert idx.build(pts) is None
    _assert_same_state(ti, ji)
    assert ti.shard_counts.tolist() == [501, 501, 501, 500]
    # default labels are the global insert order
    np.testing.assert_array_equal(ti._labels[1, :3], [1, 5, 9])
    ti.check_integrity()
    # the int8 shadow survives an add that staged every row through exact8
    assert (ti._qvec is not None) == (ji._qvec is not None) == (
        mode == "exact8")
    if mode == "exact8":
        np.testing.assert_array_equal(ti._qvec_counts, ji._qvec_counts)
        for i, n in enumerate(ti.shard_counts):
            np.testing.assert_array_equal(ti._qvec[i, :n].numpy(),
                                          np.asarray(ji._qvec)[i, :n])


def test_build_cosine_s8_matches_jax(data):
    pts, _ = data
    cfg = dict(CFG, metric="cosine")
    ji, ti = _jax_index(8, cfg), _port_index(8, cfg)
    for idx in (ji, ti):
        idx.build(pts[:1001], np.arange(5000, 6001))
    _assert_same_state(ti, ji)
    with pytest.raises(RuntimeError, match="empty index"):
        ti.build(pts[:10])


def test_incremental_add_growth_and_labels_match_jax(data):
    """Round-robin continues from the global count, default labels from
    counters["n_inserted"], and capacity grows as in the JAX package —
    through adds that leave the shards ragged."""
    pts, _ = data
    ji, ti = (_jax_index(initial_capacity=32, max_insert_batch=32),
              _port_index(initial_capacity=32, max_insert_batch=32))
    caps = []
    for idx in (ji, ti):
        idx.add(pts[:101])
        idx.add(pts[101:103], [900, 901])
        idx.add(pts[103:490])
        caps.append(idx.capacity_per_shard)
    assert caps[0] == caps[1]
    _assert_same_state(ti, ji)
    assert ti.shard_counts.tolist() == [123, 123, 122, 122]
    # 103 rows went in before the third add, so its labels start at 103
    assert 103 in ti._labels and 489 in ti._labels and 102 not in ti._labels


def test_candidate_mode_per_slab_matches_jax(data, monkeypatch):
    """With thresholds set, "auto" resolves the engine once per slab of the
    (big, small) schedule at counts.min() + the slab's offset; the port
    keeps those offsets although it dispatches batch by batch."""
    pts, _ = data
    ji, ti = (_jax_index(max_insert_batch=16),
              _port_index(max_insert_batch=16))
    seen = []
    real = tsharded.insert_batch_core

    def spy(graph, points, n_insert, **kw):
        seen.append((kw["candidates"], graph.n_nodes))
        return real(graph, points, n_insert, **kw)

    monkeypatch.setattr(tsharded, "insert_batch_core", spy)
    for idx in (ji, ti):
        idx.slab_batches = (8, 2)
        idx.exact_build_threshold = 100
        idx.exact8_build_threshold = 200
        idx.add(pts[:1203])
    _assert_same_state(ti, ji)
    # slabs start at 0 and 128 (8 batches of 16), then every 32 rows: the
    # slab at 0 is "exact" (0 < 100), the slab at 128 "exact8" to its end
    # at 256 although it crosses 200, the small slabs from 256 "beam"
    modes = {}
    for mode, at in seen:
        modes.setdefault(mode, []).append(at)
    assert max(modes["exact"]) == 112 and min(modes["exact8"]) == 128
    assert max(modes["exact8"]) == 240 and min(modes["beam"]) == 256
    assert ti._qvec is None                 # beam slabs staged nothing


# ---------------------------------------------------------------------- #
# routes on carried state
# ---------------------------------------------------------------------- #

def test_exact_search_matches_jax(jidx, data):
    pts, qs = data
    ti = _carry(jidx)
    got, want = ti.exact_search(qs, K), jidx.exact_search(qs, K)
    _assert_same_exact(got, want, qs, pts)
    assert not np.isin(got[1], DEAD).any() and got[2].all()
    # and against float64 brute force over the live rows
    live = np.setdiff1d(np.arange(N), DEAD)
    d64 = np.linalg.norm(qs[:, None].astype(np.float64) - pts[live][None],
                         axis=2)
    np.testing.assert_allclose(got[0], np.sort(d64, axis=1)[:, :K],
                               rtol=1e-5)
    # k beyond the live rows of the index: padded, in both
    small_j, small_t = _jax_index(2), _port_index(2)
    for idx in (small_j, small_t):
        idx.build(pts[:5])
    got, want = small_t.exact_search(qs[:3], 8), small_j.exact_search(qs[:3],
                                                                      8)
    _assert_same_exact(got, want, qs[:3], pts)
    assert got[2].sum(axis=1).tolist() == [5, 5, 5]


def test_graph_search_matches_jax(jidx, data):
    _, qs = data
    ti = _carry(jidx)
    _assert_same(ti.search(qs, K, mode="graph"),
                 jidx.search(qs, K, mode="graph"))
    _assert_same(ti.search(qs, K, ef=100, mode="graph"),
                 jidx.search(qs, K, ef=100, mode="graph"))
    # k past ef * S is cut to what the shards produced
    got, want = (ti.search(qs[:4], 200, mode="graph"),
                 jidx.search(qs[:4], 200, mode="graph"))
    _assert_same(got, want)
    assert got[0].shape == (4, 200)


VARIANTS = {
    "quantized": (dict(quantized_traversal=True), "quant"),
    "packed_int8": (dict(packed_traversal=True, packed_dtype="int8"),
                    "packed"),
    "packed_bf16": (dict(packed_traversal=True, packed_dtype="bfloat16"),
                    "cast"),
    "packed_f32": (dict(packed_traversal=True, packed_dtype="float32"),
                   "cast"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(jidx, data, variant):
    _, qs = data
    knobs, name = VARIANTS[variant]
    ti = _carry(jidx, **knobs)
    assert ti._traversal_variant() == name
    with _knobs(jidx, **knobs):
        want = jidx.search(qs, K, mode="graph")
        oracle = jidx.exact_search(qs, K)
    got = ti.search(qs, K, mode="graph")
    if variant == "packed_f32":
        # float32 records are the plain walk: labels and order equal
        _assert_same(got, want)
        _assert_same(got, _carry(jidx).search(qs, K, mode="graph"))
    else:
        assert abs(_recall(got, oracle) - _recall(want, oracle)) <= 0.005
        # these data give the same answers outright
        _assert_same(got, want)
    if ti.packed_traversal:
        recs, scales = ti._packed
        assert recs.shape == (S, ti.capacity_per_shard, ti.config.max_m, D)
        assert (scales is not None) == (variant == "packed_int8")


def test_quant_reuses_the_build_shadow(data):
    pts, qs = data
    ti = _port_index(quantized_traversal=True)
    ti.build(pts[:900])
    ti.search(qs, K, mode="graph")
    assert ti._quant[0] is ti._qvec         # the exact8 shadow, reused
    ti.add(pts[900:950])
    assert ti._quant is None and ti._packed is None
    fresh = _port_index(quantized_traversal=True, build_candidates="exact")
    fresh.build(pts[:950])
    assert fresh._qvec is None
    # a shadow quantized in one pass equals the staged one
    np.testing.assert_array_equal(fresh._ensure_quant()[0].numpy(),
                                  ti._ensure_quant()[0].numpy())


def test_filters_match_jax(jidx, data):
    pts, qs = data
    ti = _carry(jidx)
    allowed = np.arange(0, N, 3, dtype=np.uint64)
    mask = np.zeros(N, bool)
    mask[N // 2:] = True
    for where in (allowed, mask):
        np.testing.assert_array_equal(ti._filter_mask(where),
                                      jidx._filter_mask(where))
        _assert_same(ti.search(qs, K, mode="graph", where=where),
                     jidx.search(qs, K, mode="graph", where=where))
        _assert_same_exact(ti.exact_search(qs, K, where=where),
                           jidx.exact_search(qs, K, where=where), qs, pts)
    _, l, v = ti.search(qs, K, mode="graph", where=allowed)
    assert (l[v] % 3 == 0).all() and not np.isin(l[v], DEAD).any()
    _, l, v = ti.exact_search(qs, K, where=mask)
    assert (l[v] >= N // 2).all()
    with pytest.raises(ValueError, match="filter mask covers"):
        ti.search(qs, K, where=mask[:100])
    # a selective filter routes auto mode to the masked exact sweep
    small = qs[:8]                            # under the batch-32 router
    for idx in (ti, jidx):
        before = idx.counters.get("n_exact_routed", 0)
        idx.search(small, K, where=allowed)
        assert idx.counters["n_exact_routed"] == before + 8
        idx.search(small, K, where=np.ones(N, bool))
        assert idx.counters["n_exact_routed"] == before + 8


def test_delete_and_widening_match_jax(data):
    """Tombstones are filtered on the shard, and the widening gate is the
    max over shards of what each has left: the JAX package counts after
    the filter, so a query widens while some shard still fills its beam
    with live rows and the merged answer is short of k."""
    pts, qs = data
    cfg = dict(CFG, ef_search=8)
    ji = _jax_index(cfg=cfg)
    ji.build(pts)
    ti = _carry(ji)
    # k = 40 > ef * S = 32 and every beam is full: both widen once
    got, want = (ti.search(qs, 40, mode="graph"),
                 ji.search(qs, 40, mode="graph"))
    _assert_same(got, want)
    assert ti.counters["n_widenings"] == ji.counters["n_widenings"] == 1
    assert got[2].all()
    gone = np.arange(0, 1000, dtype=np.uint64)
    mask = np.zeros(N, bool)
    mask[1000:1050] = True
    for idx in (ji, ti):
        assert idx.delete(gone[:600]) == 600
        assert idx.delete(gone) == 400          # only the new ones count
        assert idx.delete_where(mask) == 50
        assert idx.delete_where(mask) == 0
        idx.counters["n_widenings"] = 0
    assert ti.vacuum() == ji.vacuum()
    assert ti.vacuum()["num_dead"] == 1050
    # half the rows dead: no shard fills its beam with live rows, so
    # neither package widens and both return the same short answer
    got, want = (ti.search(qs, 40, mode="graph"),
                 ji.search(qs, 40, mode="graph"))
    _assert_same(got, want)
    assert not np.isin(got[1][got[2]], np.arange(1050)).any()
    assert ti.counters["n_widenings"] == ji.counters["n_widenings"]
    assert not got[2].all()
    # the ceiling: widening stops at max_widen_ef with a partial answer
    ji2 = _jax_index(cfg=cfg)
    ji2.build(pts[:900])
    ti2 = _carry(ji2)
    for idx in (ji2, ti2):
        idx.max_widen_ef = 16
    got, want = (ti2.search(qs, 100, mode="graph"),
                 ji2.search(qs, 100, mode="graph"))
    _assert_same(got, want)
    assert ti2.counters["n_widenings"] == ji2.counters["n_widenings"] == 1
    assert got[2].sum(axis=1).max() <= 64
    assert ti2.counters["n_searches"] == ji2.counters["n_searches"]


def test_routing_and_empty_index_match_jax(jidx, data):
    _, qs = data
    ti = _carry(jidx)
    assert ti._use_exact(32) and not ti._use_exact(31)
    ti.exact_threshold = 400                # per shard: 2003 / 4 > 400
    assert not ti._use_exact(32)
    ti.packed_traversal, ti.exact_threshold_packed = True, 600
    assert ti._use_exact(32)
    ti.packed_traversal = False
    ti.search(qs, K)
    assert "n_exact_routed" not in ti.counters
    ti.search(qs, K, mode="exact")
    assert ti.counters["n_exact_routed"] == len(qs)
    assert [ti._bucket_ef(e) for e in (0, 32, 33, 100)] == \
        [jidx._bucket_ef(e) for e in (0, 32, 33, 100)] == [32, 32, 64, 128]
    empty = _port_index()
    for mode in ("graph", "exact", "auto"):
        d, l, v = empty.search(np.zeros((2, D), np.float32), 5, mode=mode)
        assert not v.any() and np.isinf(d).all() and d.shape == (2, 5)
    assert empty.vacuum() == _jax_index().vacuum()


def test_dcn_slices_give_the_flat_answers(jidx, data):
    _, qs = data
    flat, hier = _carry(jidx), _carry(jidx, dcn_slices=2)
    for mode in ("graph", "exact"):
        got, want = hier.search(qs, K, mode=mode), flat.search(qs, K,
                                                               mode=mode)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------- #
# maintenance
# ---------------------------------------------------------------------- #

def test_tune_ef_search_matches_jax(data):
    pts, qs = data
    cfg = dict(CFG, ef_search=8)
    ji = _jax_index(cfg=cfg)
    ji.build(pts[:900])
    ji.delete(np.arange(0, 900, 7))
    ti = _carry(ji)
    for target in (0.9, 0.9999):
        want = ji.tune_ef_search(qs, target_recall=target, k=K)
        got = ti.tune_ef_search(qs, target_recall=target, k=K)
        assert isinstance(got, TuneResult)
        assert got == tuple(want)
        assert ti.config.ef_search == ji.config.ef_search == got.ef
    with pytest.raises(TuneTargetMissed):
        ti.tune_ef_search(qs, target_recall=1.01, k=K, max_ef=16,
                          strict=True)
    ti.set_ef_search(24)
    ti.set_ef_construction(40)
    assert (ti.config.ef_search, ti.config.ef_construction) == (24, 40)


def test_compact_matches_jax(jidx, data):
    pts, qs = data
    knobs = dict(packed_traversal=True, packed_dtype="bfloat16",
                 search_expand_width=2, dcn_slices=2)
    ti = _carry(jidx, **knobs)
    ti.max_widen_ef, ti.pq_sweep_pool = 64, 128
    with _knobs(jidx, **knobs):
        jc = jidx.compact()
    tc = ti.compact()
    for key, val in knobs.items():
        assert getattr(tc, key) == getattr(jc, key) == val
    # attributes set after construction are not carried, in either package
    assert (tc.max_widen_ef, tc.pq_sweep_pool) == (4096, None)
    assert tc.n_shards == S and tc.device == ti.device
    assert tc.n_nodes == N - len(DEAD)
    _assert_same_state(tc, jc)
    assert not np.isin(tc._labels, DEAD[1:]).any()
    _assert_same_exact(tc.exact_search(qs, K), jc.exact_search(qs, K), qs,
                       pts)
    assert tc.vacuum() == jc.vacuum() and tc.vacuum()["num_dead"] == 0
    assert ti.n_nodes == N                        # the source is untouched
    assert _port_index().compact().n_nodes == 0


def test_vacuum_and_integrity_match_jax(jidx):
    ti = _carry(jidx)
    assert ti.vacuum() == jidx.vacuum()
    assert ti.vacuum()["n_shards"] == S
    assert ti.check_integrity() == jidx.check_integrity()
    # corrupt both copies the same way, in two shards
    links = np.asarray(jidx._arrays[1]).copy()
    cnts = np.asarray(jidx._arrays[2]).copy()
    links[0, 5, 0] = 5
    links[0, 7, 1] = links[0, 7, 0]
    links[2, 9, 0] = 600
    links[2, 11, cnts[2, 11]] = 2
    cnts[3, 13] = ti.config.max_m + 1
    bad_j = _jax_index()
    arrays = list(jidx._arrays)
    arrays[1], arrays[2] = bad_j._to_mesh(links), bad_j._to_mesh(cnts)
    bad_j._arrays, bad_j._counts = tuple(arrays), jidx.shard_counts
    bad_t = _carry(jidx)
    bad_t._links.copy_(torch.from_numpy(links))
    bad_t._link_counts.copy_(torch.from_numpy(cnts))
    want = bad_j.check_integrity(raise_on_error=False)
    assert all(want.values())
    assert bad_t.check_integrity(raise_on_error=False) == want
    with pytest.raises(AssertionError, match="violations"):
        bad_t.check_integrity()


def test_downcast_corpus_matches_jax(data):
    pts, qs = data
    ji = _jax_index()
    ji.build(pts[:1200])
    ti = _carry(ji)
    for idx in (ji, ti):
        idx.downcast_corpus("bfloat16")
        idx.downcast_corpus("bfloat16")                    # a no-op
    assert ti.storage_dtype == ji.storage_dtype == "bfloat16"
    assert ti._vectors.dtype == torch.bfloat16
    assert ti._graphs[1].vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ti._vectors.to(torch.float32).numpy(),
        np.asarray(ji._arrays[0].astype(jnp.float32)))
    stored = ti._vectors.to(torch.float32).numpy()
    rows = np.zeros((1200, D), np.float32)
    for i, n in enumerate(ti.shard_counts):
        rows[ti._labels[i, :n].astype(np.int64)] = stored[i, :n]
    _assert_same_exact(ti.exact_search(qs, K), ji.exact_search(qs, K), qs,
                       rows)
    _assert_same(ti.search(qs, K, mode="graph"),
                 ji.search(qs, K, mode="graph"))
    with pytest.raises(ValueError, match="cannot widen"):
        ti.downcast_corpus("float32")
    with pytest.raises(ValueError, match="unknown downcast"):
        ti.downcast_corpus("float16")
    # bf16 from the start stores the same rows, and later adds work
    for idx in (ji, ti):
        idx.add(pts[1200:1300])
    _assert_same_state(ti, ji)
    born = _port_index(storage_dtype="bfloat16")
    born.build(pts[:1300])
    assert torch.equal(born._vectors, ti._vectors)


def test_single_shard_equals_the_single_index(data):
    """S = 1 is the single index with the sharded defaults."""
    pts, qs = data
    one = _port_index(1)
    one.build(pts[:700])
    single = HnswIndex(HnswConfig(**CFG), device="cpu", max_insert_batch=128)
    single.build(pts[:700])
    assert torch.equal(one._links[0, :700], single.graph.links[:700])
    np.testing.assert_array_equal(one.search(qs, K, mode="graph")[1],
                                  single.search(qs, K, mode="graph")[1])


# ---------------------------------------------------------------------- #
# product quantization
# ---------------------------------------------------------------------- #

PQ = dict(packed_traversal=True, packed_dtype="pq", pq_groups=4)


@pytest.fixture(scope="module")
def jpq(data):
    """A JAX index with a trained global codebook (3 Lloyd iterations)."""
    pts, _ = data
    ji = _jax_index(**PQ)
    ji.pq_train_iters = 3
    ji.build(pts)
    ji.delete(DEAD)
    ji._ensure_pq_codebook()
    return ji


def test_pq_training_sample_matches_jax(data, monkeypatch):
    """The codebook trains on pq_train_sample / S strided rows of each
    shard, concatenated in shard order: both packages draw the same rows
    (the trainers themselves seed differently and are compared in
    test_torch_pq)."""
    pts, _ = data
    ji, ti = _jax_index(**PQ), _port_index(**PQ)
    drawn = {}
    for idx in (ji, ti):
        idx.pq_train_sample = 300
        idx.add(pts[:1303])                       # ragged shards
    monkeypatch.setattr(
        jax_pq, "train_pq", lambda sample, **kw: drawn.setdefault(
            "jax", np.asarray(sample)) * 0)
    monkeypatch.setattr(
        tsharded, "train_pq", lambda sample, **kw: drawn.setdefault(
            "torch", sample.numpy()) * 0)
    ji._ensure_pq_codebook()
    ti._ensure_pq_codebook()
    np.testing.assert_array_equal(drawn["torch"], drawn["jax"])
    assert len(drawn["torch"]) == sum(
        len(range(0, n, max(1, n // 75))) for n in ti.shard_counts)


def test_pq_walk_matches_jax_on_carried_codebook(jpq, data):
    _, qs = data
    ti = _carry(jpq, **PQ)
    assert ti._traversal_variant() == "pq" and ti._pq_codebook is not None
    _assert_same(ti.search(qs, K, mode="graph"),
                 jpq.search(qs, K, mode="graph"))
    np.testing.assert_array_equal(ti._pq_codes.numpy(),
                                  np.asarray(jpq._ensure_pq_codes()))
    recs, scales = ti._packed
    assert scales is None and recs.dtype == torch.uint8
    assert recs.shape == (S, ti.capacity_per_shard, ti.config.max_m, 4)
    np.testing.assert_array_equal(
        recs.reshape(S, ti.capacity_per_shard, -1).numpy(),
        np.asarray(jpq._packed[0]))


def test_sweep_pq_matches_jax_on_carried_codebook(jpq, data):
    pts, qs = data
    ti = _carry(jpq, **PQ)
    allowed = np.arange(0, N, 2, dtype=np.uint64)
    for kw in (dict(), dict(pool=16), dict(where=allowed)):
        got = ti.pq_sweep_search(qs, K, **kw)
        want = jpq.pq_sweep_search(qs, K, **kw)
        _assert_same(got, want)
        # every returned distance is the exact one
        d64 = np.linalg.norm(qs[:, None].astype(np.float64) -
                             pts[got[1].astype(np.int64)], axis=2)
        np.testing.assert_allclose(got[0], d64, rtol=1e-5)
        assert not np.isin(got[1], DEAD).any()
    _assert_same(ti.search(qs, K, mode="sweep_pq", where=allowed),
                 jpq.search(qs, K, mode="sweep_pq", where=allowed))
    assert (ti.search(qs, K, mode="sweep_pq", where=allowed)[1] % 2
            == 0).all()
    want = jpq.tune_sweep_pool(qs, target_recall=0.9, k=K)
    got = ti.tune_sweep_pool(qs, target_recall=0.9, k=K)
    assert got == tuple(want) and got.met
    assert ti.pq_sweep_pool == jpq.pq_sweep_pool == got.ef
    jpq.pq_sweep_pool = None
    with pytest.raises(TuneTargetMissed):
        ti.tune_sweep_pool(qs, target_recall=1.01, k=K, max_pool=32,
                           strict=True)


def test_opq_walk_and_sweep_match_jax(data):
    pts, qs = data
    ji = _jax_index(pq_opq=True, **PQ)
    ji.pq_train_iters = 2
    ji.build(pts[:1000])
    ji._ensure_pq_codebook()
    ti = _carry(ji, **PQ)
    assert ti.pq_opq and ti._pq_rot is not None
    _assert_same(ti.search(qs, K, mode="graph"),
                 ji.search(qs, K, mode="graph"))
    _assert_same(ti.pq_sweep_search(qs, K), ji.pq_sweep_search(qs, K))


def test_pq_trains_in_the_port_and_add_drops_the_codes(data):
    pts, qs = data
    ti = _port_index(**PQ)
    ti.pq_train_iters = 3
    ti.build(pts[:1500])
    got = ti.search(qs, K, mode="graph")
    assert _recall(got, ti.exact_search(qs, K)) >= 0.9
    cb = ti._pq_codebook
    assert cb.shape == (4, 256, D // 4) and ti._pq_codes is not None
    ti.add(pts[1500:1600])
    assert ti._pq_codes is None and ti._packed is None
    assert ti._pq_codebook is cb            # the dictionary survives adds
    assert _recall(ti.search(qs, K, mode="sweep_pq"),
                   ti.exact_search(qs, K)) >= 0.9


@pytest.mark.parametrize("metric", ["cosine", "manhattan"])
def test_other_metrics_match_jax(data, metric):
    """Cosine runs the fused sweep, Manhattan the chunked torch sweep (it
    has no matmul form); both walks use the metric's elementwise form."""
    pts, qs = data
    cfg = dict(CFG, metric=metric)
    ji = _jax_index(cfg=cfg)
    ji.build(pts[:1001])
    ji.delete(DEAD[:30])
    ti = _carry(ji)
    _assert_same(ti.search(qs, K, mode="graph"),
                 ji.search(qs, K, mode="graph"))
    got, want = ti.exact_search(qs, K), ji.exact_search(qs, K)
    np.testing.assert_array_equal(got[2], want[2])
    # atol 1e-5, as the single index's exact tests: the sweep's cosine is
    # 1 - cos in float32, whose error is a few ulps of 1, not of the result
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    # the sweeps may order rows at (nearly) one distance differently
    assert (got[1] == want[1]).mean() >= 0.99
    assert not np.isin(got[1], DEAD[:30]).any()


def test_scan_serves_a_packed_variant(jidx, data):
    """The cursor walks through the same records as search()."""
    _, qs = data
    knobs = dict(packed_traversal=True, packed_dtype="bfloat16")
    ti = _carry(jidx, **knobs)
    with _knobs(jidx, **knobs):
        want = jidx.open_scan(qs[0]).next(50)
    got = ti.open_scan(qs[0]).next(50)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert ti._packed is not None
