"""Product quantization in the port (pg_embedding_tpu_torch/ops/pq.py, the
PQ walk in core/search and the index's PQ knobs) against the JAX package's
ops/pq.py and HnswIndex(packed_dtype="pq"), on the CPU; the cases of
tests/test_pq.py on the single-device index, plus direct parity.

Tolerances: pq_decode and the packed records are bit-equal to the JAX
package's (pq_decode, pq_decode_mxu, flat records reshaped); codes from the
same codebook and rotation are equal (float64 near-ties excepted: none
occur on these inputs); _lloyd from the JAX package's init gives its
train_pq codebook within 1e-4 relative and the same assignments on
>= 99.9% of rows; train_opq gives an orthogonal rotation (|R^T R - I| <
1e-4) whose reconstruction error is within 2% of the JAX package's; the
PQ walk over a JAX-built graph and codebook returns the JAX walk's ids and
order, distances to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu.ops import pq as jpq
from pg_embedding_tpu_torch import HnswConfig, HnswIndex, api
from pg_embedding_tpu_torch.config import Metric
from pg_embedding_tpu_torch.convert import index_from_numpy
from pg_embedding_tpu_torch.core.search import search_graph_pq
from pg_embedding_tpu_torch.ops import pq as tpq

N, D, K = 2000, 32, 10
PQ = dict(packed_traversal=True, packed_dtype="pq", pq_groups=8)


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
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(N, D)).astype(np.float32)
    qs = (pts[rng.integers(0, N, 16)] +
          rng.normal(scale=0.05, size=(16, D))).astype(np.float32)
    return pts, qs


@pytest.fixture(scope="module")
def correlated():
    """Heavily correlated dims: a random low-rank mix of a few factors."""
    rng = np.random.default_rng(9)
    z = rng.normal(size=(3000, 6)).astype(np.float32)
    mix = rng.normal(size=(6, D)).astype(np.float32)
    return (z @ mix + 0.05 * rng.normal(size=(3000, D))).astype(np.float32)


def _cfg(**kw):
    kw.setdefault("dims", D)
    kw.setdefault("m", 8)
    kw.setdefault("ef_construction", 32)
    kw.setdefault("ef_search", 32)
    return kw


def _recall(idx, qs, k=K):
    _, l, v = idx.search(qs, k, mode="graph")
    _, le, ve = idx.exact_search(qs, k)
    return np.mean([len(set(l[i][v[i]]) & set(le[i][ve[i]])) / k
                    for i in range(len(qs))])


def _jax_init(x, groups, seed=0):
    """The JAX package's init codebook for train_pq(x, groups, seed)."""
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                        (groups, 256), 0, len(x)))
    xg = x.reshape(len(x), groups, -1).transpose(1, 0, 2)
    return np.take_along_axis(xg, idx[:, :, None], axis=1)


def _recon_err(x, codes, cb, rot=None):
    rec = tpq.pq_decode(torch.as_tensor(codes), torch.as_tensor(cb)).numpy()
    if rot is not None:
        rec = rec @ np.asarray(rot).T
    return float(np.mean(np.sum((rec - x) ** 2, axis=1)))


# --------------------------------------------------------------------- #
# ops/pq.py against the JAX package's
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("groups", [4, 8])
def test_lloyd_matches_jax_train_pq(data, groups):
    pts, _ = data
    want = np.asarray(jpq.train_pq(jnp.asarray(pts), groups=groups,
                                   iters=12))
    x = tpq._group_view(torch.from_numpy(pts), groups).contiguous()
    got = tpq._lloyd(x, torch.from_numpy(_jax_init(pts, groups)),
                     12).numpy()
    assert got.shape == (groups, 256, D // groups)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    ja = np.asarray(jpq.encode_block(jnp.asarray(pts), jnp.asarray(want)))
    ta = tpq.encode_block(torch.from_numpy(pts), torch.from_numpy(got))
    assert (ta.numpy() == ja).all(axis=1).mean() >= 0.999


def test_init_draw_is_seeded():
    a = tpq.init_rows(1000, 8, seed=3)
    assert a.shape == (8, 256) and a.dtype == torch.int64
    assert 0 <= int(a.min()) and int(a.max()) < 1000
    assert torch.equal(a, tpq.init_rows(1000, 8, seed=3))
    assert not torch.equal(a, tpq.init_rows(1000, 8, seed=4))


@pytest.mark.parametrize("rotate", [False, True])
def test_encode_matches_jax(data, rotate):
    pts, _ = data
    x = jnp.asarray(pts)
    cb = jpq.train_pq(x, groups=8, iters=6)
    rot = (jnp.asarray(np.linalg.qr(
        np.random.default_rng(2).normal(size=(D, D)))[0], jnp.float32)
        if rotate else None)
    want = np.asarray(jpq.pq_encode(x, cb, rot, chunk=512))
    got = tpq.pq_encode(torch.from_numpy(pts), torch.tensor(np.asarray(cb)),
                        None if rot is None else torch.tensor(
                            np.asarray(rot)), chunk=700)
    assert got.dtype == torch.uint8 and got.shape == (N, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    block = tpq.encode_block(torch.from_numpy(pts[:300]),
                             torch.tensor(np.asarray(cb)))
    if not rotate:
        np.testing.assert_array_equal(block.numpy(), want[:300])


def test_decode_and_records_bit_equal_jax(data):
    pts, _ = data
    x = jnp.asarray(pts)
    cb = jpq.train_pq(x, groups=8, iters=4)
    codes = jpq.pq_encode(x, cb)
    got = tpq.pq_decode(torch.from_numpy(np.asarray(codes)),
                        torch.from_numpy(np.asarray(cb))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpq.pq_decode(codes, cb)))
    np.testing.assert_array_equal(got,
                                  np.asarray(jpq.pq_decode_mxu(codes, cb)))
    links = np.random.default_rng(1).integers(-1, N, (N + 64, 16)).astype(
        np.int32)
    codes_cap = jnp.concatenate([codes, jnp.zeros((64, 8), jnp.uint8)])
    want = np.asarray(jpq.pack_pq_records(codes_cap, jnp.asarray(links),
                                          chunk=512))
    recs = tpq.pack_pq_records(torch.from_numpy(np.asarray(codes_cap)),
                               torch.from_numpy(links))
    assert recs.dtype == torch.uint8 and recs.shape == (N + 64, 16, 8)
    np.testing.assert_array_equal(recs.numpy(), want.reshape(N + 64, 16, 8))


def test_pq_roundtrip_reconstruction(rng):
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    cb = tpq.train_pq(xt, groups=8, iters=10)
    assert cb.shape == (8, 256, 4)
    rel = _recon_err(x, tpq.pq_encode(xt, cb), cb) / np.mean(
        np.sum(x ** 2, axis=1))
    # iid gaussian is the worst case for PQ; 256 centroids over 4 dims
    # still reconstruct under ~15% relative error
    assert rel < 0.15
    cb16 = tpq.train_pq(xt, groups=16, iters=10)
    rel16 = _recon_err(x, tpq.pq_encode(xt, cb16), cb16) / np.mean(
        np.sum(x ** 2, axis=1))
    assert rel16 < rel


def test_pq_encode_chunked_matches_block(rng):
    x = torch.from_numpy(rng.normal(size=(5000, 16)).astype(np.float32))
    cb = tpq.train_pq(x[:2000], groups=4, iters=6)
    chunked = tpq.pq_encode(x, cb, chunk=1024)
    assert chunked.dtype == torch.uint8
    assert torch.equal(chunked, tpq.encode_block(x, cb))


def test_pq_codes_are_nearest_centroids(rng):
    x = rng.normal(size=(200, 8)).astype(np.float32)
    cb = tpq.train_pq(torch.from_numpy(x), groups=2, iters=8)
    codes = tpq.pq_encode(torch.from_numpy(x), cb).numpy()
    cbn = cb.numpy()
    for g in range(2):
        sub = x[:, g * 4:(g + 1) * 4]
        d = ((sub[:, None, :] - cbn[g][None, :, :]) ** 2).sum(-1)
        np.testing.assert_array_equal(codes[:, g], d.argmin(1))


def test_opq_matches_jax_properties(correlated):
    """OPQ's rotation is orthogonal, its codebook reconstructs as well as
    the JAX package's (within 2%), and better than plain PQ on correlated
    dims.  The rotation itself is unique only up to the SVD's freedom, so
    it is held to properties, not bits."""
    x = correlated
    jrot, jcb = jpq.train_opq(jnp.asarray(x), groups=8, iters=6,
                              pq_iters=10)
    err_jax = _recon_err(x, np.asarray(jpq.pq_encode(jnp.asarray(x), jcb,
                                                     jrot)),
                         np.asarray(jcb), jrot)
    xt = torch.from_numpy(x)
    rot, cb = tpq.train_opq(xt, groups=8, iters=6, pq_iters=10)
    r = rot.numpy()
    assert np.abs(r.T @ r - np.eye(D)).max() < 1e-4
    err_opq = _recon_err(x, tpq.pq_encode(xt, cb, rot), cb, r)
    assert abs(err_opq - err_jax) <= 0.02 * err_jax, (err_opq, err_jax)
    cb_pq = tpq.train_pq(xt, groups=8, iters=10)
    assert err_opq < _recon_err(x, tpq.pq_encode(xt, cb_pq), cb_pq)


def test_pq_groups_must_divide_dims():
    with pytest.raises(ValueError):
        tpq.train_pq(torch.zeros((10, 30)), groups=4)
    with pytest.raises(ValueError, match="not divisible"):
        HnswIndex(HnswConfig(**_cfg(dims=30)), device="cpu",
                  packed_traversal=True, packed_dtype="pq", pq_groups=4)


def test_opq_rejects_manhattan():
    with pytest.raises(ValueError, match="rotation-invariant"):
        HnswIndex(HnswConfig(**_cfg(metric=Metric.MANHATTAN)), device="cpu",
                  pq_opq=True, **PQ)


# --------------------------------------------------------------------- #
# the PQ walk against the JAX package's, on a JAX-built graph + codebook
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module", params=[False, True], ids=["pq", "opq"])
def jax_pq(request, data):
    pts, qs = data
    ji = JaxIndex(JaxConfig(**_cfg(ef_search=48)), pq_opq=request.param,
                  **PQ)
    ji.pq_train_iters = 6
    ji.build(pts)
    ji.delete(np.arange(0, N, 37))
    ji.search(qs[:2], K, mode="graph")             # trains and packs
    return ji


def _port(ji, **knobs):
    g = ji.graph
    return index_from_numpy(
        HnswConfig(**ji.config.to_dict()), g.vectors, g.links, g.link_counts,
        g.deleted, ji.n_nodes, ji.labels, pq_codebook=ji._pq_codebook,
        pq_rot=ji._pq_rot, **knobs)


def test_pq_walk_matches_jax(jax_pq, data):
    _, qs = data
    ji = jax_pq
    ti = _port(ji, **PQ)
    assert ti.pq_opq == ji.pq_opq and ti.pq_groups == 8
    jd, jl, jv = ji.search(qs, K, mode="graph")
    td, tl, tv = ti.search(qs, K, mode="graph")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.search_ids(qs, 48)[1],
                                  ji.search_ids(qs, 48)[1])
    # the port's records are the JAX package's flat records, reshaped
    np.testing.assert_array_equal(
        ti._pcodes.numpy(),
        np.asarray(ji._pcodes).reshape(ti._pcodes.shape))
    assert ti._pcodes.shape == (ti.graph.capacity, ti.config.max_m, 8)


def test_search_graph_pq_direct(jax_pq, data):
    """core.search.search_graph_pq on the JAX package's own records and
    codebook gives its search_graph_pq's ids, order and counters."""
    from pg_embedding_tpu.core.search import search_graph_pq as jax_walk

    _, qs = data
    ji = jax_pq
    ti = _port(ji)
    rot = ji._pq_rot
    jd, jids, js = jax_walk(ji.graph, jnp.asarray(qs), ji._pcodes,
                            ji._pq_codebook, rot, ef=32, metric_value=0,
                            expand_width=4)
    recs = torch.from_numpy(np.asarray(ji._pcodes)).view(
        ti.graph.capacity, ti.config.max_m, 8)
    td, tids, ts = search_graph_pq(
        ti.graph, torch.from_numpy(qs), recs, ti._pq_codebook, ti._pq_rot,
        ef=32, metric_value=0, expand_width=4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(ts.hops.numpy(), np.asarray(js.hops))
    np.testing.assert_array_equal(ts.dist_evals.numpy(),
                                  np.asarray(js.dist_evals))


# --------------------------------------------------------------------- #
# the index's PQ knobs (tests/test_pq.py, single device)
# --------------------------------------------------------------------- #

def test_pq_packed_traversal_recall(data):
    pts, qs = data
    idx = HnswIndex(HnswConfig(**_cfg(ef_search=64)), device="cpu", **PQ)
    idx.build(pts)
    assert _recall(idx, qs) >= 0.9
    assert idx._pcodes.shape == (idx.graph.capacity, idx.config.max_m, 8)
    assert idx._pcodes.dtype == torch.uint8


def test_pq_packed_agrees_with_plain(data):
    pts, qs = data
    plain = HnswIndex(HnswConfig(**_cfg()), device="cpu")
    plain.build(pts)
    pq = HnswIndex(HnswConfig(**_cfg()), device="cpu", **PQ)
    pq.build(pts)
    _, lp, _ = plain.search(qs, 5, mode="graph")
    _, lq, _ = pq.search(qs, 5, mode="graph")
    agree = np.mean([len(set(lp[i]) & set(lq[i])) / 5
                     for i in range(len(qs))])
    assert agree >= 0.85


def test_pq_records_invalidated_by_insert_codebook_kept(data):
    pts, qs = data
    idx = HnswIndex(HnswConfig(**_cfg(ef_search=64)), device="cpu", **PQ)
    idx.build(pts[:1400])
    assert _recall(idx, qs) >= 0.8
    cb = idx._pq_codebook
    assert cb is not None and idx._pq_codes is not None
    idx.add(pts[1400:])
    assert idx._pcodes is None and idx._pq_codes is None
    assert idx._pq_codebook is cb       # the dictionary survives growth
    assert _recall(idx, qs) >= 0.9


def test_pq_codebook_reset_on_build_and_compact(data, monkeypatch):
    pts, _ = data
    monkeypatch.setattr(api, "_PQ_TRAIN_ITERS", 3)
    idx = HnswIndex(HnswConfig(**_cfg()), device="cpu", pq_opq=True, **PQ)
    idx.build(pts[:600])
    idx.search(pts[:4], 5, mode="graph")
    assert idx._pq_codebook is not None and idx._pq_rot is not None
    idx2 = idx.compact()
    assert (idx2.packed_dtype, idx2.pq_groups, idx2.pq_opq) == ("pq", 8,
                                                                True)
    assert idx2._pq_codebook is None
    fresh = HnswIndex(HnswConfig(**_cfg()), device="cpu", **PQ)
    fresh._pq_codebook = idx._pq_codebook
    fresh.build(pts[:100])                 # build() resets the dictionary
    assert fresh._pq_codebook is None and fresh._pq_codes is None


def test_opq_packed_traversal(data, monkeypatch):
    pts, qs = data
    monkeypatch.setattr(api, "_PQ_TRAIN_ITERS", 6)
    idx = HnswIndex(HnswConfig(**_cfg(ef_search=64)), device="cpu",
                    pq_opq=True, **PQ)
    idx.build(pts)
    assert _recall(idx, qs) >= 0.9
    r = idx._pq_rot.numpy()
    assert not np.allclose(r, np.eye(D))        # a real rotation
    assert np.abs(r.T @ r - np.eye(D)).max() < 1e-4


def test_downcast_keeps_pq_shadows_and_serves(rng):
    """tests/test_downcast.py's PQ case: the shadows encoded from float32
    rows survive the bf16 cast, and the walk keeps its recall."""
    centers = rng.normal(scale=4.0, size=(50, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 50, 1500)] +
           rng.normal(size=(1500, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 50, 16)] +
          rng.normal(size=(16, D))).astype(np.float32)
    idx = HnswIndex(HnswConfig(**_cfg(m=8, ef_construction=48,
                                      ef_search=48)), device="cpu", **PQ)
    idx.build(pts)
    _, le, ve = idx.exact_search(qs, 10)
    pc, _ = idx._ensure_packed()
    shadows = (idx._pq_codebook, idx._pq_codes)
    idx.downcast_corpus("bfloat16")
    assert idx.graph.vectors.dtype == torch.bfloat16
    assert idx._pcodes is pc
    assert (idx._pq_codebook, idx._pq_codes) == shadows
    _, l, v = idx.search(qs, 10, mode="graph")
    assert np.mean([len(set(l[i][v[i]]) & set(le[i][ve[i]])) / 10
                    for i in range(16)]) >= 0.8
