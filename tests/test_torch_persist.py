"""Snapshots move both ways between the JAX package and the port, on the
CPU: HnswIndex.save / load write and read the same npz format.

Tolerances: none.  Keys, dtypes and arrays are equal; labels, links and
tombstones are identical after a load in either direction; the same
queries give the same ids (graph and exact route) and distances to
rtol 1e-6 (the same arithmetic on the same arrays); a bf16 corpus
round-trips bit for bit (both frameworks round to nearest even)."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu_torch import HnswConfig, HnswIndex

N, D, K = 900, 16, 8
CFG = dict(dims=D, m=6, ef_construction=32, ef_search=32)


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
    rng = np.random.default_rng(23)
    centers = rng.normal(scale=3.0, size=(20, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 20, N)] +
           rng.normal(size=(N, D))).astype(np.float32)
    qs = rng.normal(scale=3.0, size=(40, D)).astype(np.float32)
    return pts, qs


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, data):
    """The same index built by both packages, with tombstones."""
    pts, _ = data
    labels = np.arange(N, dtype=np.uint64) * 5 + 3
    ji = JaxIndex(JaxConfig(**CFG), storage_dtype=request.param)
    ti = HnswIndex(HnswConfig(**CFG), device="cpu",
                   storage_dtype=request.param)
    for idx in (ji, ti):
        idx.build(pts, labels)
        idx.delete(labels[::17])
    return request.param, ji, ti


def _npz(path):
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _same_answers(a, b, qs):
    for mode in ("graph", "exact"):
        da, la, va = a.search(qs, K, mode=mode)
        db, lb, vb = b.search(qs, K, mode=mode)
        np.testing.assert_array_equal(lb, la)
        np.testing.assert_array_equal(vb, va)
        np.testing.assert_allclose(db, da, rtol=1e-6)


def test_same_file_format(pair, tmp_path):
    dtype, ji, ti = pair
    ji.save(str(tmp_path / "jax"))
    ti.save(str(tmp_path / "torch"))
    zj, zt = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "torch.npz")
    assert sorted(zt) == sorted(zj)
    for key in zj:
        assert zt[key].dtype == zj[key].dtype, key
        assert zt[key].shape == zj[key].shape, key
    assert bytes(zt["storage_dtype"]).decode() == dtype
    for key in ("config", "labels", "deleted", "format_version"):
        np.testing.assert_array_equal(zt[key], zj[key])


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_load_across(pair, data, tmp_path, direction):
    dtype, ji, ti = pair
    _, qs = data
    path = str(tmp_path / "snap.npz")
    if direction == "jax_to_torch":
        src = ji
        ji.save(path)
        back = HnswIndex.load(path, device="cpu")
        assert back.graph.vectors.dtype == getattr(torch, dtype)
        vec = back.graph.vectors.float().numpy()
        links, cnts = back.graph.links.numpy(), back.graph.link_counts.numpy()
        dead = back.graph.deleted.numpy()
    else:
        src = ti
        ti.save(path)
        back = JaxIndex.load(path)
        vec = np.asarray(back.graph.vectors, np.float32)
        links, cnts = (np.asarray(back.graph.links),
                       np.asarray(back.graph.link_counts))
        dead = np.asarray(back.graph.deleted)
    g = src.graph
    src_vec = (g.vectors.float().numpy() if isinstance(g.vectors,
                                                       torch.Tensor)
               else np.asarray(g.vectors, np.float32))
    assert back.storage_dtype == dtype
    assert back.n_nodes == N
    assert back.graph.capacity == 928          # round(max(n, 32))
    np.testing.assert_array_equal(vec[:N], src_vec[:N])   # bit for bit
    np.testing.assert_array_equal(links[:N], np.asarray(g.links)[:N])
    np.testing.assert_array_equal(cnts[:N], np.asarray(g.link_counts)[:N])
    np.testing.assert_array_equal(dead[:N], np.asarray(g.deleted)[:N])
    np.testing.assert_array_equal(back.labels, src.labels)
    assert back.counters["n_deleted"] == src.counters["n_deleted"] > 0
    _same_answers(src, back, qs)


def test_round_trip_and_growth(pair, data, tmp_path):
    """save -> load -> save writes identical arrays; the loaded index keeps
    taking inserts (its capacity grows as the JAX index's does)."""
    dtype, ji, ti = pair
    pts, qs = data
    ti.save(str(tmp_path / "a"), compressed=True)
    back = HnswIndex.load(str(tmp_path / "a"), device="cpu")
    back.save(str(tmp_path / "b"), compressed=False)
    za, zb = _npz(tmp_path / "a.npz"), _npz(tmp_path / "b.npz")
    for key in za:
        assert zb[key].dtype == za[key].dtype, key
        np.testing.assert_array_equal(zb[key], za[key])
    jback = JaxIndex.load(str(tmp_path / "a"))
    extra = pts[:50] + 0.5
    back.add(extra, np.arange(50, dtype=np.uint64) + 10_000)
    jback.add(extra, np.arange(50, dtype=np.uint64) + 10_000)
    assert back.graph.capacity == jback.graph.capacity
    _same_answers(jback, back, qs)


def test_frozen_fields_guard(pair, tmp_path):
    _, _, ti = pair
    path = str(tmp_path / "s.npz")
    ti.save(path)
    with pytest.raises(ValueError, match="frozen"):
        HnswIndex.load(path, HnswConfig(**dict(CFG, m=8)), device="cpu")
    back = HnswIndex.load(path, HnswConfig(**dict(CFG, ef_search=64)),
                          device="cpu")
    assert back.config.ef_search == 64


def test_pq_codebook_survives(data, tmp_path):
    """A snapshot carrying a trained PQ codebook (and an OPQ rotation)
    loads in the port as live tensors equal to the saved arrays, serves the
    compressed sweep, and saves back unchanged."""
    pts, qs = data
    ji = JaxIndex(JaxConfig(**CFG), packed_traversal=True, packed_dtype="pq",
                  pq_groups=4, pq_opq=True)
    ji.pq_train_iters = 2
    ji.build(pts[:300])
    ji.search(qs[:2], K, mode="graph")           # trains the codebook
    ji.save(str(tmp_path / "pq"))
    back = HnswIndex.load(str(tmp_path / "pq"), device="cpu")
    za = _npz(tmp_path / "pq.npz")
    assert (back.pq_groups, back.pq_opq) == (4, True)
    np.testing.assert_array_equal(back._pq_codebook.numpy(),
                                  za["pq_codebook"])
    np.testing.assert_array_equal(back._pq_rot.numpy(), za["pq_rot"])
    _, _, v = back.search(qs, K, mode="sweep_pq")
    assert v.all()
    back.save(str(tmp_path / "again"))
    zb = _npz(tmp_path / "again.npz")
    assert {"pq_codebook", "pq_groups_trained", "pq_rot"} <= set(zb)
    assert sorted(zb) == sorted(za)
    for key in za:
        assert zb[key].dtype == za[key].dtype, key
        np.testing.assert_array_equal(zb[key], za[key])
