"""The compressed sweep (search(mode="sweep_pq"), ops/pq_sweep.py), the pool
tuner and PQ snapshots in the port against the JAX package, on the CPU;
the single-device cases of tests/test_pq_sweep.py plus direct parity.

Tolerances: the same codes and codebook give the JAX package's ids
(float32 near-ties excepted: none occur on these inputs) and distances to
rtol 1e-5; tune_sweep_pool picks the JAX package's pool; snapshots carry
pq_codebook / pq_groups_trained / pq_rot bit for bit both ways, and the
loaded index serves the JAX package's labels without a retrain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu.ops import pq as jpq
from pg_embedding_tpu.ops.pq_sweep import pq_sweep_search as jax_sweep
from pg_embedding_tpu_torch import (HnswConfig, HnswIndex, TuneTargetMissed,
                                    api)
from pg_embedding_tpu_torch.ops.bruteforce import exact_search
from pg_embedding_tpu_torch.ops.pq import pq_encode, train_pq
from pg_embedding_tpu_torch.ops.pq_sweep import pq_sweep_search

N, D = 3000, 32


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
def clustered():
    rng = np.random.default_rng(11)
    centers = rng.normal(scale=4.0, size=(100, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 100, N)] +
           rng.normal(size=(N, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 100, 32)] +
          rng.normal(size=(32, D))).astype(np.float32)
    return pts, qs


@pytest.fixture(scope="module")
def trained(clustered):
    """A codebook trained by each package on the same rows, and the
    port's codes from it."""
    pts, _ = clustered
    x = torch.from_numpy(pts)
    cb = train_pq(x, groups=8, iters=8)
    return x, cb, pq_encode(x, cb)


def _cfg(**kw):
    kw.setdefault("dims", D)
    kw.setdefault("m", 8)
    kw.setdefault("ef_construction", 32)
    kw.setdefault("ef_search", 32)
    return kw


def _recall(l, v, le, ve, k):
    return np.mean([len(set(l[i][v[i]].tolist()) &
                        set(le[i][ve[i]].tolist())) / k
                    for i in range(len(l))])


def _ids_recall(i, ie, k):
    return np.mean([len(set(i[r].tolist()) & set(ie[r].tolist())) / k
                    for r in range(len(i))])


# --------------------------------------------------------------------- #
# ops/pq_sweep.py against the JAX package's
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", [
    dict(metric="l2", k=10, pool=64),
    dict(metric="cosine", k=10, pool=32),
    dict(metric="manhattan", k=5, pool=64),
    dict(metric="l2", k=5, pool=32, n_valid=1000, deleted=True),
    dict(metric="l2", k=20, pool=8, rotate=True),
    dict(metric="l2", k=40, pool=64, n_valid=30, deleted=True),   # k > n
], ids=["l2", "cosine", "manhattan", "deleted_nvalid", "opq", "k_gt_n"])
def test_sweep_matches_jax(clustered, case):
    pts, qs = clustered
    x = jnp.asarray(pts)
    rot = None
    if case.get("rotate"):
        rot, cb = jpq.train_opq(x, groups=8, iters=2, pq_iters=4)
    else:
        cb = jpq.train_pq(x, groups=8, iters=4)
    codes = jpq.pq_encode(x, cb, rot)
    deleted = None
    if case.get("deleted"):
        deleted = np.zeros(N, bool)
        deleted[::7] = True
    kw = dict(n_valid=case.get("n_valid"), pool=case["pool"])
    jd, ji = jax_sweep(qs, codes, cb, rot, x, case["k"], case["metric"],
                       deleted=None if deleted is None
                       else jnp.asarray(deleted), **kw)
    t = (lambda a: None if a is None else torch.tensor(np.asarray(a)))
    td, ti = pq_sweep_search(qs, t(codes), t(cb), t(rot),
                             torch.from_numpy(pts), case["k"],
                             case["metric"], deleted=t(deleted), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    if case.get("n_valid") == 30:
        live = 30 - len(range(0, 30, 7))
        assert (ti.numpy()[:, live:] == -1).all()
        assert np.isinf(td.numpy()[:, live:]).all()


def test_sweep_recall_and_exact_distances(clustered, trained):
    _, qs = clustered
    x, cb, codes = trained
    d, i = pq_sweep_search(qs, codes, cb, None, x, 10, pool=64)
    de, ie = exact_search(qs, x, 10)
    d, i, de, ie = (t.numpy() for t in (d, i, de, ie))
    assert _ids_recall(i, ie, 10) >= 0.9
    # wherever the sweep found a true neighbour, its distance is exact
    for r in range(len(qs)):
        for c, idx in enumerate(i[r]):
            hit = np.nonzero(ie[r] == idx)[0]
            if len(hit):
                np.testing.assert_allclose(d[r, c], de[r, hit[0]],
                                           rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_sweep_pool_widens_recall(clustered):
    pts, qs = clustered
    x = torch.from_numpy(pts)
    cb = train_pq(x, groups=4, iters=8)     # coarse codes: distortion
    codes = pq_encode(x, cb)
    _, ie = exact_search(qs, x, 10)

    def rec(pool):
        _, i = pq_sweep_search(qs, codes, cb, None, x, 10, pool=pool)
        return _ids_recall(i.numpy(), ie.numpy(), 10)

    assert rec(128) >= rec(10) - 1e-9


def test_sweep_respects_deleted_and_nvalid(clustered, trained):
    _, qs = clustered
    x, cb, codes = trained
    _, i_full = pq_sweep_search(qs, codes, cb, None, x, 5, pool=32)
    dead_ids = np.unique(i_full.numpy()[i_full.numpy() >= 0])
    deleted = torch.zeros(N, dtype=torch.bool)
    deleted[torch.from_numpy(dead_ids)] = True
    _, i2 = pq_sweep_search(qs, codes, cb, None, x, 5, pool=32,
                            deleted=deleted)
    assert not np.isin(i2.numpy(), dead_ids).any()
    _, i3 = pq_sweep_search(qs, codes, cb, None, x, 5, pool=32, n_valid=100)
    assert i3.numpy().max() < 100


def test_sweep_manhattan_metric(clustered, trained):
    _, qs = clustered
    x, cb, codes = trained
    _, i = pq_sweep_search(qs, codes, cb, None, x, 5, metric="manhattan",
                           pool=64)
    _, ie = exact_search(qs, x, 5, metric="manhattan")
    assert _ids_recall(i.numpy(), ie.numpy(), 5) >= 0.8


# --------------------------------------------------------------------- #
# HnswIndex.search(mode="sweep_pq") / pq_sweep_search / tune_sweep_pool
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def built(clustered):
    pts, _ = clustered
    idx = HnswIndex(HnswConfig(**_cfg()), device="cpu")
    idx.build(pts)
    return idx


def test_index_sweep_pq_mode(built, clustered):
    _, qs = clustered
    d, l, v = built.search(qs, 10, mode="sweep_pq")
    _, le, ve = built.exact_search(qs, 10)
    assert v.all()
    assert _recall(l, v, le, ve, 10) >= 0.9
    assert np.all(np.diff(d, axis=1) >= -1e-6)
    assert built._pq_codes.shape == (built.graph.capacity, 16)


def test_index_sweep_pq_opq_rotation(clustered, monkeypatch):
    pts, qs = clustered
    monkeypatch.setattr(api, "_PQ_TRAIN_ITERS", 6)
    idx = HnswIndex(HnswConfig(**_cfg()), device="cpu", pq_opq=True)
    idx.build(pts)
    _, l, v = idx.search(qs, 10, mode="sweep_pq")
    _, le, ve = idx.exact_search(qs, 10)
    assert _recall(l, v, le, ve, 10) >= 0.9
    assert idx._pq_rot is not None


def test_index_sweep_pq_filters_and_tombstones(clustered):
    pts, qs = clustered
    idx = HnswIndex(HnswConfig(**_cfg()), device="cpu")
    idx.build(pts)
    _, l, v = idx.search(qs, 5, mode="sweep_pq")
    gone = np.unique(l[v])
    idx.delete(gone)
    _, l2, v2 = idx.search(qs, 5, mode="sweep_pq")
    assert not np.isin(l2[v2], gone).any()
    allowed = idx.labels[idx.labels % 2 == 0]
    _, l3, v3 = idx.search(qs, 5, mode="sweep_pq", where=allowed)
    assert (l3[v3] % 2 == 0).all()


def test_index_sweep_pq_codes_invalidated_on_insert(clustered):
    pts, qs = clustered
    idx = HnswIndex(HnswConfig(**_cfg()), device="cpu")
    idx.build(pts[:2000])
    idx.search(qs, 5, mode="sweep_pq")
    assert idx._pq_codes is not None
    idx.add(pts[2000:], np.arange(2000, N))
    assert idx._pq_codes is None          # the stale shadow is dropped
    _, l, v = idx.search(qs, 5, mode="sweep_pq")
    _, le, ve = idx.exact_search(qs, 5)
    assert _recall(l, v, le, ve, 5) >= 0.85


def test_index_sweep_pq_small_k_gt_n():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(6, D)).astype(np.float32)
    idx = HnswIndex(HnswConfig(**_cfg()), device="cpu")
    idx.build(pts)
    d, l, v = idx.search(pts[:2], 10, mode="sweep_pq")
    assert v[:, :6].all() and not v[:, 6:].any()
    assert np.isinf(d[:, 6:]).all()


def test_tune_sweep_pool_matches_jax(clustered):
    """With the same codebook both packages pick the same pool; the tuned
    pool becomes the mode's default; strict raises on a miss."""
    pts, qs = clustered
    ji = JaxIndex(JaxConfig(**_cfg()), pq_groups=4)   # coarse codes
    ji.pq_train_iters = 6
    ti = HnswIndex(HnswConfig(**_cfg()), device="cpu", pq_groups=4)
    for idx in (ji, ti):
        idx.build(pts)
    ji._ensure_pq_codes()
    ti._pq_codebook = torch.tensor(np.asarray(ji._pq_codebook))
    for target in (0.9, 0.99):
        want = ji.tune_sweep_pool(qs, target_recall=target, k=10)
        got = ti.tune_sweep_pool(qs, target_recall=target, k=10)
        assert got == want and ti.pq_sweep_pool == got.ef
        jd, jl, jv = ji.search(qs, 10, mode="sweep_pq")
        td, tl, tv = ti.search(qs, 10, mode="sweep_pq")
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, rtol=1e-5)
    with pytest.raises(TuneTargetMissed):
        ti.tune_sweep_pool(qs, target_recall=1.1, strict=True, max_pool=64)


# --------------------------------------------------------------------- #
# PQ snapshots, both ways
# --------------------------------------------------------------------- #

def _npz(path):
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_jax_pq_snapshot_serves_in_port(clustered, tmp_path, opq):
    pts, qs = clustered
    knobs = dict(packed_traversal=True, packed_dtype="pq", pq_groups=8,
                 pq_opq=opq)
    ji = JaxIndex(JaxConfig(**_cfg(ef_search=48)), **knobs)
    ji.pq_train_iters = 4
    ji.build(pts)
    ji.delete(np.arange(0, N, 41))
    jw = ji.search(qs, 10, mode="graph")             # trains the codebook
    js = ji.search(qs, 10, mode="sweep_pq")
    ji.save(str(tmp_path / "jax"))
    ti = HnswIndex.load(str(tmp_path / "jax"), device="cpu")
    assert (ti.pq_groups, ti.pq_opq) == (8, opq)
    np.testing.assert_array_equal(ti._pq_codebook.numpy(),
                                  np.asarray(ji._pq_codebook))
    ti.packed_traversal, ti.packed_dtype = True, "pq"
    for mode, (jd, jl, jv) in (("graph", jw), ("sweep_pq", js)):
        td, tl, tv = ti.search(qs, 10, mode=mode)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    # no retrain happened: the served codebook is the loaded one
    np.testing.assert_array_equal(ti._pq_codebook.numpy(),
                                  np.asarray(ji._pq_codebook))


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_port_pq_snapshot_loads_in_jax(clustered, tmp_path, opq,
                                      monkeypatch):
    pts, qs = clustered
    monkeypatch.setattr(api, "_PQ_TRAIN_ITERS", 4)
    ti = HnswIndex(HnswConfig(**_cfg()), device="cpu", pq_groups=8,
                   pq_opq=opq)
    ti.build(pts)
    d1, l1, _ = ti.search(qs, 10, mode="sweep_pq")   # trains the codebook
    path = str(tmp_path / "port.npz")
    ti.save(path)
    z = _npz(path)
    assert int(z["pq_groups_trained"]) == 8
    assert ("pq_rot" in z) == opq
    ji = JaxIndex.load(path)
    assert ji.pq_groups == 8 and ji.pq_opq == opq
    np.testing.assert_array_equal(np.asarray(ji._pq_codebook),
                                  ti._pq_codebook.numpy())
    if opq:
        np.testing.assert_array_equal(np.asarray(ji._pq_rot),
                                      ti._pq_rot.numpy())
    jd, jl, _ = ji.search(qs, 10, mode="sweep_pq")
    np.testing.assert_array_equal(jl, l1)
    np.testing.assert_allclose(jd, d1, rtol=1e-5)
    back = HnswIndex.load(path, device="cpu")        # and in the port
    d2, l2, _ = back.search(qs, 10, mode="sweep_pq")
    np.testing.assert_array_equal(l2, l1)
    np.testing.assert_allclose(d2, d1, rtol=1e-6)
