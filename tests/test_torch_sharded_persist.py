"""Snapshots, the write-ahead log and scan cursors of the port's sharded
index against the JAX package's, on the CPU.

Files move both ways: what one package saves (monolithic or one file per
shard) the other loads and serves with the same answers, and a WAL written
by one replays in the other.  Files are compared key for key and dtype for
dtype.  Scans are compared page by page on state carried across with
convert.sharded_index_from_numpy.

Tolerances: labels, validity and page contents equal; distances to rtol
1e-5 / atol 1e-6 (float32 sums in another order).  An index rebuilt from a
log (replay re-inserts the rows) is held to the build bar: link rows equal
on >= 95% of each shard's rows.
"""

import os

import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import ShardedHnswIndex as JaxSharded
from pg_embedding_tpu.parallel.sharded import default_mesh
from pg_embedding_tpu_torch import HnswConfig, ShardedHnswIndex
from pg_embedding_tpu_torch.convert import sharded_index_from_numpy
from pg_embedding_tpu_torch.parallel.sharded import ShardedScan

N, D, K, S = 1501, 16, 8, 4
CFG = dict(dims=D, m=8, ef_construction=32, ef_search=16)
DEAD = np.arange(0, N, 19, dtype=np.uint64)


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
    rng = np.random.default_rng(59)
    centers = rng.normal(scale=3.0, size=(25, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 25, N + 200)] +
           rng.normal(size=(N + 200, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 25, 24)] +
          rng.normal(size=(24, D))).astype(np.float32)
    return pts, qs


def _jax_index(s=S, cfg=CFG, **kw):
    return JaxSharded(JaxConfig(**cfg), mesh=default_mesh(s), **kw)


def _port_index(s=S, cfg=CFG, **kw):
    return ShardedHnswIndex(HnswConfig(**cfg), s, device="cpu", **kw)


def _carry(ji, **knobs):
    vec, lnk, cnt, dlt, _ = (np.asarray(a) for a in ji._arrays)
    cb = None if ji._pq_codebook is None else np.asarray(ji._pq_codebook)
    rot = None if ji._pq_rot is None else np.asarray(ji._pq_rot)
    return sharded_index_from_numpy(
        HnswConfig.from_dict(ji.config.to_dict()), vec, lnk, cnt, dlt,
        ji.shard_counts, ji._labels, ji._positions, device="cpu",
        pq_codebook=cb, pq_rot=rot, **knobs)


@pytest.fixture(scope="module")
def jidx(data):
    pts, _ = data
    ji = _jax_index()
    ji.build(pts[:N], np.arange(N) + 10_000)
    ji.delete(DEAD + 10_000)
    return ji


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def _assert_same_answers(ti, ji, qs):
    _assert_same(ti.search(qs, K, mode="graph"),
                 ji.search(qs, K, mode="graph"))
    got, want = ti.exact_search(qs, K), ji.exact_search(qs, K)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    # the exact sweeps may order rows at (nearly) one distance differently
    assert (got[1] == want[1]).mean() >= 0.99


def _assert_same_state(ti, ji, min_same=1.0):
    np.testing.assert_array_equal(ti.shard_counts, ji.shard_counts)
    n_max = int(ti.shard_counts.max())
    np.testing.assert_array_equal(ti._labels[:, :n_max],
                                  ji._labels[:, :n_max])
    np.testing.assert_array_equal(ti._positions[:, :n_max],
                                  ji._positions[:, :n_max])
    jl, jd = np.asarray(ji._arrays[1]), np.asarray(ji._arrays[3])
    for i, n in enumerate(ti.shard_counts):
        same = (ti._links[i, :n].numpy() == jl[i, :n]).all(axis=1)
        assert same.mean() >= min_same, (i, same.mean())
        np.testing.assert_array_equal(ti._deleted[i, :n].numpy(), jd[i, :n])


def _files(path):
    """{file name: {key: (dtype, shape)}} of a snapshot and its shard
    files."""
    stem = os.path.basename(path)[:-4]
    out = {}
    for name in sorted(os.listdir(os.path.dirname(path))):
        if name.startswith(stem) and name.endswith(".npz"):
            with np.load(os.path.join(os.path.dirname(path), name)) as z:
                out[name] = {k: (z[k].dtype, z[k].shape) for k in z.files}
    return out


# ---------------------------------------------------------------------- #
# snapshots
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("per_shard", [False, True])
def test_save_files_match_jax(jidx, tmp_path, per_shard):
    """Equal keys, dtypes and shapes, file by file, and equal contents."""
    ti = _carry(jidx)
    jp, tp = str(tmp_path / "j" / "idx.npz"), str(tmp_path / "t" / "idx")
    jidx.save(jp, per_shard=per_shard)
    ti.save(tp, per_shard=per_shard)            # the suffix is added
    jf, tf = _files(jp), _files(tp + ".npz")
    assert tf == jf
    assert len(tf) == (1 + S if per_shard else 1)
    for name in tf:
        with np.load(tmp_path / "j" / name) as zj, \
                np.load(tmp_path / "t" / name) as zt:
            for key in zj.files:
                np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)
    assert not [f for f in os.listdir(tmp_path / "t") if f.endswith(".tmp")]


@pytest.mark.parametrize("per_shard", [False, True])
def test_jax_saves_port_loads(jidx, data, tmp_path, per_shard):
    _, qs = data
    path = str(tmp_path / "idx.npz")
    jidx.save(path, per_shard=per_shard)
    ti = ShardedHnswIndex.load(path, device="cpu")
    assert ti.n_shards == S and ti.device.type == "cpu"
    assert ti.capacity_per_shard == JaxSharded.load(
        path, mesh=default_mesh(S)).capacity_per_shard
    assert ti.counters["n_inserted"] == N
    _assert_same_state(ti, jidx)
    _assert_same_answers(ti, jidx, qs)
    ti.check_integrity()


@pytest.mark.parametrize("per_shard", [False, True])
def test_port_saves_jax_loads(jidx, data, tmp_path, per_shard):
    pts, qs = data
    ti = _carry(jidx)
    path = str(tmp_path / "idx.npz")
    ti.save(path, per_shard=per_shard)
    ji = JaxSharded.load(path, mesh=default_mesh(S))
    _assert_same_state(ti, ji)
    _assert_same_answers(ti, ji, qs)
    # both keep working after a load: the same rows go in the same way
    back = ShardedHnswIndex.load(path, n_shards=S, device="cpu")
    for idx in (ji, back):
        idx.add(pts[N:N + 150])
    _assert_same_state(back, ji, min_same=0.95)
    assert back.n_nodes == N + 150
    assert N + 149 in back._labels          # default labels: n_inserted on


def test_load_guards_and_hints(jidx, tmp_path):
    ti = _carry(jidx)
    path = str(tmp_path / "idx.npz")
    ti.save(path)
    with pytest.raises(ValueError, match="resharding requires a rebuild"):
        ShardedHnswIndex.load(path, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        ShardedHnswIndex.load(path, config=HnswConfig(dims=D, m=9),
                              device="cpu")
    wide = ShardedHnswIndex.load(path, device="cpu", dcn_slices=2,
                                 config=HnswConfig(**dict(CFG, ef_search=48)))
    assert wide.config.ef_search == 48 and wide.dcn_slices == 2
    with pytest.raises(ValueError, match="dcn_slices"):
        ShardedHnswIndex.load(path, device="cpu", dcn_slices=3)


def test_legacy_file_without_positions(jidx, data, tmp_path):
    """Files from before insert positions were saved: both packages
    reconstruct them for a round-robin build from zero."""
    _, qs = data
    path, legacy = str(tmp_path / "idx.npz"), str(tmp_path / "old.npz")
    jidx.save(path)
    with np.load(path) as z:
        np.savez(legacy, **{k: z[k] for k in z.files if k != "positions"})
    ti = ShardedHnswIndex.load(legacy, device="cpu")
    ji = JaxSharded.load(legacy, mesh=default_mesh(S))
    np.testing.assert_array_equal(ti._positions, ji._positions)
    np.testing.assert_array_equal(ti._positions[1, :3], [1, 5, 9])
    mask = np.arange(N) % 2 == 0
    _assert_same(ti.search(qs, K, mode="graph", where=mask),
                 ji.search(qs, K, mode="graph", where=mask))


def test_bf16_and_empty_snapshots(data, tmp_path):
    pts, qs = data
    ji, ti = (_jax_index(storage_dtype="bfloat16"),
              _port_index(storage_dtype="bfloat16"))
    for idx in (ji, ti):
        idx.build(pts[:600])
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    ji.save(jp, per_shard=True)
    ti.save(tp, per_shard=True)
    assert {k[1:]: v for k, v in _files(tp).items()} == \
        {k[1:]: v for k, v in _files(jp).items()}
    back = ShardedHnswIndex.load(jp, device="cpu")
    assert back.storage_dtype == "bfloat16"
    assert back._vectors.dtype == torch.bfloat16
    assert torch.equal(back._vectors[:, :150], ti._vectors[:, :150])
    _assert_same(back.search(qs, K, mode="graph"),
                 ji.search(qs, K, mode="graph"))
    # an empty index round-trips in both layouts
    for per_shard in (False, True):
        ep = str(tmp_path / f"e{int(per_shard)}.npz")
        _port_index().save(ep, per_shard=per_shard)
        for loaded in (ShardedHnswIndex.load(ep, device="cpu"),
                       JaxSharded.load(ep, mesh=default_mesh(S))):
            assert loaded.n_nodes == 0 and loaded.capacity_per_shard == 32


@pytest.mark.parametrize("opq", [False, True])
def test_pq_codebook_persists_both_ways(data, tmp_path, opq):
    pts, qs = data
    pq = dict(packed_traversal=True, packed_dtype="pq", pq_groups=4)
    ji = _jax_index(pq_opq=opq, **pq)
    ji.pq_train_iters = 2
    ji.build(pts[:900])
    ji._ensure_pq_codebook()
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    ji.save(jp, per_shard=opq)
    # loaded with default knobs: the file's dictionary is served as saved
    ti = ShardedHnswIndex.load(jp, device="cpu")
    assert ti.pq_groups == 4 and ti.pq_opq == opq
    np.testing.assert_array_equal(ti._pq_codebook.numpy(),
                                  np.asarray(ji._pq_codebook))
    assert (ti._pq_rot is not None) == opq
    ti.packed_traversal, ti.packed_dtype = True, "pq"
    _assert_same(ti.search(qs, K, mode="graph"),
                 ji.search(qs, K, mode="graph"))
    _assert_same(ti.search(qs, K, mode="sweep_pq"),
                 ji.search(qs, K, mode="sweep_pq"))
    ti.save(tp, per_shard=opq)
    assert _files(tp)["t.npz"] == _files(jp)["j.npz"]
    back = JaxSharded.load(tp, mesh=default_mesh(S))
    np.testing.assert_array_equal(np.asarray(back._pq_codebook),
                                  np.asarray(ji._pq_codebook))
    _assert_same(ti.search(qs, K, mode="sweep_pq"),
                 back.search(qs, K, mode="sweep_pq"))


# ---------------------------------------------------------------------- #
# the write-ahead log
# ---------------------------------------------------------------------- #

def _logged_run(idx, pts, snap, wal):
    """A snapshot, then logged writes that no snapshot covers."""
    idx.build(pts[:400], np.arange(400) + 500)
    idx.enable_wal(wal)
    idx.save(snap)
    idx.add(pts[400:530])
    idx.delete(np.arange(500, 540, dtype=np.uint64))
    idx.delete_where(np.arange(530) % 50 == 49)
    idx.add(pts[530:601], np.arange(71) + 9000)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_across_packages(data, tmp_path, writer):
    pts, qs = data
    snap, wal = str(tmp_path / "s.npz"), str(tmp_path / "w.wal")
    src = _jax_index() if writer == "jax" else _port_index()
    _logged_run(src, pts, snap, wal)
    if writer == "jax":
        got = ShardedHnswIndex.load(snap, wal=wal, device="cpu")
        ti, ji = got, src
    else:
        got = JaxSharded.load(snap, mesh=default_mesh(S), wal=wal)
        ti, ji = src, got
    assert got.n_nodes == 601 and got._wal is not None
    assert got.counters["n_inserted"] == 601
    _assert_same_state(ti, ji, min_same=0.95)
    # a loaded index is sized by its rows, the writer's by its growth
    assert ({**ti.vacuum(), "capacity": 0} == {**ji.vacuum(), "capacity": 0})
    # labels 500..529 exist twice (the second add's defaults start at
    # n_inserted = 400), and a delete takes every row that bears one
    assert ti.vacuum()["num_dead"] == 40 + 30 + 10
    _assert_same_answers(ti, ji, qs)
    # the recovered index keeps journaling: one more write, one more
    # recovery, from the same snapshot
    got.add(pts[601:640])
    again = ShardedHnswIndex.load(snap, wal=wal, device="cpu")
    assert again.n_nodes == 640


def test_wal_replay_start_follows_the_snapshot(data, tmp_path):
    """save() truncates the log to a new epoch and records both positions:
    a load replays only what the snapshot does not hold."""
    pts, _ = data
    snap, wal = str(tmp_path / "s.npz"), str(tmp_path / "w.wal")
    ti = _port_index()
    _logged_run(ti, pts, snap, wal)
    size = os.path.getsize(wal)
    ti.save(snap)                                   # covers everything
    assert os.path.getsize(wal) < size and ti._wal.epoch == 2
    ti.add(pts[601:650])
    back = ShardedHnswIndex.load(snap, wal=wal, device="cpu")
    assert back.n_nodes == 650
    np.testing.assert_array_equal(back._labels[:, :160], ti._labels[:, :160])
    old = str(tmp_path / "old.npz")
    ti.save(old, truncate_wal=False)
    ti.save(snap)
    with pytest.raises(ValueError, match="LATER snapshot"):
        ShardedHnswIndex.load(old, wal=wal, device="cpu")


def test_auto_checkpoint_truncates(data, tmp_path):
    pts, qs = data
    wal = str(tmp_path / "w.wal")
    ckpt = wal + ".ckpt.npz"
    ti = _port_index()
    ti.enable_wal(wal, auto_checkpoint_bytes=20_000)
    ti.add(pts[:100])                               # 100 * 16 * 4 < 20 kB
    assert not os.path.exists(ckpt) and os.path.getsize(wal) > 6_000
    ti.add(pts[100:400])                            # crosses the threshold
    assert os.path.exists(ckpt)
    assert os.path.getsize(wal) < 1_000 and ti._wal.epoch == 1
    ti.delete([3, 4])
    back = ShardedHnswIndex.load(ckpt, wal=wal, device="cpu")
    assert back.n_nodes == 400 and back.vacuum()["num_dead"] == 2
    _assert_same(back.search(qs, K, mode="graph"),
                 ti.search(qs, K, mode="graph"))
    # the JAX package recovers from the same pair
    ji = JaxSharded.load(ckpt, mesh=default_mesh(S), wal=wal)
    assert ji.n_nodes == 400 and ji.vacuum()["num_dead"] == 2


# ---------------------------------------------------------------------- #
# scan cursors
# ---------------------------------------------------------------------- #

def _pages(scan, sizes):
    return [scan.next(n) for n in sizes]


def _assert_same_pages(got, want):
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)


def test_scan_pages_match_jax(jidx, data):
    _, qs = data
    ti = _carry(jidx)
    sizes = [5, 5, 40, 120, 300]       # past S * ef = 64: the scans widen
    for q in qs[:3]:
        before = (ti.counters["n_widenings"], jidx.counters["n_widenings"])
        ts, js = ti.open_scan(q), jidx.open_scan(q)
        assert isinstance(ts, ShardedScan)
        got, want = _pages(ts, sizes), _pages(js, sizes)
        _assert_same_pages(got, want)
        labels = np.concatenate([l for _, l in got])
        # every row once; the scans end together, before the last page
        # is full (a shard whose beam holds a tombstone is not "full")
        assert len(set(labels.tolist())) == len(labels) > 64
        assert ts.exhausted == js.exhausted
        assert not np.isin(labels, DEAD + 10_000).any()
        assert (ti.counters["n_widenings"] - before[0] ==
                jidx.counters["n_widenings"] - before[1] > 0)
    # the first page is the one-shot search's answer
    _, l, v = ti.search(qs[:1], 5, mode="graph")
    np.testing.assert_array_equal(ti.open_scan(qs[0]).next(5)[1], l[0][v[0]])
    with pytest.raises(ValueError, match="exactly one query"):
        ti.open_scan(qs[:2])
    with pytest.raises(ValueError, match="n >= 1"):
        ti.open_scan(qs[0]).next(0)


def test_scan_exhaustion_matches_jax(data):
    """A scan ends when no shard fills its beam, or at max_widen_ef —
    which it reports as exhaustion, like the JAX scan."""
    pts, qs = data
    ji = _jax_index()
    ji.build(pts[:300])
    ti = _carry(ji)
    ts, js = ti.open_scan(qs[0]), ji.open_scan(qs[0])
    (gd, gl), (wd, wl) = ts.next(1000), js.next(1000)
    np.testing.assert_array_equal(gl, wl)
    assert ts.exhausted and js.exhausted and len(gl) <= 300
    assert len(ts.next(5)[1]) == 0
    for idx in (ji, ti):
        idx.max_widen_ef = 32
    ts, js = ti.open_scan(qs[1]), ji.open_scan(qs[1])
    (gd, gl), (wd, wl) = ts.next(1000), js.next(1000)
    np.testing.assert_array_equal(gl, wl)
    assert ts.exhausted and len(gl) <= 32 * S


def test_scan_sees_concurrent_deletes_and_snapshots_where(data):
    pts, qs = data
    ji = _jax_index(initial_capacity=32)
    ji.build(pts[:800])
    ti = _carry(ji)
    cap_at_open = ti.capacity_per_shard
    q = qs[2]
    _, ol, ov = ti.exact_search(q, 200)
    victims = ol[0][ov[0]][150:160]
    allowed = np.arange(0, 800, 2, dtype=np.uint64)
    scans = [(ti.open_scan(q), ji.open_scan(q)),
             (ti.open_scan(q, where=allowed), ji.open_scan(q, where=allowed))]
    first = [(a.next(3), b.next(3)) for a, b in scans]
    for got, want in first:
        _assert_same_pages([got], [want])
    for idx in (ji, ti):
        assert idx.delete(victims) == 10
        # rows added after open, all with even labels; the capacity grows
        idx.add(pts[800:1500], np.arange(700) * 2 + 5000)
    assert ti.capacity_per_shard == ji.capacity_per_shard > cap_at_open
    for (ts, js), width in zip(scans, (1, 2)):
        got, want = _pages(ts, [50] * 8), _pages(js, [50] * 8)
        _assert_same_pages(got, want)
        labels = np.concatenate([l for _, l in got])
        # tombstones are re-read at every fetch: a victim not yet buffered
        # at the delete never surfaces
        assert not np.isin(labels[130:], victims).any()
        if width == 2:
            # the filter is a snapshot of the rows present at open: no odd
            # label among them surfaces (as in the JAX scan, rows added
            # later are excluded only in capacity added after open)
            assert (labels % 2 == 0).all()
