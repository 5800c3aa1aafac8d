"""The write-ahead log, on the CPU: the port writes the JAX package's WAL
byte for byte, a log written by either package replays in the other, and
the epoch lifecycle (truncation on save, a crash on either side of it, a
stale snapshot) behaves as tests/test_wal_lifecycle.py pins for JAX.

Tolerances: none — recovered indexes must equal the index that took the
writes in node count, tombstones, labels and the ids of both routes."""

import os

import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu_torch import HnswConfig, HnswIndex
from pg_embedding_tpu_torch import wal as twal

D, K = 12, 5
CFG = dict(dims=D, m=6, ef_construction=24, ef_search=24)


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
    rng = np.random.default_rng(31)
    return (rng.normal(size=(220, D)).astype(np.float32),
            rng.normal(size=(8, D)).astype(np.float32))


def _torch():
    return HnswIndex(HnswConfig(**CFG), device="cpu")


def _jax():
    return JaxIndex(JaxConfig(**CFG))


def _state(idx, qs):
    return (idx.n_nodes, idx.counters["n_deleted"], idx.labels.tolist(),
            idx.search(qs, K, mode="graph")[1].tolist(),
            idx.search(qs, K, mode="exact")[1].tolist())


def _writes(idx, pts):
    idx.build(pts[:120], np.arange(120))
    idx.delete(np.arange(0, 120, 9))
    idx.add(pts[120:150], np.arange(120, 150))
    idx.delete_where(np.arange(150) == 140)


def test_same_bytes(data, tmp_path):
    """The same writes give byte-identical logs in both packages."""
    pts, _ = data
    for make, name in ((_torch, "t"), (_jax, "j")):
        idx = make()
        idx.enable_wal(str(tmp_path / f"{name}.wal"))
        _writes(idx, pts)
    assert ((tmp_path / "t.wal").read_bytes() ==
            (tmp_path / "j.wal").read_bytes())
    recs = list(twal.replay(str(tmp_path / "t.wal"), D))
    assert [op for op, _, _ in recs] == [twal.OP_INSERT, twal.OP_DELETE,
                                         twal.OP_INSERT, twal.OP_DELETE]
    assert recs[-1][1].tolist() == [140]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_crash_recovery_across(data, tmp_path, writer, reader):
    """snapshot -> add + delete -> crash -> load(snapshot, wal=...)"""
    pts, qs = data
    snap, log = str(tmp_path / "s.npz"), str(tmp_path / "w.wal")
    live = _torch() if writer == "torch" else _jax()
    live.enable_wal(log)
    live.build(pts[:100], np.arange(100))
    live.save(snap)
    live.add(pts[100:160], np.arange(100, 160))
    live.delete(np.arange(5, 130, 7))
    want = _state(live, qs)
    del live                                     # no save: a crash
    if reader == "torch":
        back = HnswIndex.load(snap, wal=log, device="cpu")
    else:
        back = JaxIndex.load(snap, wal=log)
    assert _state(back, qs) == want
    # the recovered index keeps journaling
    back.add(pts[160:170], np.arange(160, 170))
    del back
    again = HnswIndex.load(snap, wal=log, device="cpu")
    assert again.n_nodes == 170


def test_crash_between_snapshot_and_truncation(data, tmp_path, monkeypatch):
    """The snapshot is durable but the truncation never ran: the WAL is
    still at the old epoch, so load replays from the OLD offset — no
    duplicates, no loss (tests/test_wal_lifecycle.py:68 for the port)."""
    pts, qs = data
    snap, log = str(tmp_path / "s.npz"), str(tmp_path / "w.wal")
    idx = _torch()
    idx.enable_wal(log)
    idx.build(pts[:100], np.arange(100))
    monkeypatch.setattr(twal.WalWriter, "truncate", lambda self, e: None)
    idx.save(snap)
    assert twal.read_header(log)["epoch"] == 0       # truncation lost
    idx.add(pts[100:120], np.arange(100, 120))
    want = _state(idx, qs)
    del idx
    monkeypatch.undo()
    back = HnswIndex.load(snap, wal=log, device="cpu")
    assert back.n_nodes == 120                        # tail replayed once
    assert _state(back, qs) == want
    assert _state(JaxIndex.load(snap, wal=log), qs) == want


def test_truncation_epochs_and_stale_snapshot(data, tmp_path):
    pts, qs = data
    old, new = str(tmp_path / "old.npz"), str(tmp_path / "new.npz")
    log = str(tmp_path / "w.wal")
    idx = _torch()
    idx.enable_wal(log)
    idx.add(pts[:50], np.arange(50))
    size = os.path.getsize(log)
    idx.save(old)                                     # epoch 0 -> 1
    assert os.path.getsize(log) < size
    assert twal.read_header(log)["epoch"] == 1
    idx.add(pts[50:80], np.arange(50, 80))
    idx.save(new)                                     # epoch 1 -> 2
    with pytest.raises(ValueError, match="LATER snapshot"):
        HnswIndex.load(old, wal=log, device="cpu")
    assert HnswIndex.load(new, wal=log, device="cpu").n_nodes == 80
    idx.save(new, truncate_wal=False)                 # log kept as is
    assert twal.read_header(log)["epoch"] == 2


def test_auto_checkpoint(data, tmp_path):
    pts, qs = data
    log = str(tmp_path / "w.wal")
    idx = _torch()
    idx.enable_wal(log, auto_checkpoint_bytes=4096)
    for off in range(0, 200, 40):
        idx.add(pts[off:off + 40], np.arange(off, off + 40))
        # each add's record passes the threshold, so it is checkpointed
        assert os.path.getsize(log) < 4096
    idx.delete(np.arange(3, 200, 11))
    want = _state(idx, qs)
    del idx
    back = HnswIndex.load(log + ".ckpt.npz", wal=log, device="cpu")
    assert _state(back, qs) == want


def test_frozen_options_guard(tmp_path):
    log = str(tmp_path / "w.wal")
    _torch().enable_wal(log)
    other = HnswIndex(HnswConfig(**dict(CFG, m=8)), device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        other.enable_wal(log)
