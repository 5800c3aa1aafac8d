"""VectorTable in the port against the JAX package's, on the CPU: the
replays of the reference regression scripts (test/sql/knn.sql, gh-2.sql,
gh-3.sql), the seq scan, the errors and the pull scan of
tests/test_table.py, each run through both tables.

Tolerances: the same (row, distance) lists, rows equal and distances to
rtol 1e-5."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu.table import VectorTable as JaxTable
from pg_embedding_tpu_torch import VectorTable


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dims):
    return JaxTable(dims=dims), VectorTable(dims=dims, device="cpu")


def _same(a, b):
    assert [r for r, _ in b] == [r for r, _ in a]
    np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                               rtol=1e-5, atol=1e-6)


def test_default_device_is_cuda():
    t = VectorTable(dims=3)
    assert t.device == torch.device("cuda")


def test_knn_sql_replay():
    """test/sql/knn.sql line by line, through both tables."""
    jt, tt = _pair(3)
    for t in (jt, tt):
        ids = t.insert([[0, 1, 2], [1, 2, 3], [1, 1, 1], None])
        t.create_index("<->", m=3)
        t.insert([[1, 2, 4]])
    q = [3, 3, 3]
    res = tt.order_by(q, "<->", limit=4)
    assert [r for r, _ in res] == [1, 4, 2, 0]
    _same(jt.order_by(q, "<->", limit=4), res)
    assert tt.count() == jt.count() == 5
    for t in (jt, tt):
        t.create_index("<=>", m=3)
        t.create_index("<~>", m=3)
    for op in ("<->", "<=>", "<~>"):
        res_idx = tt.order_by(q, op, limit=4)
        res_seq = tt.order_by(q, op, limit=4, use_index=False)
        _same(jt.order_by(q, op, limit=4), res_idx)
        _same(jt.order_by(q, op, limit=4, use_index=False), res_seq)
        assert [d for _, d in res_idx] == pytest.approx(
            [d for _, d in res_seq], rel=1e-5, abs=1e-6)
        assert {r for r, _ in res_idx} == {r for r, _ in res_seq}
    for t in (jt, tt):
        assert t.delete(ids + [4]) == 5         # the NULL row too
        assert t.count() == 0
        assert t.order_by(q, "<->", limit=4) == []
    assert tt.vacuum() == jt.vacuum()
    new_ids = tt.insert([[0, 1, 2], [1, 2, 3], [1, 1, 1], None, [1, 2, 4]])
    jt.insert([[0, 1, 2], [1, 2, 3], [1, 1, 1], None, [1, 2, 4]])
    res2 = tt.order_by(q, "<->", limit=4)
    assert [r for r, _ in res2] == [new_ids[1], new_ids[4], new_ids[2],
                                    new_ids[0]]
    _same(jt.order_by(q, "<->", limit=4), res2)


def test_gh2_empty_index():
    jt, tt = _pair(3)
    for t in (jt, tt):
        t.create_index("<->", m=3)
        assert t.order_by([3, 3, 3], "<->", limit=5) == []


def test_gh3_truncate():
    jt, tt = _pair(3)
    for t in (jt, tt):
        t.create_index("<->", m=3)
        t.insert([[0, 1, 2], [1, 2, 3], [1, 1, 1]])
        t.truncate()
        assert t.count() == 0
        ids = t.insert([[4, 5, 6], [1, 2, 3], [7, 8, 9]])
    res = tt.order_by([3, 3, 3], "<->", limit=3)
    assert [r for r, _ in res] == [ids[1], ids[0], ids[2]]
    _same(jt.order_by([3, 3, 3], "<->", limit=3), res)
    assert tt._indexes[next(iter(tt._indexes))].device.type == "cpu"


@pytest.mark.parametrize("metric", ["<->", "<=>", "<~>"])
def test_seqscan_without_index(rng, metric):
    pts = rng.normal(size=(50, 8)).astype(np.float32)
    jt, tt = _pair(8)
    for t in (jt, tt):
        t.insert(list(pts))
        t.delete([3, 11])
    res = tt.order_by(pts[7], metric, limit=5)     # no index: seq scan
    assert res[0][0] == 7 and res[0][1] == pytest.approx(0.0, abs=1e-5)
    _same(jt.order_by(pts[7], metric, limit=5), res)
    assert len(tt.order_by(pts[7], metric, limit=80)) == 48


def test_dims_and_duplicate_index_errors():
    for t in _pair(3):
        with pytest.raises(ValueError, match="wrong number of dimensions"):
            t.insert([[1, 2]])
        t.create_index("<->", m=3)
        with pytest.raises(ValueError, match="already exists"):
            t.create_index("ann_l2_ops", m=3)
        with pytest.raises(ValueError, match="wrong number of dimensions"):
            t.order_by([1, 2], "<->", limit=1)
        t.drop_index("<->")
        assert t.order_by([1, 2, 3], "<->", limit=1) == []
        t.insert([[1, 2, 3]])
        t.delete([0])
        with pytest.raises(KeyError):
            t[0]


def test_pull_scan_cursor(rng):
    """t.scan(q) streams every live row exactly once in pulled order,
    widening past ef, in the JAX table's order."""
    pts = rng.normal(size=(120, 8)).astype(np.float32)
    jt, tt = _pair(8)
    for t in (jt, tt):
        ids = t.insert(list(pts))
        t.create_index("<->", m=6, ef_construction=24, ef_search=8)
    got = list(tt.scan(pts[3], "<->", batch=7))
    _same(list(jt.scan(pts[3], "<->", batch=7)), got)
    rows = [r for r, _ in got]
    assert rows[0] == ids[3]
    assert len(rows) == len(set(rows)) == 120
    for t in (jt, tt):
        t.delete(rows[:10])
    rows2 = list(tt.scan(pts[3], "<->"))
    _same(list(jt.scan(pts[3], "<->")), rows2)
    assert not {r for r, _ in rows2} & set(rows[:10])
    with pytest.raises(ValueError, match="no hnsw index"):
        next(tt.scan(pts[3], "<=>"))
    with pytest.raises(ValueError, match="wrong number of dimensions"):
        next(tt.scan(pts[3][:4], "<->"))
