"""The port's utilities against the JAX package's, on the CPU:
utils/io.py (vector files and the synthetic corpora, a numpy-only copy) and
utils/profiling.py (Timer, SearchStatsAgg, sync, trace over torch).

Tolerances: none; files, arrays and summaries are equal."""

import json
import time

import numpy as np
import pytest
import torch

from pg_embedding_tpu.core.search import SearchStats as JaxStats
from pg_embedding_tpu.utils import io as jio
from pg_embedding_tpu.utils import profiling as jprof
from pg_embedding_tpu_torch import HnswConfig, HnswIndex
from pg_embedding_tpu_torch.core.search import SearchStats
from pg_embedding_tpu_torch.utils import io as tio
from pg_embedding_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("ext,dtype", [(".fvecs", np.float32),
                                       (".ivecs", np.int32),
                                       (".bvecs", np.uint8)])
def test_vecs_files_match_jax(tmp_path, rng, ext, dtype):
    data = (rng.normal(size=(37, 12)) * 100).astype(dtype)
    mine, theirs = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tio.write_vecs(mine, data)
    jio.write_vecs(theirs, data)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(tio.read_vecs(theirs), data)
    np.testing.assert_array_equal(tio.read_vecs(mine, count=5, offset=30),
                                  jio.read_vecs(mine, count=5, offset=30))


def test_vecs_errors(tmp_path):
    bad = str(tmp_path / "bad.fvecs")
    with open(bad, "wb") as f:
        f.write(np.array([3], np.int32).tobytes())
        f.write(np.zeros(2, np.float32).tobytes())   # truncated record
    with pytest.raises(ValueError, match="not a multiple"):
        tio.read_vecs(bad)
    with pytest.raises(ValueError, match="unknown vector-file extension"):
        tio.write_vecs(str(tmp_path / "x.npy"), np.zeros((2, 2)))
    empty = str(tmp_path / "e.ivecs")
    open(empty, "wb").close()
    assert tio.read_vecs(empty).shape == (0, 0)


@pytest.mark.parametrize("name,kwargs", [
    ("synthetic_clustered", dict(n_centers=10, seed=3, n_queries=5)),
    ("synthetic_clustered", dict(n_centers=10, seed=4)),
    ("synthetic_correlated", dict(rank=4, n_centers=10, seed=1,
                                  n_queries=7)),
    ("synthetic_powerlaw", dict(n_centers=20, seed=2, n_queries=3)),
    ("synthetic_duplicates", dict(n_centers=10, seed=5, n_queries=4)),
])
def test_synthetic_matches_jax(name, kwargs):
    got = getattr(tio, name)(300, 16, **kwargs)
    want = getattr(jio, name)(300, 16, **kwargs)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_timer_phases():
    t = tprof.Timer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a", sync_tree={"x": torch.zeros(3)}):
        pass
    with t.phase("b"):
        pass
    assert t.counts == {"a": 2, "b": 1}
    assert t.seconds["a"] >= 0.01
    assert "a:" in t.report() and "b:" in t.report()


def test_stats_agg_matches_jax(rng):
    """The same walk counters give the JAX aggregator's summary, whether
    they come as tensors (the port's SearchStats) or arrays."""
    pts = rng.normal(size=(300, 8)).astype(np.float32)
    idx = HnswIndex(HnswConfig(dims=8, m=4, ef_construction=16,
                               ef_search=16), device="cpu")
    idx.build(pts)
    mine, theirs = tprof.SearchStatsAgg(), jprof.SearchStatsAgg()
    for lo in (0, 5, 13):
        qs = torch.from_numpy(pts[lo:lo + 6] + 0.1)
        _, _, st = idx._graph_search(qs, 16)
        assert isinstance(st, SearchStats)
        mine.add(st)
        theirs.add(JaxStats(hops=st.hops.numpy(),
                            dist_evals=st.dist_evals.numpy()))
    mine.add(JaxStats(hops=np.array([7]), dist_evals=np.array([30])))
    theirs.add(JaxStats(hops=np.array([7]), dist_evals=np.array([30])))
    assert mine.summary() == theirs.summary()
    assert mine.summary()["queries"] == 19


def test_sync_on_host_is_a_no_op():
    tprof.sync({"x": torch.arange(4), "y": [torch.zeros(2), (1, "a")]})
    tprof.sync([])
    tprof.sync(None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
