"""The port's graph walk (core/search.search_graph) against the JAX
package's, on one graph: built by the JAX HnswIndex and handed over with
convert.py, so the walk is compared independently of construction.

Both must return the same ids in the same order with equal hops and
distance-evaluation counts on >= 99% of queries, and every query that
differs must differ at a near-tie (two candidate distances within 1e-5
relative: float32 sums in another order may swap them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu.core.search import search_graph as jax_search
from pg_embedding_tpu_torch.convert import graph_from_numpy, to_numpy
from pg_embedding_tpu_torch.core.search import _merge_topk, search_graph

N, D = 2000, 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[0, 1], ids=["l2", "cosine"])
def built(request):
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=3.0, size=(40, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 40, N)] +
           rng.normal(size=(N, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 40, 96)] +
          rng.normal(size=(96, D))).astype(np.float32)
    idx = JaxIndex(JaxConfig(dims=D, m=6, ef_construction=32, ef_search=32,
                             metric=("l2", "cosine")[request.param]))
    idx.build(pts)
    g = idx.graph
    tg = graph_from_numpy(g.vectors, g.links, g.link_counts, g.deleted,
                          idx.n_nodes)
    return request.param, idx, tg, qs


def _near_tie(d_row, rtol=1e-5):
    d = np.sort(d_row[np.isfinite(d_row)])
    return bool(np.any(np.diff(d) <= rtol * np.abs(d[1:])))


@pytest.mark.parametrize("ef,width", [(32, 1), (32, 4), (64, 4)])
def test_same_walk_as_jax(built, ef, width):
    metric, idx, tg, qs = built
    jd, ji, js = jax_search(idx.graph, jnp.asarray(qs), ef=ef,
                            metric_value=metric, expand_width=width)
    td, ti, ts = search_graph(tg, torch.from_numpy(qs), ef=ef,
                              metric_value=metric, expand_width=width)
    same = ((np.asarray(ji) == ti.numpy()).all(axis=1) &
            (np.asarray(js.hops) == ts.hops.numpy()) &
            (np.asarray(js.dist_evals) == ts.dist_evals.numpy()))
    assert same.mean() >= 0.99, same.mean()
    for q in np.nonzero(~same)[0]:
        assert _near_tie(np.asarray(jd)[q]) or _near_tie(td.numpy()[q]), q
    rows = same
    np.testing.assert_allclose(td.numpy()[rows], np.asarray(jd)[rows],
                               rtol=1e-5, atol=1e-5)


def test_convert_round_trip(built):
    _, idx, tg, _ = built
    back = to_numpy(tg)
    for name in ("vectors", "links", "link_counts", "deleted"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(idx.graph, name)))
    assert back["n_nodes"] == idx.n_nodes


def test_merge_ties_keep_incumbents():
    """torch.topk promises no order among ties; the merge must keep the
    incumbents (set a) first, as lax.top_k does in the JAX package."""
    d_a = torch.tensor([[1.0, 2.0, 2.0, np.inf]])
    i_a = torch.tensor([[5, 6, 7, -1]], dtype=torch.int32)
    d_b = torch.tensor([[2.0, 0.5, np.inf]])
    i_b = torch.tensor([[1, 9, -1]], dtype=torch.int32)
    d, i = _merge_topk(d_a, i_a, d_b, i_b, 5)
    assert i.tolist() == [[9, 5, 6, 7, 1]]
    assert d.tolist() == [[0.5, 1.0, 2.0, 2.0, 2.0]]


def test_empty_graph():
    tg = graph_from_numpy(np.zeros((32, 4), np.float32),
                          np.full((32, 8), -1, np.int32),
                          np.zeros(32, np.int32), np.zeros(32, bool), 0)
    d, i, s = search_graph(tg, torch.ones((3, 4)), ef=8, metric_value=0)
    assert (i.numpy() == -1).all() and np.isinf(d.numpy()).all()
    assert (s.hops.numpy() == 0).all()
