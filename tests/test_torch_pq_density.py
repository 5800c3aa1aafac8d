"""How far the PQ walk falls behind the plain walk depends on the data, in
the JAX package as in the port: both walks over one graph and one codebook,
at 128-d and G=32 (4-dim cells), on bench.py's clustered recipe at two
densities.  With ~1,000 rows around each centre (bench.py's density: a
query's ten neighbours are ten of a thousand rows at nearly one distance)
the 4-dim cells cannot rank them inside ef=64, and both packages lose the
same recall, id for id; with ~20 rows a centre (benchmarks/bench_pq.py's)
the walk keeps within 0.03 of the plain walk's recall.

The graph is the port's (built on the CPU), saved and loaded by the JAX
package with its trained codebook; recall@10 is against a float64 oracle.
"""

import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu_torch import HnswConfig, HnswIndex, api
from pg_embedding_tpu_torch.utils.io import synthetic_clustered

N, D, K, G, T = 10_000, 128, 10, 32, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: test files running side by side do not
    oversubscribe the cores.  The count is restored for whatever runs
    next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recall(labels, valid, want):
    return float(np.mean([len(set(labels[i][valid[i]].tolist()) &
                              set(want[i].tolist())) / K
                          for i in range(len(labels))]))


@pytest.mark.parametrize("centres", [10, 500],
                         ids=["1000-rows-a-centre", "20-rows-a-centre"])
def test_pq_walk_recall_by_density(centres, tmp_path, monkeypatch):
    monkeypatch.setattr(api, "_PQ_TRAIN_ITERS", 4)
    pts, qs = synthetic_clustered(N, D, centres, seed=12345, n_queries=48)
    d2 = ((qs.astype(np.float64)[:, None, :] - pts[None]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1, kind="stable")[:, :K]
    ti = HnswIndex(HnswConfig(dims=D, m=16, ef_construction=64,
                              ef_search=64), device="cpu",
                   search_expand_width=T, pq_groups=G)
    ti.build(pts)
    plain = _recall(*ti.search(qs, K, mode="graph")[1:], oracle)
    ti.packed_traversal, ti.packed_dtype = True, "pq"
    _, tl, tv = ti.search(qs, K, mode="graph")        # trains and packs
    path = str(tmp_path / "pq.npz")
    ti.save(path)
    ji = JaxIndex.load(path)
    ji.packed_traversal, ji.packed_dtype = True, "pq"
    ji.search_expand_width = T
    _, jl, jv = ji.search(qs, K, mode="graph")
    np.testing.assert_array_equal(np.asarray(ji._pq_codebook),
                                  ti._pq_codebook.numpy())
    # the same walk in both packages: ids and order (a float32 near-tie may
    # turn one walk)
    assert (tl == jl).all(axis=1).mean() >= 0.95
    port, jax = _recall(tl, tv, oracle), _recall(jl, jv, oracle)
    print(f"\n{N // centres} rows a centre: recall@10 plain {plain:.4f}, "
          f"PQ G={G} port {port:.4f}, JAX {jax:.4f}; identical walks "
          f"{(tl == jl).all(axis=1).mean():.4f}")
    assert abs(port - jax) <= 0.01, (port, jax)
    if centres == 10:
        assert plain >= 0.95 and port <= plain - 0.1, (plain, port)
    else:
        assert port >= plain - 0.03, (plain, port)
