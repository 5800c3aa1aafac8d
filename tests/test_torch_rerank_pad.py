"""The exact route's rerank pad (_RERANK_PAD = 2) against cancellation, in
both packages, on the CPU.

L2's exact route fetches k + 2 rows by the matmul-form score and reranks
them by the difference form.  On tests/rerank_band.band_case (rows at a
large common offset; each query's K-th to (K + 3)-th neighbours within
the matmul score's error) a true K-th neighbour can fall to rank K + 3 by
matmul score, past the pad: the port's exact route and the JAX package's
exact_search both lose such rows against a float64 oracle.  That is the
reference's behaviour, and the port keeps it; each route is held to it
exactly: its answer is the exact rerank of its own k + 2 pool, every row it
loses is a band row outside that pool, and some query loses one.  (The
card's kernel: tests/test_torch_cuda.py::test_rerank_pad_on_the_card.)

Tolerances: returned distances against float64 at rtol 1e-5; the rerank's
choice compared as sets (the band's distances lie ~2e-5 relative apart,
which float32's difference form resolves)."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops import bruteforce as jbf
from pg_embedding_tpu_torch.ops import bruteforce as bf
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
from pg_embedding_tpu_torch.ops.distance import pairwise_dist
from rerank_band import BAND, K, band_case, lost_rows, oracle, pool_rerank

L2 = 0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_fused(pts, qs):
    """fused_exact_search on CPU tensors (the kernel's twin fetches k + 2
    by the kernel's score, then the rerank) and that pool."""
    p, q = torch.from_numpy(pts), torch.from_numpy(qs)
    d, i = cb.fused_exact_search(qs, p, K, "l2")
    pool = cb._bruteforce_topk_plain(q, p, K + 2, L2, len(pts))[1]
    return d.numpy(), i.numpy(), pool.numpy()


def _port_ops(pts, qs):
    """ops/bruteforce.exact_search (the port's oracle route: pairwise_dist
    chunks) and its k + 2 pool."""
    p, q = torch.from_numpy(pts), torch.from_numpy(qs)
    d, i = bf.exact_search(qs, p, K, "l2")
    pool = bf.sweep_min_k(q, p, K + 2, len(pts), None,
                          lambda a, b: pairwise_dist(a, b, L2), 15360)[1]
    return d.numpy(), i.numpy(), pool.numpy()


def _jax(pts, qs):
    """The JAX package's exact_search and its k + 2 pool
    (_exact_search_impl, the sweep before its rerank)."""
    import jax.numpy as jnp
    d, i = jbf.exact_search(qs, pts, K, "l2")
    _, pool = jbf._exact_search_impl(
        jnp.asarray(qs), jnp.asarray(pts), jnp.asarray(len(pts), jnp.int32),
        jnp.zeros(len(pts), jnp.bool_), k=K + 2, metric_value=L2,
        chunk=len(pts))
    return np.asarray(d), np.asarray(i), np.asarray(pool)


@pytest.mark.parametrize("route", [_port_fused, _port_ops, _jax],
                         ids=["port fused_exact_search",
                              "port ops.bruteforce.exact_search",
                              "jax exact_search"])
def test_pad_of_two_loses_band_rows(route):
    """Each route answers with the exact rerank of its own k + 2 pool:
    rows it returns are the oracle's at rtol 1e-5, every oracle row it
    loses is one of the query's band rows and outside that pool, and the
    pad does lose some (a K-th neighbour ranked K + 3 by matmul score)."""
    pts, qs = band_case()
    d64, want = oracle(pts, qs)
    d, ids, pool = route(pts, qs)
    got = np.take_along_axis(d64, ids.astype(np.int64), axis=1)
    np.testing.assert_allclose(d, got, rtol=1e-5)
    rerank = pool_rerank(d64, pool.astype(np.int64))
    for j, (g, r) in enumerate(zip(ids, rerank)):
        assert set(g) == set(r), j
    lost = lost_rows(ids, want)
    band = [set(range(30 * j + K - 1, 30 * j + K - 1 + BAND))
            for j in range(len(qs))]
    for j, rows in enumerate(lost):
        assert rows <= band[j] and not rows & set(pool[j]), j
    assert sum(map(len, lost)) > 0
