"""The port's exact k-NN (ops/bruteforce.exact_search and the fused entry
ops/cuda_bruteforce.fused_exact_search, on the CPU through the kernel's
plain twin) against the JAX package's exact_search and its Pallas kernel in
interpret mode (tile_n=128, as tests/test_pallas_bruteforce.py runs it).

Ids must be equal; distances agree to rtol 1e-5 / atol 1e-5 (float32 sums
in another order)."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops.bruteforce import exact_search as jax_exact
from pg_embedding_tpu.ops.pallas_bruteforce import pallas_exact_search
from pg_embedding_tpu_torch.ops import cuda_bruteforce
from pg_embedding_tpu_torch.ops.bruteforce import exact_search
from pg_embedding_tpu_torch.ops.cuda_bruteforce import (
    _bruteforce_topk_plain, bruteforce_topk, fused_exact_search)

L2, COSINE, MANHATTAN = 0, 1, 2

CASES = [
    # (metric, n, d, k, n_valid, n_deleted)
    (L2, 500, 24, 10, None, 0),
    (COSINE, 500, 24, 10, None, 0),
    (L2, 500, 24, 10, 300, 40),
    (COSINE, 500, 24, 7, 200, 40),
    (L2, 400, 100, 10, None, 25),
    (COSINE, 300, 300, 5, None, 0),
    (L2, 6, 16, 10, None, 0),          # k > n
    (L2, 50, 16, 20, 12, 3),           # k > n_valid
    (MANHATTAN, 400, 100, 7, 350, 30),  # routed to ops.bruteforce
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, d, n_valid, n_deleted, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(9, d)).astype(np.float32)
    deleted = np.zeros(n, bool)
    deleted[rng.choice(n, n_deleted, replace=False)] = True
    return pts, qs, (deleted if n_deleted else None)


@pytest.mark.parametrize("metric,n,d,k,n_valid,n_deleted", CASES)
def test_matches_jax(metric, n, d, k, n_valid, n_deleted):
    pts, qs, deleted = _inputs(n, d, n_valid, n_deleted)
    jd, ji = jax_exact(qs, pts, k, metric, n_valid=n_valid, deleted=deleted)
    pd, pi = pallas_exact_search(qs, pts, k, metric, n_valid=n_valid,
                                 deleted=deleted, tile_n=128)
    ji, pi = np.asarray(ji), np.asarray(pi)
    np.testing.assert_array_equal(ji, pi)
    for fn in (exact_search, fused_exact_search):
        td, ti = fn(qs, pts, k, metric, n_valid=n_valid, deleted=deleted)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)
    if deleted is not None:
        assert not np.isin(ti.numpy()[ti.numpy() >= 0],
                           np.nonzero(deleted)[0]).any()
    if n_valid is not None:
        assert ti.numpy().max() < n_valid
    valid_rows = (n if n_valid is None else n_valid) - (
        0 if deleted is None else int(deleted[:n_valid].sum()))
    if k > valid_rows:
        assert (ti.numpy()[:, valid_rows:] == -1).all()
        assert np.isinf(td.numpy()[:, valid_rows:]).all()


@pytest.mark.parametrize("metric", [L2, COSINE])
def test_ties_keep_lower_id(metric):
    """Duplicate rows score equal.  The port orders them by id, as the JAX
    package's exact_search does; the Pallas kernel returns the same rows
    but inserts an equal score before the incumbents of its list, so it
    orders exact ties by descending id."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(40, 16)).astype(np.float32)
    pts = np.concatenate([base, base, base])          # ids i, i+40, i+80
    qs = rng.normal(size=(5, 16)).astype(np.float32)
    _, ji = jax_exact(qs, pts, 9, metric)
    _, pi = pallas_exact_search(qs, pts, 9, metric, tile_n=128)
    _, ti = bruteforce_topk(torch.from_numpy(qs), torch.from_numpy(pts), 9,
                            metric, len(pts))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.sort(ti.numpy()), np.sort(np.asarray(pi)))
    groups = ti.numpy().reshape(5, 3, 3)
    assert (np.diff(groups, axis=2) == 40).all()


def test_all_masked():
    pts = np.ones((64, 8), np.float32)
    d, i = fused_exact_search(np.ones((3, 8), np.float32), pts, 4,
                              deleted=np.ones(64, bool))
    assert (i.numpy() == -1).all() and np.isinf(d.numpy()).all()


def test_wrapper_is_the_plain_twin_on_cpu():
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.normal(size=(300, 20)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(6, 20)).astype(np.float32))
    dead = torch.zeros(300, dtype=torch.bool)
    dead[::7] = True
    before = dict(cuda_bruteforce.LAUNCHES)
    for corpus in (pts, pts.to(torch.bfloat16)):
        got = bruteforce_topk(qs, corpus, 12, L2, 250, dead)
        want = _bruteforce_topk_plain(qs, corpus, 12, L2, 250, dead)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_bruteforce.LAUNCHES == before      # no kernel on the CPU


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pts = torch.zeros((100, 8))
    qs = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="k_run"):
        bruteforce_topk(qs, pts, cuda_bruteforce.MAX_K_RUN + 1, L2, 100)
    with pytest.raises(ValueError, match="float32"):
        bruteforce_topk(qs, pts.double(), 5, L2, 100)
    with pytest.raises(ValueError, match="contiguous"):
        bruteforce_topk(qs, torch.zeros((8, 100)).T, 5, L2, 100)
    with pytest.raises(ValueError, match="L2 or cosine"):
        bruteforce_topk(qs, pts, 5, MANHATTAN, 100)
    with pytest.raises(ValueError, match="deleted"):
        bruteforce_topk(qs, pts, 5, L2, 100, torch.zeros(99, dtype=torch.bool))
