"""The port's exact k-NN (ops/bruteforce.exact_search and the fused entry
ops/cuda_bruteforce.fused_exact_search, on the CPU through the kernel's
plain twin) against the JAX package's exact_search and its Pallas kernel in
interpret mode (tile_n=128, as tests/test_pallas_bruteforce.py runs it).

Ids must be equal; distances agree to rtol 1e-5 / atol 1e-5 (float32 sums
in another order)."""

import os
import re

import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops.bruteforce import exact_search as jax_exact
from pg_embedding_tpu.ops.pallas_bruteforce import pallas_exact_search
from pg_embedding_tpu_torch.ops import cuda_bruteforce
from pg_embedding_tpu_torch.ops.bruteforce import exact_search
from pg_embedding_tpu_torch.ops.cuda_bruteforce import (
    MAX_K_RUN, MAX_SPLITS, SMEM_LIMIT, _bruteforce_topk_plain, _launch_shape,
    bruteforce_topk, bruteforce_topk_paged, fused_exact_search)

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


@pytest.mark.parametrize("metric,dtype,k_run", [
    (L2, torch.float32, 1025), (COSINE, torch.float32, 2100),
    (L2, torch.bfloat16, 2049), (COSINE, torch.bfloat16, 1500)])
def test_pages_concatenate_to_one_list(metric, dtype, k_run, monkeypatch):
    """k_run past MAX_K_RUN goes in pages, each admitting only what follows
    the last entry of the page before: the pages equal the one long list
    of the plain twin, bit for bit, through runs of exact ties (every row
    three times) that straddle the page edges, tombstones and n_valid."""
    rng = np.random.default_rng(6)
    base = rng.normal(size=(1000, 16)).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([base] * 3)).to(dtype)
    qs = torch.from_numpy(rng.normal(size=(7, 16)).astype(np.float32))
    dead = torch.from_numpy(rng.random(3000) < 0.05)
    calls = []

    def counted(*args):
        calls.append(args[2])
        return bruteforce_topk(*args)
    monkeypatch.setattr(cuda_bruteforce, "bruteforce_topk", counted)
    got = bruteforce_topk_paged(qs, pts, k_run, metric, 2900, dead)
    want = _bruteforce_topk_plain(qs, pts, k_run, metric, 2900, dead)
    assert len(calls) == -(-k_run // MAX_K_RUN) and max(calls) <= MAX_K_RUN
    assert sum(calls) == k_run
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_page_floor_admits_only_what_follows():
    """``after`` keeps rows after (score, id) only, an equal score with a
    higher id included, and comes back holding the page's last entry as
    the next floor (the L2 score before its sqrt); a floor of (inf, -1),
    a page that ran out, admits nothing."""
    pts = torch.tensor([[0.0], [1.0], [1.0], [2.0], [3.0]])
    qs = torch.zeros((2, 1))
    after = (torch.tensor([1.0, float("inf")]), torch.tensor([1, -1],
                                                              dtype=torch.int32))
    d, i = bruteforce_topk(qs, pts, 2, L2, 5, after=after)
    assert i.tolist() == [[2, 3], [-1, -1]]
    assert d[0].tolist() == [1.0, 2.0] and torch.isinf(d[1]).all()
    assert after[0].tolist()[0] == 4.0 and after[1].tolist() == [3, -1]
    with pytest.raises(ValueError, match="after"):
        bruteforce_topk(qs, pts, 2, L2, 5, after=(after[0].double(),
                                                  after[1]))


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


@pytest.mark.parametrize("b", [1, 17, 300, 1024])
def test_launch_shape_fits_a_block(b):
    """Every k_run the wrapper takes gets a launch whose shared memory fits
    one Hopper block, a query tile that never grows with k_run, and splits
    the merge kernel takes, none under 2048 rows."""
    for itemsize, dims in ((4, 128), (2, 128), (4, 960), (2, 960), (4, 30)):
        last_qt = 64
        for k_run in range(1, MAX_K_RUN + 1):
            qt, splits, _, smem = _launch_shape(b, 1_000_000, k_run, 132,
                                                itemsize, dims)
            assert smem <= SMEM_LIMIT, (k_run, itemsize, dims, smem)
            assert qt in (64, 16) and qt <= last_qt
            assert 1 <= splits <= MAX_SPLITS
            last_qt = qt
    for n_rows in (0, 1, 2048, 5000):
        assert _launch_shape(b, n_rows, 12, 132)[1] == max(
            1, -(-n_rows // 2048))


def test_launch_shape_of_the_main_path():
    """1M rows, 128-d, B=1024, k_run=12: 16 query tiles of 64, each block
    holding its queries, x 33 splits; two blocks to an SM (under half its
    shared memory each) fill 132 SMs in two waves."""
    assert _launch_shape(1024, 1_000_000, 12, 132) == (64, 33, True, 112_384)
    assert _launch_shape(1024, 1_000_000, 12, 132, 2) == (64, 33, True,
                                                          96_000)
    # resident queries would leave one block to an SM: they stream instead
    assert _launch_shape(1024, 1_000_000, 19, 132)[2:] == (False, 100_608)
    assert _launch_shape(1024, 1_000_000, 48, 132)[3] * 2 <= 233_472 - 2048
    # or do not fit at all
    assert not _launch_shape(1024, 1_000_000, 12, 132, 4, 960)[2]
    assert _launch_shape(1024, 1_000_000, 257, 132)[:2] == (16, 33)
    # one query tile: as many splits as rows allow, up to the slots
    assert _launch_shape(17, 100_000, 12, 132)[1] == 49


def test_launch_shape_mirrors_the_kernel_source():
    """The Python figure is checked against the kernel's own on the card;
    here the constants it is built from are read out of the source."""
    src = open(os.path.join(os.path.dirname(cuda_bruteforce.__file__), "..",
                            "csrc", "bruteforce_topk.cu")).read()
    const = {m[0]: m[1] for m in re.findall(
        r"constexpr int (k\w+) = ([^;]+);", src)}
    tile_n, tile_d = int(const["kTileN"]), int(const["kTileD"])
    assert (tile_n, tile_d, int(const["kStages"])) == (
        cuda_bruteforce._TILE_N, cuda_bruteforce._TILE_D,
        cuda_bruteforce._STAGES)
    assert const["kQStride"] == "kTileD + 4" and (
        cuda_bruteforce._Q_STRIDE == tile_d + 4)
    assert const["kSStride"] == "kTileN + 8" and (
        cuda_bruteforce._SCORE_STRIDE == tile_n + 8)
    assert int(const["kSmemLimit"]) == SMEM_LIMIT
    assert int(const["kMaxSplits"]) == MAX_SPLITS
    assert int(const["kMaxK"]) == MAX_K_RUN
