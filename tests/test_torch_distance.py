"""pg_embedding_tpu_torch.ops.distance against the JAX package's ops.distance.

Same numpy inputs through both; float32 sums in another order, so values
agree to rtol 1e-5 (atol 1e-5 for the cancellation-prone matmul forms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops import distance as jd
from pg_embedding_tpu_torch.ops import distance as td

# metrics by enum value: the packages' Metric enums are distinct classes
METRICS = [0, 1, 2]


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
    rng = np.random.default_rng(5)
    return (rng.normal(size=(7, 24)).astype(np.float32),
            rng.normal(size=(40, 24)).astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_dist_one_to_many(data, metric):
    qs, pts = data
    want = np.stack([np.asarray(jd.dist_one_to_many(jnp.asarray(q),
                                                    jnp.asarray(pts), metric))
                     for q in qs])
    # batched form: [B, D] queries against [B, K, D] gathered sets
    got = td.dist_one_to_many(torch.from_numpy(qs),
                              torch.from_numpy(pts).expand(len(qs), -1, -1),
                              metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_dist(data, metric):
    qs, pts = data
    want = np.asarray(jd.pairwise_dist(jnp.asarray(qs), jnp.asarray(pts),
                                       metric))
    got = td.pairwise_dist(torch.from_numpy(qs), torch.from_numpy(pts),
                           metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # leading batch dims (the prune heuristic's [B, C, C] form).  Its
    # diagonal is a cancellation residual of |p|^2+|p|^2-2p.p, so L2 is
    # held on squares, to 1e-5 of the squared-norm scale (|p|^2 ~ 24)
    got3 = td.pairwise_dist(torch.from_numpy(pts).view(2, 20, 24),
                            torch.from_numpy(pts).view(2, 20, 24),
                            metric).numpy()
    for j in range(2):
        blk = pts[20 * j: 20 * (j + 1)]
        want3 = np.asarray(jd.pairwise_dist(jnp.asarray(blk),
                                            jnp.asarray(blk), metric))
        if metric == 0:
            got3[j], want3 = got3[j] ** 2, want3 ** 2
        np.testing.assert_allclose(got3[j], want3, rtol=1e-5, atol=5e-4)


@pytest.mark.parametrize("name", ["l2_distance", "cosine_distance",
                                  "manhattan_distance"])
def test_operators(name):
    a = [1.0, 2.0, 3.0]
    b = [2.0, 0.5, -1.0]
    want = float(getattr(jd, name)(a, b))
    got = float(getattr(td, name)(a, b))
    assert got == pytest.approx(want, rel=1e-5)
    with pytest.raises(ValueError, match="different array dimensions"):
        getattr(td, name)([1.0, 2.0], [1.0, 2.0, 3.0])
