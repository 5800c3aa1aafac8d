"""The exact route's rerank pad against cancellation: data whose L2
matmul-form scores cannot order the k-th to (k+3)-th neighbours.

Rows and queries sit at a large common offset, so |p|^2 + |q|^2 - 2 q.p
cancels in float32 (an absolute error of ~1e-2 on the squared distance at
OFFSET 30, D 32).  Each query owns K - 1 rows close to it and a band of
four rows at distance ~1 whose squared distances differ by ~4e-5, far
inside that error: by matmul score the band's order is noise, so the true
K-th can land at rank K + 3, one past the pad of 2.  Shared by
tests/test_torch_rerank_pad.py (the CPU, both packages) and
tests/test_torch_cuda.py (the card); imports numpy only."""

import numpy as np

K, BAND, OFFSET = 10, 4, 30.0


def band_case(seed=0, b=64, n=2000, d=32):
    """(rows f32[n, d], queries f32[b, d]): query j's rows K - 1 near
    ones at radii 0.03 .. 0.27 from it and a band of BAND at radii 1 +
    2e-5 i, starting at row 30 j; the rest of the rows scattered (sd 3)
    about the offset."""
    rng = np.random.default_rng(seed)
    qs = OFFSET + rng.normal(size=(b, d))
    pts = OFFSET + 3 * rng.normal(size=(n, d))
    for j in range(b):
        radii = [0.3 * (i + 1) / K for i in range(K - 1)]
        radii += [1.0 + 2e-5 * i for i in range(BAND)]
        for i, r in enumerate(radii):
            v = rng.normal(size=d)
            pts[30 * j + i] = qs[j] + r * v / np.linalg.norm(v)
    return pts.astype(np.float32), qs.astype(np.float32)


def oracle(pts, qs, k=K):
    """The float64 Euclidean distances f64[b, n] and each query's k
    nearest ids (ties by the lower id)."""
    d64 = np.sqrt(((pts[None].astype(np.float64)
                    - qs[:, None].astype(np.float64)) ** 2).sum(-1))
    return d64, np.argsort(d64, axis=1, kind="stable")[:, :k]


def pool_rerank(d64, pool_ids, k=K):
    """The k of each query's ``pool_ids`` nearest by float64 distance: what
    an exact rerank of that pool returns (sets: the band's distances are
    ~2e-5 relative apart, which float32's difference form resolves)."""
    d = np.take_along_axis(d64, pool_ids, axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(pool_ids, order, axis=1)


def lost_rows(ids, want):
    """Per query, the oracle's ids missing from ``ids``."""
    return [set(w) - set(g) for g, w in zip(ids, want)]
