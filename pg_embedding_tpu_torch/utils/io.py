"""Dataset IO: .fvecs / .ivecs / .bvecs readers and writers, and the
synthetic corpora — a numpy-only copy of pg_embedding_tpu/utils/io.py (the
JAX package's __init__ imports jax, so the port keeps its own copy).

The standard TexMex/BIGANN formats used by the BASELINE.md datasets
(SIFT1M, GIST1M, Deep*): each vector is stored as a little-endian int32
dimension count followed by `dim` elements (float32 / int32 / uint8).
Memory-maps for large files; supports bounded reads for streaming builds.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_DTYPES = {".fvecs": np.float32, ".ivecs": np.int32, ".bvecs": np.uint8}


def _vec_format(path: str):
    ext = os.path.splitext(path)[1]
    if ext not in _DTYPES:
        raise ValueError(f"unknown vector-file extension: {path}")
    return _DTYPES[ext]


def read_vecs(path: str, count: Optional[int] = None,
              offset: int = 0) -> np.ndarray:
    """Read vectors from an .fvecs/.ivecs/.bvecs file.

    Args:
      path:   file path (extension selects the element type).
      count:  max vectors to read (default: all).
      offset: vectors to skip from the start.

    Returns an [n, dim] array of the file's element type.
    """
    dtype = _vec_format(path)
    elem = np.dtype(dtype).itemsize
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype=np.int32, count=1)
        if head.size == 0:
            return np.zeros((0, 0), dtype)
        dim = int(head[0])
        if dim <= 0 or dim > (1 << 20):
            raise ValueError(f"corrupt vector file (dim={dim}): {path}")
    record = 4 + dim * elem
    size = os.path.getsize(path)
    if size % record != 0:
        raise ValueError(
            f"file size {size} is not a multiple of record size {record}"
            f" (dim={dim}): {path}")
    total = size // record
    start = min(offset, total)
    n = total - start if count is None else min(count, total - start)

    mm = np.memmap(path, dtype=np.uint8, mode="r",
                   offset=start * record, shape=(n * record,))
    raw = np.asarray(mm).reshape(n, record)
    dims = raw[:, :4].copy().view(np.int32).reshape(-1)
    if not (dims == dim).all():
        raise ValueError(f"inconsistent dims in {path}")
    return raw[:, 4:].copy().view(dtype).reshape(n, dim)


def write_vecs(path: str, vectors: np.ndarray) -> None:
    """Write an [n, dim] array in .fvecs/.ivecs/.bvecs format."""
    dtype = _vec_format(path)
    vectors = np.ascontiguousarray(vectors, dtype)
    n, dim = vectors.shape
    head = np.full((n, 1), dim, np.int32)
    with open(path, "wb") as f:
        out = np.concatenate(
            [head.view(np.uint8).reshape(n, 4),
             vectors.view(np.uint8).reshape(n, -1)], axis=1)
        out.tofile(f)


def synthetic_clustered(n: int, dims: int, n_centers: int = 1000,
                        center_scale: float = 4.0, seed: int = 0,
                        n_queries: int = 0):
    """Reproducible SIFT-like clustered synthetic corpus (the zero-egress
    stand-in for the BASELINE datasets): a mixture of Gaussians, queries
    drawn from the same mixture."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=center_scale,
                         size=(n_centers, dims)).astype(np.float32)
    pts = (centers[rng.integers(0, n_centers, n)] +
           rng.normal(size=(n, dims)).astype(np.float32))
    if n_queries:
        qs = (centers[rng.integers(0, n_centers, n_queries)] +
              rng.normal(size=(n_queries, dims)).astype(np.float32))
        return pts.astype(np.float32), qs.astype(np.float32)
    return pts.astype(np.float32)


def synthetic_correlated(n: int, dims: int, rank: int = 8,
                         n_centers: int = 1000, center_scale: float = 4.0,
                         noise: float = 0.05, seed: int = 0,
                         n_queries: int = 0):
    """Adversarial family 1 — correlated dims: clustered signal living in
    a random ``rank``-dimensional subspace embedded by a fixed orthogonal
    map, plus small isotropic noise.  Real embedding corpora are low-rank
    like this (PCA spectra decay fast); contiguous-dim PQ groups suffer
    exactly here, and OPQ's learned rotation is the designed fix — this
    generator separates "PQ on isotropic toy data" from "PQ on data shaped
    like production"."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(dims, dims)))
    basis = basis[:, :rank].astype(np.float32)          # D x r orthonormal
    centers = rng.normal(scale=center_scale,
                         size=(n_centers, rank)).astype(np.float32)

    def draw(m):
        z = (centers[rng.integers(0, n_centers, m)] +
             rng.normal(size=(m, rank)).astype(np.float32))
        return (z @ basis.T +
                noise * rng.normal(size=(m, dims)).astype(np.float32)
                ).astype(np.float32)

    pts = draw(n)
    if n_queries:
        return pts, draw(n_queries)
    return pts


def synthetic_powerlaw(n: int, dims: int, n_centers: int = 1000,
                       center_scale: float = 4.0, zipf_a: float = 1.3,
                       seed: int = 0, n_queries: int = 0):
    """Adversarial family 2 — power-law cluster sizes: Zipf-weighted
    center assignment (a few huge dense clusters, a long tail of sparse
    ones).  Stresses graph construction where dense regions saturate the
    maxM link budget and tail clusters risk disconnection; queries are
    drawn with the same weights, so recall is dominated by the dense
    clusters the index must resolve INSIDE."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=center_scale,
                         size=(n_centers, dims)).astype(np.float32)
    w = 1.0 / np.arange(1, n_centers + 1, dtype=np.float64) ** zipf_a
    w /= w.sum()

    def draw(m):
        a = rng.choice(n_centers, size=m, p=w)
        return (centers[a] +
                rng.normal(size=(m, dims)).astype(np.float32)
                ).astype(np.float32)

    pts = draw(n)
    if n_queries:
        return pts, draw(n_queries)
    return pts


def synthetic_duplicates(n: int, dims: int, n_uniques: Optional[int] = None,
                         dup_frac: float = 0.5, jitter: float = 1e-3,
                         n_centers: int = 1000, center_scale: float = 4.0,
                         seed: int = 0, n_queries: int = 0):
    """Adversarial family 3 — duplicate/near-duplicate heavy corpus:
    ``dup_frac`` of rows are exact copies or ``jitter``-perturbed copies of
    a smaller unique set (web-scrape dedup failures, repeated boilerplate
    embeddings).  Stresses distance ties — the tie-break parity paths the
    engine pins against the reference — and neighbor-list diversity (a
    node's maxM links can fill with copies of itself)."""
    rng = np.random.default_rng(seed)
    if n_uniques is None:
        n_uniques = max(n // 10, 1)
    centers = rng.normal(scale=center_scale,
                         size=(n_centers, dims)).astype(np.float32)
    uniq = (centers[rng.integers(0, n_centers, n_uniques)] +
            rng.normal(size=(n_uniques, dims)).astype(np.float32))
    n_dup = int(n * dup_frac)
    src = rng.integers(0, n_uniques, n_dup)
    exact = rng.random(n_dup) < 0.5
    dups = uniq[src] + np.where(
        exact[:, None], 0.0,
        jitter * rng.normal(size=(n_dup, dims))).astype(np.float32)
    fresh = (centers[rng.integers(0, n_centers, n - n_dup)] +
             rng.normal(size=(n - n_dup, dims)).astype(np.float32))
    pts = np.concatenate([dups, fresh]).astype(np.float32)
    rng.shuffle(pts)
    if n_queries:
        qs = (uniq[rng.integers(0, n_uniques, n_queries)] +
              0.1 * rng.normal(size=(n_queries, dims)).astype(np.float32))
        return pts, qs.astype(np.float32)
    return pts
