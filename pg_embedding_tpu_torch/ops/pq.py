"""Product quantization — the counterpart of pg_embedding_tpu/ops/pq.py.

D dims split into G contiguous groups; each group of a row is stored as the
index of its nearest centroid among 256 learned per-group centroids, one
byte per group, so a row costs G bytes instead of 4*D.  The codes serve two
engines: the packed PQ walk (records of each node's neighbours' codes,
core/search) and the compressed sweep (ops/pq_sweep).  Both rerank what
they surface with exact distances on the stored rows, so the codebooks are
L2 codebooks for every metric.

Training is per-group Lloyd k-means with all groups batched.  The JAX
package draws its init rows with ``jax.random.randint`` (threefry), which
torch cannot reproduce, so training is two parts here: an init draw from
an explicit ``torch.Generator`` (on the host, so the card and the CPU start
from the same rows) and the Lloyd core :func:`_lloyd`, which the parity
tests feed the JAX package's own init.  The update sums with ``index_add_``
instead of the JAX package's one-hot einsum, whose [G, n, 256] operand is
4.3 GB at n = 131,072 and G = 32; the two differ in summation order only.

Decoding is a gather from the codebook by code (:func:`pq_decode`).  The
JAX package's hot loops decode with a one-hot einsum (``pq_decode_mxu``, a
TPU matrix-unit trick); on the CPU both give the gather's values bit for
bit.  Every product runs in full float32 (``distance._matmul``).
"""

from __future__ import annotations

import torch

from ..core.graph import pack_records
from .distance import _matmul

N_CENTROIDS = 256  # one byte per group

# Rows per assignment tile: bounds the [G, rows, 256] score tile.
_ASSIGN_CHUNK = 16384


def _group_view(vectors: torch.Tensor, groups: int) -> torch.Tensor:
    """[N, D] -> [G, N, D/G] (contiguous dim groups)."""
    n, d = vectors.shape
    if d % groups:
        raise ValueError(f"dims {d} not divisible by pq groups {groups}")
    return vectors.reshape(n, groups, d // groups).transpose(0, 1)


def init_rows(n: int, groups: int, seed: int = 0) -> torch.Tensor:
    """The init draw: int64[G, 256] row indices in [0, n), drawn with
    replacement from a host ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, n, (groups, N_CENTROIDS), generator=gen)


def _lloyd(x: torch.Tensor, codebook: torch.Tensor,
           iters: int) -> torch.Tensor:
    """``iters`` Lloyd iterations on grouped rows x f32[G, n, sub] from
    codebook f32[G, 256, sub]: assign each row to argmin |x - c|^2 (the
    first on ties, as jnp.argmin), move each centroid to the mean of its
    rows; an empty cluster keeps its centroid.  Returns the codebook."""
    g, n, sub = x.shape
    x_sq = torch.sum(x * x, dim=2)                                 # [G, n]
    offset = (torch.arange(g, device=x.device) * N_CENTROIDS).unsqueeze(1)
    rows = x.reshape(g * n, sub)
    for _ in range(iters):
        c_sq = torch.sum(codebook * codebook, dim=2)               # [G, 256]
        assign = torch.empty((g, n), dtype=torch.int64, device=x.device)
        for s in range(0, n, _ASSIGN_CHUNK):
            e = min(s + _ASSIGN_CHUNK, n)
            xc = _matmul(x[:, s:e], codebook.transpose(1, 2))    # [G, c, 256]
            assign[:, s:e] = torch.argmin(
                x_sq[:, s:e, None] - 2.0 * xc + c_sq[:, None, :], dim=2)
        flat = (assign + offset).reshape(-1)
        sums = torch.zeros((g * N_CENTROIDS, sub), dtype=torch.float32,
                           device=x.device).index_add_(0, flat, rows)
        counts = torch.bincount(flat, minlength=g * N_CENTROIDS).to(
            torch.float32).view(g, N_CENTROIDS, 1)
        means = sums.view(g, N_CENTROIDS, sub) / torch.clamp(counts, min=1.0)
        codebook = torch.where(counts > 0, means, codebook)
    return codebook


def train_pq(sample: torch.Tensor, *, groups: int, iters: int = 12,
             seed: int = 0) -> torch.Tensor:
    """Per-group codebooks by batched Lloyd k-means on ``sample`` f32[n, D]
    (on its device): the init rows come from :func:`init_rows`.  Returns
    codebook f32[G, 256, D/G]."""
    x = _group_view(sample.to(torch.float32), groups).contiguous()
    idx = init_rows(x.shape[1], groups, seed).to(x.device)
    init = x[torch.arange(groups, device=x.device).unsqueeze(1), idx]
    return _lloyd(x, init, iters)


def encode_block(vectors: torch.Tensor, codebook: torch.Tensor
                 ) -> torch.Tensor:
    """Nearest-centroid codes for one block: f32[n, D] -> uint8[n, G].
    The argmin drops |x|^2, which is the same for every centroid."""
    groups = codebook.shape[0]
    x = _group_view(vectors.to(torch.float32), groups)             # [G, n, sub]
    xc = _matmul(x, codebook.transpose(1, 2))                      # [G, n, 256]
    c_sq = torch.sum(codebook * codebook, dim=2)
    assign = torch.argmin(c_sq[:, None, :] - 2.0 * xc, dim=2)      # [G, n]
    return assign.T.to(torch.uint8)


def pq_encode(vectors: torch.Tensor, codebook: torch.Tensor,
              rotation=None, *, chunk: int = 32768) -> torch.Tensor:
    """Chunked full-corpus encode: [N, D] (float32 or bf16) -> uint8[N, G].
    ``rotation`` (OPQ, f32[D, D]) multiplies each chunk first, so no
    rotated copy of the corpus is made."""
    n = vectors.shape[0]
    out = torch.empty((n, codebook.shape[0]), dtype=torch.uint8,
                      device=vectors.device)
    for s in range(0, n, chunk):
        block = vectors[s:s + chunk].to(torch.float32)
        if rotation is not None:
            block = _matmul(block, rotation)
        out[s:s + chunk] = encode_block(block, codebook)
    return out


def pack_pq_records(codes: torch.Tensor, links: torch.Tensor
                    ) -> torch.Tensor:
    """Packed PQ neighbour records uint8[cap, maxM, G]: record i, slot j
    holds the code of links[i, j] (row 0's where the slot is empty).  The
    JAX package's flat uint8[cap, maxM*G] records are the same bytes."""
    return pack_records(codes, links)


def pq_decode(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Rows from codes: uint8[..., G] -> f32[..., D], a gather of each
    group's centroid.  Codes become int64 first: a uint8 index tensor would
    be taken as a boolean mask."""
    groups, _, sub = codebook.shape
    flat = codes.reshape(-1, groups).long()
    rows = codebook[torch.arange(groups, device=codes.device), flat]
    return rows.reshape(*codes.shape[:-1], groups * sub)


def train_opq(sample: torch.Tensor, *, groups: int, iters: int = 8,
              pq_iters: int = 12, seed: int = 0):
    """OPQ-NP (Ge et al., CVPR'13): an orthogonal rotation R that spreads
    correlated variance across the groups, by alternating k-means in the
    rotated space with the Procrustes solve min_R |X R - decode(encode(X
    R))|_F = U V^T from svd(X^T Yhat).  Serving rotates the query (q @ R);
    the exact rerank stays in the original space.  Manhattan is not
    rotation-invariant, and the index refuses OPQ for it.

    Returns (rotation f32[D, D], codebook f32[G, 256, D/G])."""
    x = sample.to(torch.float32)
    rot = torch.eye(x.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        y = _matmul(x, rot)
        cb = train_pq(y, groups=groups, iters=4, seed=seed)
        yhat = pq_decode(encode_block(y, cb), cb)
        u, _, vt = torch.linalg.svd(_matmul(x.T, yhat), full_matrices=False)
        rot = _matmul(u, vt)
    return rot, train_pq(_matmul(x, rot), groups=groups, iters=pq_iters,
                         seed=seed)
