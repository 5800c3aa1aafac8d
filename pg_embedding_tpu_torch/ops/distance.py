"""Distance functions — the PyTorch counterpart of pg_embedding_tpu/ops/distance.py.

The reference implements three metrics as scalar/SIMD loops over float32
pairs (reference: distfunc.c:28-169):

  - L2:        ``sqrtf(sum((a-b)^2))``           distfunc.c:121-130
  - cosine:    ``1 - dot(a,b)/sqrt(|a|^2|b|^2)`` distfunc.c:133-145
  - manhattan: ``sum(|a-b|)``                    distfunc.c:147-155

Two families, as in the JAX package:

  * ``dist_one_to_many`` — queries vs small gathered sets (the beam-search
    inner loop and every rerank).  Exact elementwise (difference) form.
  * ``pairwise_dist`` — a distance matrix (the brute-force oracle, the
    construction sweep, the pruning heuristic).  L2 and cosine use the
    matmul expansion; Manhattan has none and uses ``torch.cdist(p=1)``.

Every function takes leading batch dimensions, which replaces the JAX
package's ``vmap`` over these functions.  Rows stored in bfloat16 follow
the JAX package's semantics on the CPU, where its tests run: an operation
with a float32 operand promotes to float32 (torch's ``@`` does not
promote, so the matmuls cast explicitly); an operation on bf16 operands
only rounds its result to bf16, and a sum of squares of bf16 values
accumulates the squares in float32 and rounds once (:func:`_sum_sq`, what
XLA's fusion does under jit).  All other math is float32, and float32
matmuls must run in full float32: a TF32 product keeps ~10 mantissa bits,
whose O(1) absolute score error at |p||q| ~ 2e3 reorders true neighbours
(the reason the JAX package forces ``Precision.HIGHEST``).  PyTorch's
default ("highest") is required; :func:`_matmul` raises on anything else
instead of silently computing a less exact ordering.
"""

from __future__ import annotations

import torch

from ..config import Metric


def _metric_value(metric) -> int:
    return metric.value if isinstance(metric, Metric) else int(metric)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; distance scores need "
            "full float32 (torch.set_float32_matmul_precision('highest'))")
    return torch.matmul(a, b)


def _sum_sq(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """sum(x * x) over the last axis, squared and summed in float32 and
    rounded once to x's dtype."""
    xf = x.to(torch.float32)
    return torch.sum(xf * xf, dim=-1, keepdim=keepdim).to(x.dtype)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as jnp.sqrt and CUDA's sqrtf
    give it.  torch's vectorised float32 sqrt on the CPU is off by an ulp
    for ~0.5% of inputs (sqrt(999) -> 31.60696, not 31.606962); the square
    root of a float32 taken in float64 and rounded once is exact."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def dist_one_to_many(query: torch.Tensor, points: torch.Tensor,
                     metric) -> torch.Tensor:
    """Distances from queries [..., D] to gathered sets [..., K, D] -> [..., K].

    Exact per-formula computation matching distfunc.c semantics; used where
    the reference calls ``calc_dist_func`` per neighbor (hnswalg.cpp:36-40).
    """
    m = _metric_value(metric)
    q = query.unsqueeze(-2)
    if m == Metric.L2.value:
        return _sqrt(_sum_sq(points - q))
    if m == Metric.COSINE.value:
        dt = torch.promote_types(points.dtype, query.dtype)
        dot = _matmul(points.to(dt), query.to(dt).unsqueeze(-1)).squeeze(-1)
        na = _sum_sq(query, keepdim=True)
        nb = _sum_sq(points)
        return 1.0 - dot * torch.rsqrt(torch.clamp(na * nb, min=1e-30))
    if m == Metric.MANHATTAN.value:
        return torch.sum(torch.abs(points - q), dim=-1)
    raise ValueError(f"unknown metric: {metric}")


def dist_pair(a: torch.Tensor, b: torch.Tensor, metric) -> torch.Tensor:
    """Single-pair distance [D],[D] -> scalar (distfunc.c:171-174)."""
    return dist_one_to_many(a, b.unsqueeze(0), metric)[0]


def pairwise_dist(queries: torch.Tensor, points: torch.Tensor,
                  metric) -> torch.Tensor:
    """Distance matrix [..., B, D] x [..., N, D] -> [..., B, N], float32.

    L2/cosine route their FLOPs through one matmul; Manhattan has no
    matmul form and broadcasts (callers tile N to bound memory).  Points
    are scored in float32 whatever their storage dtype; the query norms
    keep the queries' dtype (jnp's order of operations)."""
    m = _metric_value(metric)
    pf = points.to(torch.float32)
    qf = queries.to(torch.float32)
    if m == Metric.L2.value:
        qq = _sum_sq(queries, keepdim=True)                           # [B,1]
        pp = torch.sum(pf * pf, dim=-1).unsqueeze(-2)                 # [1,N]
        qp = _matmul(qf, pf.transpose(-1, -2))
        return _sqrt(torch.clamp(qq + pp - 2.0 * qp, min=0.0))
    if m == Metric.COSINE.value:
        qp = _matmul(qf, pf.transpose(-1, -2))
        nq = _sum_sq(queries, keepdim=True)
        npts = torch.sum(pf * pf, dim=-1).unsqueeze(-2)
        return 1.0 - qp * torch.rsqrt(torch.clamp(nq * npts, min=1e-30))
    if m == Metric.MANHATTAN.value:
        # cdist accumulates |a-b| per pair without materializing the
        # [B, N, D] broadcast (XLA fuses that away in the JAX package)
        return torch.cdist(qf, pf, p=1.0)
    raise ValueError(f"unknown metric: {metric}")


# ---------------------------------------------------------------------------
# Seq-scan operator analogs (embedding.c:1040-1062)
# ---------------------------------------------------------------------------

def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _check_dims(a, b) -> None:
    # analog of the per-call dimension check in calc_distance
    # (embedding.c:1030-1035)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(
            f"different array dimensions {a.shape[-1]} and {b.shape[-1]}"
        )


def _operator(a, b, metric) -> torch.Tensor:
    a, b = _as_f32(a), _as_f32(b)
    _check_dims(a, b)
    return dist_pair(a, b, metric)


def l2_distance(a, b) -> torch.Tensor:
    """``<->`` operator (embedding--0.3.6.sql:31-34; embedding.c:1040-1046)."""
    return _operator(a, b, Metric.L2)


def cosine_distance(a, b) -> torch.Tensor:
    """``<=>`` operator (embedding--0.3.6.sql:35-38; embedding.c:1048-1054)."""
    return _operator(a, b, Metric.COSINE)


def manhattan_distance(a, b) -> torch.Tensor:
    """``<~>`` operator (embedding--0.3.6.sql:39-42; embedding.c:1056-1062)."""
    return _operator(a, b, Metric.MANHATTAN)
