"""The beam walk's operands for each row source over an integer-coordinate
graph, and their move to a device: one builder for the card tests
(tests/test_torch_cuda.py and the CPU tests that share its fixture) and
chip_smoke.py, which imports it without pytest.  Imports no JAX."""

import dataclasses

import numpy as np
import torch

from pg_embedding_tpu_torch.convert import graph_from_numpy


def integer_operands(arrays, qs, source, groups=8):
    """The walk's operands for row source ``source`` over the integer
    fixture, as CPU tensors: (graph, queries, search_graph's keyword
    operands).  Every row value is exact and every L2 and Manhattan
    distance exact in float32: int8 codes are the rows' integers with
    power-of-two scales (0.5, 1, 2), bf16 holds them exactly, the PQ
    codebook is integers in [-8, 8] (``groups`` groups, 8 by default; the
    codes are pq_encode's of the rows) and OPQ's rotation a signed
    permutation (the walk's query q @ R is integer too)."""
    from pg_embedding_tpu_torch.core.graph import pack_records
    from pg_embedding_tpu_torch.ops.pq import pq_encode
    g = graph_from_numpy(arrays["vectors"], arrays["links"],
                         arrays["link_counts"], arrays["deleted"],
                         arrays["n_nodes"], device="cpu")
    q = torch.from_numpy(qs)
    dims = g.vectors.shape[1]
    rng = np.random.default_rng(21)
    scale = torch.from_numpy(rng.choice([0.5, 1.0, 2.0], g.capacity)
                             .astype(np.float32))
    kw = {}
    if source == "rows bf16":
        g.vectors = g.vectors.to(torch.bfloat16)
    elif source == "rows int8":
        kw = dict(qvectors=g.vectors.to(torch.int8), qscale=scale)
    elif source == "records int8":
        kw = dict(pcodes=pack_records(g.vectors.to(torch.int8), g.links),
                  pscales=scale[g.links.clamp(min=0)])
    elif source in ("records f32", "records bf16"):
        dt = torch.float32 if source.endswith("f32") else torch.bfloat16
        kw = dict(pcodes=pack_records(g.vectors, g.links, dt))
    elif source.startswith("records pq"):
        cb = torch.from_numpy(rng.integers(
            -8, 9, size=(groups, 256, dims // groups)).astype(np.float32))
        rot = None
        if source.endswith("rotated"):
            rot = torch.zeros((dims, dims))
            signs = torch.from_numpy(
                rng.choice([-1.0, 1.0], dims).astype(np.float32))
            rot[torch.arange(dims),
                torch.from_numpy(rng.permutation(dims))] = signs
            kw["query_t"] = q @ rot
        codes = pq_encode(g.vectors, cb, rot)
        kw.update(pcodes=pack_records(codes, g.links), pq_codebook=cb)
    return g, q, kw


# PQ walks at wide rows, where the table and the staged codes do not both
# fit a block (D 1536, maxM 32, T 8): (metric, G) -> where the table lies
# (ops/cuda_graph._pq_place): cosine at G = 96 and L2 at G = 192 keep it in
# shared memory and read the codes from the records; cosine at G = 192 and
# L2 at G = 384 build it in device memory
WIDE_ROW_DIMS = 1536
WIDE_ROW_PQ = {("cosine", 96): "shared", ("l2", 192): "shared",
               ("cosine", 192): "device", ("l2", 384): "device"}


def wide_row_operands(groups, n=3000, b=128, max_m=32, seed=5):
    """A PQ walk's operands at WIDE_ROW_DIMS, as CPU tensors: (graph,
    queries, search_graph's keyword operands) over ``n`` integer rows in
    [-8, 8] with random full links (maxM ``max_m``), an integer codebook
    in [-8, 8] of ``groups`` groups and pq_encode's codes packed as
    records: every L2 sum is exact in float32 (at most 256 D < 2^24)."""
    from pg_embedding_tpu_torch.convert import graph_from_numpy
    from pg_embedding_tpu_torch.core.graph import pack_records
    from pg_embedding_tpu_torch.ops.pq import pq_encode
    rng = np.random.default_rng(seed)
    dims = WIDE_ROW_DIMS
    g = graph_from_numpy(
        rng.integers(-8, 9, size=(n, dims)).astype(np.float32),
        rng.integers(0, n, size=(n, max_m)).astype(np.int32),
        np.full(n, max_m, np.int32), np.zeros(n, bool), n, device="cpu")
    q = torch.from_numpy(rng.integers(-8, 9, size=(b, dims)).astype(
        np.float32))
    cb = torch.from_numpy(rng.integers(
        -8, 9, size=(groups, 256, dims // groups)).astype(np.float32))
    codes = pq_encode(g.vectors, cb, None)
    return g, q, dict(pcodes=pack_records(codes, g.links), pq_codebook=cb)


def on_device(graph, kw, dev, twin=False):
    """The graph and the walk's operands on ``dev``; search_graph's
    ``pcodes`` become the wrapper's ``records`` unless ``twin`` (the
    operands of core/search._search_batch)."""
    g = dataclasses.replace(graph, **{
        f: getattr(graph, f).to(dev)
        for f in ("vectors", "links", "link_counts", "deleted")})
    kw = {("records" if k == "pcodes" and not twin else k): v.to(dev)
          for k, v in kw.items()}
    return g, kw
