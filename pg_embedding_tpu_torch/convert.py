"""Hand state between the JAX package and this one as numpy arrays.

``graph_from_numpy`` / ``index_from_numpy`` take the JAX package's graph
arrays (``np.asarray(jax_index.graph.vectors)``, ...) and labels and build
this package's ``GraphState`` / ``HnswIndex`` over the same graph, so both
packages compute on identical state; ``to_numpy`` goes the other way for
comparisons.  A bf16 corpus comes as ml_dtypes' bfloat16 array (what
``np.asarray`` of a JAX bf16 array gives) or as float32 values with
``storage_dtype="bfloat16"``; either way it is stored as torch.bfloat16.
Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .api import HnswIndex
from .config import HnswConfig
from .core.graph import GraphState


def graph_from_numpy(vectors, links, link_counts, deleted, n_nodes,
                     device="cpu", storage_dtype: Optional[str] = None
                     ) -> GraphState:
    """A GraphState holding copies of the given arrays on ``device``; the
    rows are stored as ``storage_dtype`` ("float32" or "bfloat16"; None
    takes the vectors' own dtype)."""
    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    vectors = np.asarray(vectors)
    if storage_dtype is None:
        storage_dtype = ("bfloat16" if vectors.dtype.name == "bfloat16"
                         else "float32")
    return GraphState(vectors=t(vectors.astype(np.float32),
                                getattr(torch, storage_dtype)),
                      links=t(links, torch.int32),
                      link_counts=t(link_counts, torch.int32),
                      deleted=t(deleted, torch.bool),
                      n_nodes=int(n_nodes))


def index_from_numpy(config: HnswConfig, vectors, links, link_counts,
                     deleted, n_nodes, labels, device="cpu",
                     pq_codebook=None, pq_rot=None,
                     **kwargs) -> HnswIndex:
    """An HnswIndex over the given graph arrays and labels; ``kwargs`` go
    to the HnswIndex constructor (the serving knobs: storage_dtype,
    quantized_traversal, packed_traversal, packed_dtype, ...).  A trained
    PQ codebook f32[G, 256, D/G] (and OPQ rotation f32[D, D]) is served as
    given, as load() serves a saved one: pq_groups becomes G, and a
    rotation sets pq_opq."""
    graph = graph_from_numpy(vectors, links, link_counts, deleted, n_nodes,
                             device=device,
                             storage_dtype=kwargs.get("storage_dtype"))
    if pq_codebook is not None:
        kwargs.setdefault("pq_groups", np.asarray(pq_codebook).shape[0])
    kwargs["storage_dtype"] = ("bfloat16"
                               if graph.vectors.dtype == torch.bfloat16
                               else "float32")
    idx = HnswIndex(config, device=device, **kwargs)
    if graph.dims != config.dims or graph.max_m != config.max_m:
        raise ValueError(f"graph is {graph.dims}-d with maxM {graph.max_m}; "
                         f"config wants {config.dims}-d, maxM {config.max_m}")
    idx._graph = graph
    idx._labels = np.zeros(graph.capacity, dtype=np.uint64)
    idx._labels[: graph.n_nodes] = np.asarray(labels, np.uint64)[: graph.n_nodes]
    idx.counters["n_deleted"] = int(graph.deleted[: graph.n_nodes].sum())
    if pq_codebook is not None:
        idx._pq_codebook = torch.tensor(np.asarray(pq_codebook),
                                        dtype=torch.float32, device=device)
    if pq_rot is not None:
        idx._pq_rot = torch.tensor(np.asarray(pq_rot), dtype=torch.float32,
                                   device=device)
        idx.pq_opq = True
    return idx


def to_numpy(graph: GraphState) -> Dict[str, np.ndarray]:
    """The graph's arrays as host numpy arrays (n_nodes as an int; bf16
    rows widen to float32)."""
    return {"vectors": graph.vectors.to(torch.float32).cpu().numpy(),
            "links": graph.links.cpu().numpy(),
            "link_counts": graph.link_counts.cpu().numpy(),
            "deleted": graph.deleted.cpu().numpy(),
            "n_nodes": graph.n_nodes}
