"""Device-resident graph state — the counterpart of pg_embedding_tpu/core/graph.py.

The reference stores each node as a packed record
``[count:u32][links:u32 x maxM][coords:f32 x dim][label:u64]`` inside 8KB
Postgres pages (embedding.c:224-231).  Here, as in the JAX package, that
becomes structure-of-arrays on the device so a whole frontier's neighbour
rows gather in one shot:

  vectors     f32[cap, D]     coordinate rows (bf16 under
                              storage_dtype="bfloat16")
  links       i32[cap, maxM]  adjacency, -1 padded
  link_counts i32[cap]        valid-link counts
  deleted     bool[cap]       tombstone bits (embedding.c:44)
  n_nodes     int             nodes appended so far (a host integer: the
                              API always knows it, and reading a device
                              scalar would sync)

Labels (the u64 heap-TID analog) live on the host in the API layer.  Unlike
the JAX package's immutable arrays, the insert path updates these tensors
in place (core/build.py); the API's reader-writer lock keeps searches from
overlapping it.
"""

from __future__ import annotations

import dataclasses

import torch

# Same capacity rounding as the JAX package, so array shapes agree in the
# parity tests: a 32-row grain, and above 1M rows the JAX exact sweep's
# tile LCM.
_EXACT_TILE_ALIGN = 15360
_ALIGN_THRESHOLD = 1_000_000
# records are gathered this many nodes at a time, so packing peaks at the
# records plus one chunk
_PACK_CHUNK = 131_072


def _round_capacity(capacity: int) -> int:
    grain = _EXACT_TILE_ALIGN if capacity >= _ALIGN_THRESHOLD else 32
    return max(-(-int(capacity) // grain) * grain, 32)


@dataclasses.dataclass
class GraphState:
    vectors: torch.Tensor      # f32 or bf16 [cap, D]
    links: torch.Tensor        # i32[cap, maxM], -1 padded
    link_counts: torch.Tensor  # i32[cap]
    deleted: torch.Tensor      # bool[cap]
    n_nodes: int = 0

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dims(self) -> int:
        return self.vectors.shape[1]

    @property
    def max_m(self) -> int:
        return self.links.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def empty_graph(capacity: int, dims: int, max_m: int, device="cpu",
                dtype=torch.float32) -> GraphState:
    """Allocate an empty graph whose rows are stored as ``dtype``;
    capacity is rounded by _round_capacity."""
    cap = _round_capacity(capacity)
    return GraphState(
        vectors=torch.zeros((cap, dims), dtype=dtype, device=device),
        links=torch.full((cap, max_m), -1, dtype=torch.int32, device=device),
        link_counts=torch.zeros((cap,), dtype=torch.int32, device=device),
        deleted=torch.zeros((cap,), dtype=torch.bool, device=device),
        n_nodes=0,
    )


def grow_graph(graph: GraphState, new_capacity: int) -> GraphState:
    """Capacity growth (the relation-extend analog, embedding.c:633-683):
    a new allocation with the old rows copied in."""
    cap = _round_capacity(new_capacity)
    old = graph.capacity
    if cap <= old:
        return graph
    out = empty_graph(cap, graph.dims, graph.max_m, device=graph.device,
                      dtype=graph.vectors.dtype)
    out.vectors[:old] = graph.vectors
    out.links[:old] = graph.links
    out.link_counts[:old] = graph.link_counts
    out.deleted[:old] = graph.deleted
    out.n_nodes = graph.n_nodes
    return out


def pack_records(rows: torch.Tensor, links: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """Packed neighbour records [cap, maxM, W] of ``dtype`` (default:
    rows'): record i, slot j holds rows[links[i, j]] (row 0 where the slot
    is empty).  ``rows`` is [cap, W]: corpus rows, their int8 shadow, or PQ
    codes."""
    cap, max_m = links.shape
    out = torch.empty((cap, max_m, rows.shape[1]), dtype=dtype or rows.dtype,
                      device=rows.device)
    for start in range(0, cap, _PACK_CHUNK):
        end = min(start + _PACK_CHUNK, cap)
        out[start:end] = rows[links[start:end].clamp(min=0)]
    return out
