"""pg_embedding_tpu_torch — the flat-NSW vector search engine of
pg_embedding_tpu (the ``hnsw`` index of neondatabase/pg_embedding), ported
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

Same surface as the JAX package's single-device HnswIndex and VectorTable:
  SQL operators <-> / <=> / <~>      -> ops.distance.{l2,cosine,manhattan}_distance
  opclasses ann_{l2,cos,manhattan}_ops -> config.Metric + resolve_metric
  reloptions {dims,m,efconstruction,efsearch} -> config.HnswConfig
  CREATE INDEX / ambuild             -> api.HnswIndex.build
  aminsert                           -> api.HnswIndex.add
  amgettuple + progressive widening  -> api.HnswIndex.search / open_scan
  ambulkdelete (tombstones)          -> api.HnswIndex.delete
  amvacuumcleanup                    -> api.HnswIndex.vacuum
  seq-scan exact ordering            -> api.HnswIndex.exact_search /
                                        ops.cuda_bruteforce.fused_exact_search
  WAL/page durability                -> api.HnswIndex.save / load /
                                        enable_wal (wal.py)
  product quantization               -> ops.pq, packed_dtype="pq",
                                        search(mode="sweep_pq") (ops.pq_sweep)
  the SQL table surface              -> table.VectorTable

Importing builds no kernel: the CUDA sources compile at first CUDA use.
"""

from .config import HnswConfig, HnswConfigError, Metric, resolve_metric
from .ops.distance import cosine_distance, l2_distance, manhattan_distance
from .ops.bruteforce import exact_search
from .ops.cuda_bruteforce import fused_exact_search
from .api import HnswIndex, TuneResult, TuneTargetMissed
from .table import VectorTable

__version__ = "0.1.0"

__all__ = [
    "HnswConfig",
    "HnswConfigError",
    "Metric",
    "resolve_metric",
    "l2_distance",
    "cosine_distance",
    "manhattan_distance",
    "exact_search",
    "fused_exact_search",
    "HnswIndex",
    "TuneResult",
    "TuneTargetMissed",
    "VectorTable",
    "__version__",
]
