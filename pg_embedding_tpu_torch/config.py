"""Index configuration — the TPU-native analog of pg_embedding's reloptions.

The reference exposes exactly four reloptions (reference: embedding.c:111-151):
  - ``dims``            required, no default (error if missing: embedding.c:220)
  - ``m``               default 100
  - ``efconstruction``  default 16
  - ``efsearch``        default 64
plus the distance metric, chosen by opclass at CREATE INDEX time
(``ann_l2_ops`` default / ``ann_cos_ops`` / ``ann_manhattan_ops``,
embedding--0.3.6.sql:57-70).  Derived, not configurable: ``maxM = 2*M``
(embedding.c:224).

Mutability rule (reference: embedding.c:594-602): ``dims``/``m``/metric are
frozen once the index exists (a page-opaque {dims, maxM} guard detects
format-breaking ALTER INDEX); only the ef* knobs may change after build.
We reproduce that with :meth:`HnswConfig.with_ef`, the only sanctioned way
to derive a mutated config.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict


class Metric(enum.Enum):
    """Distance metric — mirrors ``dist_func_t`` (reference: embedding.h:22-26).

    Values match the reference enum so serialized indexes are self-describing.
    """

    L2 = 0          # sqrt of sum of squared diffs (distfunc.c:121-130)
    COSINE = 1      # 1 - dot/sqrt(|a||b|)        (distfunc.c:133-145)
    MANHATTAN = 2   # sum of abs diffs            (distfunc.c:147-155)


# Operator-name aliases matching the SQL surface (embedding--0.3.6.sql:31-44).
OPERATOR_TO_METRIC = {
    "<->": Metric.L2,
    "<=>": Metric.COSINE,
    "<~>": Metric.MANHATTAN,
}

# Opclass-name aliases (embedding--0.3.6.sql:57-70). ann_l2_ops is DEFAULT.
OPCLASS_TO_METRIC = {
    "ann_l2_ops": Metric.L2,
    "ann_cos_ops": Metric.COSINE,
    "ann_manhattan_ops": Metric.MANHATTAN,
}

# Reference defaults (embedding.c:111-113).
DEFAULT_M = 100
DEFAULT_EF_CONSTRUCTION = 16
DEFAULT_EF_SEARCH = 64

# Sanity caps. The reference bounds dims only implicitly (one element must fit
# an 8KB page: embedding.c:229-231). We are not page-bound, but keep a generous
# explicit cap to catch garbage configs early.
MAX_DIMS = 1 << 14
MAX_M = 1 << 12
MAX_EF = 1 << 20


class HnswConfigError(ValueError):
    """Invalid configuration — analog of the reloption elog(ERROR) paths."""


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Typed index configuration with the reference's knobs and derivations."""

    dims: int
    m: int = DEFAULT_M
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    ef_search: int = DEFAULT_EF_SEARCH
    metric: Metric = Metric.L2

    def __post_init__(self) -> None:
        if not isinstance(self.dims, int) or isinstance(self.dims, bool):
            raise HnswConfigError("dims must be an integer")
        if self.dims <= 0:
            # analog of "Number of dimensions is not specified" (embedding.c:220)
            raise HnswConfigError(
                "number of dimensions must be specified and positive"
            )
        if self.dims > MAX_DIMS:
            raise HnswConfigError(f"dims={self.dims} exceeds maximum {MAX_DIMS}")
        if not (1 <= self.m <= MAX_M):
            raise HnswConfigError(f"m={self.m} out of range [1, {MAX_M}]")
        if not (1 <= self.ef_construction <= MAX_EF):
            raise HnswConfigError(
                f"ef_construction={self.ef_construction} out of range [1, {MAX_EF}]"
            )
        if not (1 <= self.ef_search <= MAX_EF):
            raise HnswConfigError(
                f"ef_search={self.ef_search} out of range [1, {MAX_EF}]"
            )
        if isinstance(self.metric, str):
            object.__setattr__(self, "metric", resolve_metric(self.metric))
        elif not isinstance(self.metric, Metric):
            raise HnswConfigError(f"unknown metric: {self.metric!r}")

    @property
    def max_m(self) -> int:
        """Max node degree: ``maxM = 2*M`` (reference: embedding.c:224)."""
        return 2 * self.m

    def with_ef(self, *, ef_construction: int | None = None,
                ef_search: int | None = None) -> "HnswConfig":
        """Return a config with ef knobs changed — the only legal post-build
        mutation (reference guard: embedding.c:594-602)."""
        return dataclasses.replace(
            self,
            ef_construction=(self.ef_construction if ef_construction is None
                             else ef_construction),
            ef_search=(self.ef_search if ef_search is None else ef_search),
        )

    def frozen_fields(self) -> Dict[str, Any]:
        """The format-defining fields checked by the metadata guard on load
        (analog of HnswPageOpaque {dims, maxM}: embedding.c:81-85)."""
        return {"dims": self.dims, "max_m": self.max_m,
                "metric": self.metric.value}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "dims": self.dims,
            "m": self.m,
            "ef_construction": self.ef_construction,
            "ef_search": self.ef_search,
            "metric": self.metric.name,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HnswConfig":
        return cls(
            dims=int(d["dims"]),
            m=int(d.get("m", DEFAULT_M)),
            ef_construction=int(d.get("ef_construction", DEFAULT_EF_CONSTRUCTION)),
            ef_search=int(d.get("ef_search", DEFAULT_EF_SEARCH)),
            metric=resolve_metric(d.get("metric", Metric.L2)),
        )


def resolve_metric(metric: Any) -> Metric:
    """Resolve a metric from a Metric, an enum value, an operator string
    (``<->``/``<=>``/``<~>``), an opclass name, or a plain name.

    The TPU analog of ``hnsw_resolve_dist_func`` (reference:
    embedding.c:191-203), which resolves the metric by comparing opclass
    support-function addresses.
    """
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, int):
        return Metric(metric)
    if isinstance(metric, str):
        if metric in OPERATOR_TO_METRIC:
            return OPERATOR_TO_METRIC[metric]
        if metric in OPCLASS_TO_METRIC:
            return OPCLASS_TO_METRIC[metric]
        try:
            return Metric[metric.upper()]
        except KeyError:
            pass
    raise HnswConfigError(f"unknown metric: {metric!r}")
