"""Per-query hints.

Parity: geomesa-index-api QueryHints [upstream, unverified], as the
reference package's `plan/hints.py` models them, restricted to the hints
the port reads: the density, stats, bin and arrow aggregations
(DensityScan, StatsScan, BinAggregatingScan, ArrowScan), sampling, loose
bbox and the exact count. Approximate answers and authorizations come
with their slices: a query cannot carry them here, so it cannot silently
ignore them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class QueryHints:
    # density aggregation (DensityScan): result is a weight grid
    density_bbox: Optional[Tuple[float, float, float, float]] = None
    density_width: Optional[int] = None
    density_height: Optional[int] = None
    density_weight: Optional[str] = None  # numeric attribute name
    # fidelity opt-out: with a weight column, pin the f32 scatter path
    # (the cell-dictionary kernel accumulates weights in another order)
    density_exact_weights: bool = False
    # cell-dictionary density kernel (engine.density_zsparse), tri-state:
    #   None  (default) = AUTO: point layers take the dictionary kernel,
    #          whose calibration routes each tile dictionary-vs-scatter;
    #          pinned off by exact_weights + a weight column
    #   True  = force it (still honours the exact_weights pin)
    #   False = force the scatter path
    density_zsparse: Optional[bool] = None

    # bin aggregation (BinAggregatingScan): compact dot-map records
    bin_track: Optional[str] = None  # attribute used as track id
    bin_label: Optional[str] = None

    # stats aggregation (StatsScan): Stat DSL expression
    stats_string: Optional[str] = None

    # arrow aggregation (ArrowScan): results as Arrow IPC stream bytes with
    # dictionary-encoded strings. include_fid pins the schema (fids
    # synthesized when the store kept none, stripped when False) so empty
    # and non-empty shard results always merge
    arrow_encode: bool = False
    arrow_include_fid: bool = True
    # sorted-delta protocol: each shard's batch pre-sorted by this field,
    # the sort stamped in the schema metadata for merge_sorted_ipc
    arrow_sort_field: Optional[str] = None
    arrow_sort_reverse: bool = False

    # sampling: keep roughly 1-in-n (None = off); optional per-attribute
    sampling: Optional[int] = None
    sample_by: Optional[str] = None

    # loose bbox: skip the residual exact predicate, accept the covering
    # index result (upstream: LOOSE_BBOX / the XZ "non-strict" mode)
    loose_bbox: bool = False

    # exact count: force full evaluation for counts instead of estimates
    exact_count: bool = True

    # index override (upstream: QUERY_INDEX); recorded by explain only
    query_index: Optional[str] = None

    # internal: the caller only needs a match count, so execution keeps
    # every mask on the device and fetches a reduced scalar (set by
    # QueryPlanner.count)
    count_only: bool = False

    @property
    def is_density(self) -> bool:
        return self.density_bbox is not None

    @property
    def is_stats(self) -> bool:
        return self.stats_string is not None

    @property
    def is_bin(self) -> bool:
        return self.bin_track is not None

    @property
    def is_arrow(self) -> bool:
        return self.arrow_encode
