"""Per-query hints.

Parity: geomesa-index-api QueryHints [upstream, unverified] — the same hint
vocabulary (DENSITY_*, BIN_*, STATS_STRING, SAMPLING, LOOSE_BBOX,
EXACT_COUNT, QUERY_INDEX) as a typed dataclass. A hint changes *what the
scan computes* (aggregation push-down), not *which features match*
(`auths` excepted). A copy of the reference package's `plan/hints.py`.
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
    # dictionary-encoded strings (upstream: ARROW_ENCODE + ARROW_* hints).
    # include_fid pins the schema deterministically (synthesized row fids
    # when the store persisted none; stripped when False) so empty and
    # non-empty shard results always merge
    arrow_encode: bool = False
    arrow_include_fid: bool = True
    # ArrowScan sorted-delta protocol (upstream ARROW_SORT hints): each
    # shard emits its batch pre-sorted by this field with the sort stamped
    # in schema metadata; client-side merge_sorted_ipc verifies + merges
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

    # approximate-answer tier:
    # the client's accuracy contract — a count/density answer may be
    # served from sketches IFF its a-priori error bound fits
    # `bound <= tolerance * answer`; None (default) demands exactness.
    # Answers served under it carry approx/bound/confidence.
    tolerance: Optional[float] = None
    # top-k densest sketch-grid cells intersecting the query bbox — a
    # sketch-native aggregation (QueryResult kind "topk_cells"); with
    # no/unfit tolerance it computes exactly via a device density scan
    topk_cells: Optional[int] = None
    # DISTINCT count of one attribute's values. With a tolerance hint
    # the answer may resolve at admission from per-partition
    # HyperLogLog sketches (stats/sketches.py Cardinality merged under
    # the manifest snapshot — approx/engine.py fast_distinct) with a
    # typed [lo, hi] bound on the wire; otherwise it pays an exact
    # feature scan + host unique count
    distinct: Optional[str] = None

    # index override (upstream: QUERY_INDEX)
    query_index: Optional[str] = None

    # security context: the querying user's authorizations (upstream: the
    # AuthorizationsProvider SPI resolved per request). With a visibility
    # column configured (sft user_data `geomesa.vis.attr`), features whose
    # expression these auths do not satisfy are masked out of EVERY result
    # kind; attributes carrying a `visibility` option are redacted to null
    # in feature/arrow results (per-attribute visibility, SURVEY.md:464)
    auths: Tuple[str, ...] = ()

    # internal: the caller only needs a match count, so execution may keep
    # every mask on device and fetch a single reduced scalar (set by
    # QueryPlanner.count; the analog of the reference's count-optimized
    # stats/EXACT_COUNT path)
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
