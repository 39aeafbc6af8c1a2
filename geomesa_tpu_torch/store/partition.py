"""Partition schemes: feature -> partition name; query bounds -> partitions.

The counterpart of the reference package's `store/partition.py` for the
time-bucketed `DateTimeScheme`, the default scheme of a schema with a
date attribute. Partition names are byte-identical to the reference's.
The spatial, attribute and composite schemes come with a later slice.

The reference formats one Python `datetime` per row; at tens of millions
of rows that is minutes of ingest. Here each row is floored to its time
bucket with `numpy.datetime64`, and only the DISTINCT buckets are
formatted, by the reference's own per-value formatter, so every name is
the reference's string by construction.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.errors import NotPortedError

_DT_PATTERNS: Dict[str, str] = {
    "yyyy": "%Y",
    "yyyy/MM": "%Y/%m",
    "yyyy/MM/dd": "%Y/%m/%d",
    "yyyy/MM/dd/HH": "%Y/%m/%d/%H",
    "yyyy/DDD": "%Y/%j",
}

_STEP = {
    "yyyy": "Y",
    "yyyy/MM": "M",
    "yyyy/MM/dd": "D",
    "yyyy/MM/dd/HH": "h",
    "yyyy/DDD": "D",
}

# bucket spans up to this many steps are grouped with a lookup table
# (O(n)); wider spans fall back to a sort (np.unique)
_LUT_SPAN = 1 << 22


@dataclasses.dataclass
class DateTimeScheme:
    """Time-bucketed directories, e.g. 2020/06/01 (pattern yyyy/MM/dd)."""

    pattern: str = "yyyy/MM/dd"
    dtg_attr: str = "dtg"

    def __post_init__(self):
        if self.pattern not in _DT_PATTERNS:
            raise ValueError(
                f"unsupported datetime pattern {self.pattern!r}; "
                f"one of {sorted(_DT_PATTERNS)}"
            )

    def _name(self, millis: int) -> str:
        """The reference's per-row formatter, applied to one value."""
        return _dt.datetime.fromtimestamp(
            int(millis) / 1000, _dt.timezone.utc
        ).strftime(_DT_PATTERNS[self.pattern])

    def partition_codes(self, millis) -> Tuple[List[str], np.ndarray]:
        """(names, codes): row i lies in partition names[codes[i]]. Names
        are distinct and sorted ascending by bucket."""
        step = _STEP[self.pattern]
        b = (np.asarray(millis, np.int64).astype("datetime64[ms]")
             .astype(f"datetime64[{step}]").astype(np.int64))
        if not len(b):
            return [], np.zeros(0, np.int32)
        lo = int(b.min())
        span = int(b.max()) - lo + 1
        if span <= _LUT_SPAN:
            rel = b - lo
            present = np.flatnonzero(np.bincount(rel, minlength=span))
            lut = np.full(span, -1, np.int32)
            lut[present] = np.arange(len(present), dtype=np.int32)
            buckets, codes = present + lo, lut[rel]
        else:
            buckets, codes = np.unique(b, return_inverse=True)
            codes = codes.astype(np.int32)
        starts = (np.asarray(buckets, np.int64).astype(f"datetime64[{step}]")
                  .astype("datetime64[ms]").astype(np.int64))
        return [self._name(m) for m in starts], codes

    def partitions_for(self, batch: FeatureBatch) -> List[str]:
        """Partition name per feature (len == len(batch))."""
        names, codes = self.partition_codes(batch.columns[self.dtg_attr])
        return [names[c] for c in codes]

    def prune(self, bbox: BBox, interval: Interval) -> Optional[Set[str]]:
        """Covering partition set for the bounds, or None (= all)."""
        if interval.start is None or interval.end is None:
            return None
        step = _STEP[self.pattern]
        t0 = np.datetime64(int(interval.start), "ms").astype(f"datetime64[{step}]")
        t1 = np.datetime64(int(interval.end), "ms").astype(f"datetime64[{step}]")
        bins = np.arange(t0, t1 + np.timedelta64(1, step))
        millis = bins.astype("datetime64[ms]").astype(np.int64)
        return {self._name(m) for m in millis}

    def to_config(self):
        return {"scheme": "datetime", "pattern": self.pattern, "dtg": self.dtg_attr}


def scheme_from_config(cfg: dict) -> DateTimeScheme:
    kind = cfg["scheme"]
    if kind == "datetime":
        return DateTimeScheme(cfg.get("pattern", "yyyy/MM/dd"), cfg.get("dtg", "dtg"))
    if kind in ("z2", "xz2", "attribute", "composite"):
        raise NotPortedError(f"the {kind!r} partition scheme",
                             "the partition-scheme slice (ROADMAP Queue A)")
    raise ValueError(f"unknown partition scheme {kind!r}")
