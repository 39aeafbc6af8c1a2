"""Partition schemes: feature -> partition name; query bounds -> partitions.

The counterpart of the reference package's `store/partition.py`: the
time-bucketed `DateTimeScheme` (the default of a schema with a date
attribute), `Z2Scheme` (points), `XZ2Scheme` (extended geometries, the
default without a date), `AttributeScheme`, `CompositeScheme` and
`scheme_from_config`. Partition names and pruned sets are byte-identical
to the reference's.

The reference formats one name per row (a Python `datetime` or f-string
each); at tens of millions of rows that is minutes of ingest. Here each
scheme's `group(batch)` gives (names, codes): the DISTINCT names, made by
the reference's own per-value formatter, and each row's code, so every
name is the reference's string by construction. `partitions_for` expands
them to the reference's per-row list.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.curve.xz import XZ2SFC
from geomesa_tpu_torch.curve.z2 import Z2SFC


def _merge_names(names: Sequence[str], codes: np.ndarray
                 ) -> Tuple[List[str], np.ndarray]:
    """(names, codes) with equal names merged and the names sorted."""
    uniq, inv = np.unique(np.asarray(list(names), dtype=object).astype(str),
                          return_inverse=True)
    remap = inv.astype(np.int32)
    return [str(u) for u in uniq], (remap[codes] if len(codes)
                                     else np.zeros(0, np.int32))


class PartitionScheme:
    def group(self, batch: FeatureBatch) -> Tuple[List[str], np.ndarray]:
        """(names, codes): row i lies in partition names[codes[i]]; the
        names are distinct and sorted."""
        raise NotImplementedError

    def partitions_for(self, batch: FeatureBatch) -> List[str]:
        """Partition name per feature (len == len(batch))."""
        names, codes = self.group(batch)
        return [names[c] for c in codes]

    def prune(self, bbox: BBox, interval: Interval) -> Optional[Set[str]]:
        """Covering partition set for the bounds, or None (= all)."""
        raise NotImplementedError

    def to_config(self) -> dict:
        raise NotImplementedError


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
class DateTimeScheme(PartitionScheme):
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

    def group(self, batch: FeatureBatch) -> Tuple[List[str], np.ndarray]:
        return self.partition_codes(batch.columns[self.dtg_attr])

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


@dataclasses.dataclass
class Z2Scheme(PartitionScheme):
    """Z2-prefix directories: the top `bits` bits per dimension of the Z2
    curve, e.g. z2/0213 for bits=2 (4^2 cells). Points only."""

    bits: int = 4
    geom_attr: str = "geom"

    def __post_init__(self):
        self._sfc = Z2SFC(self.bits)
        self._digits = max(1, (2 * self.bits + 3) // 4)

    def _name(self, z: int) -> str:
        return f"z2/{int(z):0{self._digits}x}"

    def group(self, batch: FeatureBatch) -> Tuple[List[str], np.ndarray]:
        col = batch.columns[self.geom_attr]
        assert isinstance(col, GeometryColumn)
        z = np.asarray(self._sfc.index(col.x, col.y), np.int64).ravel()
        uz, codes = np.unique(z, return_inverse=True)
        return [self._name(v) for v in uz], codes.astype(np.int32)

    def prune(self, bbox: BBox, interval: Interval) -> Optional[Set[str]]:
        if bbox.is_whole_world:
            return None
        out: Set[str] = set()
        for r in self._sfc.ranges(bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax,
                                  max_ranges=4 ** self.bits):
            for z in range(r.lower, r.upper + 1):
                out.add(self._name(z))
        return out

    def to_config(self):
        return {"scheme": "z2", "bits": self.bits, "geom": self.geom_attr}


@dataclasses.dataclass
class XZ2Scheme(PartitionScheme):
    """XZ2 sequence-code directories for extended geometries: one code per
    distinct bounding box (a point's box is the point)."""

    g: int = 4
    geom_attr: str = "geom"

    def __post_init__(self):
        self._sfc = XZ2SFC(self.g)

    def group(self, batch: FeatureBatch) -> Tuple[List[str], np.ndarray]:
        col = batch.columns[self.geom_attr]
        assert isinstance(col, GeometryColumn)
        if col.is_point:
            boxes = np.stack([col.x, col.y, col.x, col.y], 1)
        else:
            boxes = np.asarray(col.bbox, np.float64)
        if not len(boxes):
            return [], np.zeros(0, np.int32)
        ub, inv = np.unique(boxes, axis=0, return_inverse=True)
        seq = np.array([self._sfc.index(*b) for b in ub.tolist()], np.int64)
        uc, codes = np.unique(seq[inv.ravel()], return_inverse=True)
        return _merge_names([f"xz2/{int(c)}" for c in uc], codes.astype(np.int32))

    def prune(self, bbox: BBox, interval: Interval) -> Optional[Set[str]]:
        if bbox.is_whole_world:
            return None
        from geomesa_tpu_torch.utils.config import SystemProperties

        out: Set[str] = set()
        budget = int(SystemProperties.SCAN_RANGES_TARGET.get())
        for r in self._sfc.ranges(bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax,
                                  max_ranges=budget):
            for c in range(r.lower, r.upper + 1):
                out.add(f"xz2/{c}")
        return out

    def to_config(self):
        return {"scheme": "xz2", "g": self.g, "geom": self.geom_attr}


@dataclasses.dataclass
class AttributeScheme(PartitionScheme):
    """One directory per attribute value (dictionary columns only); a null
    value goes to __null__."""

    attr: str = "type"

    def group(self, batch: FeatureBatch) -> Tuple[List[str], np.ndarray]:
        col = batch.columns[self.attr]
        assert isinstance(col, DictColumn)
        # code -1 (null) indexes the trailing "__null__" slot
        names = list(col.vocab) + ["__null__"]
        codes = np.where(col.codes >= 0, col.codes, len(col.vocab))
        used, codes = np.unique(codes, return_inverse=True)
        return _merge_names([names[c] for c in used], codes.astype(np.int32))

    def prune(self, bbox: BBox, interval: Interval) -> Optional[Set[str]]:
        return None  # attribute bounds do not flow through BBox/Interval

    def to_config(self):
        return {"scheme": "attribute", "attr": self.attr}


@dataclasses.dataclass
class CompositeScheme(PartitionScheme):
    """Hierarchical composition: parent/child paths (upstream: composite
    schemes such as datetime,z2)."""

    schemes: Sequence[PartitionScheme] = ()

    def group(self, batch: FeatureBatch) -> Tuple[List[str], np.ndarray]:
        levels = [s.group(batch) for s in self.schemes]
        combined = np.zeros(len(batch), np.int64)
        for names, codes in levels:
            combined = combined * max(len(names), 1) + codes
        uc, inv = np.unique(combined, return_inverse=True)
        paths = []
        for c in uc.tolist():
            parts = []
            for names, _ in reversed(levels):
                n = max(len(names), 1)
                parts.append(names[c % n])
                c //= n
            paths.append("/".join(reversed(parts)))
        return _merge_names(paths, inv.astype(np.int32))

    def prune(self, bbox: BBox, interval: Interval) -> Optional[Set[str]]:
        pruned = [s.prune(bbox, interval) for s in self.schemes]
        if all(p is None for p in pruned):
            return None
        # cartesian product of the per-level sets; a None level is a
        # wildcard, which cannot be enumerated, so the levels before it
        # become prefixes (prune_partitions matches name == p or p + "/")
        out: Set[str] = {""}
        for p in pruned:
            if p is None:
                return set(out)
            out = {(f"{prefix}/{name}" if prefix else name)
                   for prefix in out for name in p}
        return out

    def to_config(self):
        return {"scheme": "composite",
                "schemes": [s.to_config() for s in self.schemes]}


def scheme_from_config(cfg: dict) -> PartitionScheme:
    kind = cfg["scheme"]
    if kind == "datetime":
        return DateTimeScheme(cfg.get("pattern", "yyyy/MM/dd"), cfg.get("dtg", "dtg"))
    if kind == "z2":
        return Z2Scheme(cfg.get("bits", 4), cfg.get("geom", "geom"))
    if kind == "xz2":
        return XZ2Scheme(cfg.get("g", 4), cfg.get("geom", "geom"))
    if kind == "attribute":
        return AttributeScheme(cfg.get("attr", "type"))
    if kind == "composite":
        return CompositeScheme([scheme_from_config(s) for s in cfg["schemes"]])
    raise ValueError(f"unknown partition scheme {kind!r}")
