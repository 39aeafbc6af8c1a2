"""Planning-time filter analysis: extract geometry bounds and time intervals.

Parity: geomesa-filter FilterHelper.extractGeometries / extractIntervals
[upstream, unverified]. Used by the query planner to derive index ranges and
partition pruning bounds from an arbitrary filter tree:

- AND: intersection of child bounds
- OR: union (as a covering envelope / interval hull, conservative)
- NOT / unanalyzable nodes: unconstrained (whole domain)

The results are *covering* bounds: a feature outside them definitely fails
the filter, but residual evaluation stays mandatory (same contract as the
reference's loose primary filter + residual secondary split).

A copy of the reference package's `cql/extract.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from geomesa_tpu_torch.cql import ast

WHOLE_WORLD = (-180.0, -90.0, 180.0, 90.0)


@dataclasses.dataclass(frozen=True)
class BBox:
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def is_empty(self) -> bool:
        return self.xmin > self.xmax or self.ymin > self.ymax

    @property
    def is_whole_world(self) -> bool:
        return (self.xmin, self.ymin, self.xmax, self.ymax) == WHOLE_WORLD

    def intersect(self, o: "BBox") -> "BBox":
        return BBox(
            max(self.xmin, o.xmin),
            max(self.ymin, o.ymin),
            min(self.xmax, o.xmax),
            min(self.ymax, o.ymax),
        )

    def union(self, o: "BBox") -> "BBox":
        return BBox(
            min(self.xmin, o.xmin),
            min(self.ymin, o.ymin),
            max(self.xmax, o.xmax),
            max(self.ymax, o.ymax),
        )

    def buffer_degrees(self, meters: float) -> "BBox":
        """Expand by a conservative degree equivalent of `meters`."""
        import math

        dlat = meters / 111_320.0
        # longitude degrees shrink with latitude; use the most permissive
        # (widest) expansion over the box's latitude span, capped at poles
        max_abs_lat = min(89.9, max(abs(self.ymin), abs(self.ymax)))
        dlon = meters / (111_320.0 * max(0.01, math.cos(math.radians(max_abs_lat))))
        return BBox(
            max(-180.0, self.xmin - dlon),
            max(-90.0, self.ymin - dlat),
            min(180.0, self.xmax + dlon),
            min(90.0, self.ymax + dlat),
        )


_WORLD = BBox(*WHOLE_WORLD)


@dataclasses.dataclass(frozen=True)
class Interval:
    """Epoch-millis interval [start, end]; None bound = unbounded."""

    start: Optional[int]
    end: Optional[int]

    @property
    def is_unbounded(self) -> bool:
        return self.start is None and self.end is None

    @property
    def is_empty(self) -> bool:
        return (
            self.start is not None and self.end is not None and self.start > self.end
        )

    def intersect(self, o: "Interval") -> "Interval":
        start = (
            max(x for x in (self.start, o.start) if x is not None)
            if (self.start is not None or o.start is not None)
            else None
        )
        end = (
            min(x for x in (self.end, o.end) if x is not None)
            if (self.end is not None or o.end is not None)
            else None
        )
        return Interval(start, end)

    def union(self, o: "Interval") -> "Interval":
        start = (
            None
            if self.start is None or o.start is None
            else min(self.start, o.start)
        )
        end = None if self.end is None or o.end is None else max(self.end, o.end)
        return Interval(start, end)


_ALL_TIME = Interval(None, None)


def extract_bbox(f: ast.Filter, geom_attr: str) -> BBox:
    """Covering lon/lat bounds implied by the filter for `geom_attr`."""
    if isinstance(f, (ast.SpatialPredicate,)) and f.prop.name == geom_attr:
        if f.op == "DISJOINT":
            return _WORLD  # disjoint constrains nothing (covering)
        x0, y0, x1, y1 = f.geometry.bbox
        return BBox(x0, y0, x1, y1)
    if isinstance(f, ast.DistancePredicate) and f.prop.name == geom_attr:
        if f.op == "BEYOND":
            return _WORLD
        x0, y0, x1, y1 = f.geometry.bbox
        return BBox(x0, y0, x1, y1).buffer_degrees(f.distance_m)
    if isinstance(f, ast.And):
        out = _WORLD
        for c in f.children:
            out = out.intersect(extract_bbox(c, geom_attr))
        return out
    if isinstance(f, ast.Or):
        parts = [extract_bbox(c, geom_attr) for c in f.children]
        out = parts[0]
        for p in parts[1:]:
            if p.is_whole_world:
                return _WORLD
            out = out.union(p)
        return out
    if isinstance(f, ast.Exclude):
        return BBox(1, 1, -1, -1)  # empty
    return _WORLD


def extract_intervals(f: ast.Filter, dtg_attr: str) -> Interval:
    """Covering time interval implied by the filter for `dtg_attr`."""

    def leaf(f) -> Interval:
        if isinstance(f, ast.TemporalPredicate) and f.prop.name == dtg_attr:
            if f.op == "DURING":
                return Interval(f.start, f.end)
            if f.op == "BEFORE":
                return Interval(None, f.start)
            if f.op == "AFTER":
                return Interval(f.start, None)
            return Interval(f.start, f.start)  # TEQUALS
        if (
            isinstance(f, ast.Comparison)
            and isinstance(f.left, ast.Property)
            and f.left.name == dtg_attr
            and isinstance(f.right, ast.Literal)
            and f.right.kind == "datetime"
        ):
            v = int(f.right.value)
            if f.op in ("=",):
                return Interval(v, v)
            if f.op in ("<", "<="):
                return Interval(None, v)
            if f.op in (">", ">="):
                return Interval(v, None)
        if isinstance(f, ast.Between) and f.prop.name == dtg_attr:
            if f.lo.kind == "datetime":
                return Interval(int(f.lo.value), int(f.hi.value))
        return _ALL_TIME

    if isinstance(f, ast.And):
        out = _ALL_TIME
        for c in f.children:
            out = out.intersect(extract_intervals(c, dtg_attr))
        return out
    if isinstance(f, ast.Or):
        parts = [extract_intervals(c, dtg_attr) for c in f.children]
        out = parts[0]
        for p in parts[1:]:
            if p.is_unbounded:
                return _ALL_TIME
            out = out.union(p)
        return out
    return leaf(f)
