"""Predicate compiler: filter AST -> mask function over device tensors.

The counterpart of the reference package's `cql/compile.py`. The filter's
structure becomes a tree of closures over the device columns (PyTorch
runs eagerly, so there is nothing to trace); per-batch values (the
dictionary-code "allowed" tables of string predicates) are built on the
host and passed as params.

Comparisons keep the reference's numeric semantics: a literal against an
f32 column compares in f32, against an f64 (Double) column in f64, and an
integer column against a fractional literal in f64 (the reference's
weak-typed scalars under x64).

Null semantics: dictionary code -1 = null; any comparison on null is
False. NaN counts as null for IS NULL on floating columns.

Rows whose f32 coordinates sit within the ulp band of a BBOX edge (or the
ambiguity band of a polygon's edges) can land on the other side of the
edge than their f64 values. Three routes re-decide them in f64 on the
host: `band_corrections` returns them with their exact membership, for
the caller to scatter into a device mask; `refine` patches a fetched host
mask (`mask_refined` fetches and patches); `band_count_correction`
corrects a device count. Each takes an
`extra` device mask (the partition allowance) that is ANDed into the band
before anything is fetched.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.cql.hosteval import eval_filter_host, like_regex
from geomesa_tpu_torch.engine.device import (
    VALID, DeviceBatch, DeviceTables, fetch, upload)
from geomesa_tpu_torch.engine.geodesy import haversine_m, within_segments_m
from geomesa_tpu_torch.engine.pip import (
    points_in_polygon, points_in_polygon_band, polygon_edges)

ParamBuilder = Callable[[FeatureBatch], np.ndarray]


def f32_ulp_band(bound: float) -> np.float32:
    """Half-width of the f32 ambiguity band around a comparison bound:
    values whose f32 rounding can land on the other side of `bound`
    (4x the half-ulp covers the coordinate and the operand)."""
    return np.float32(max(abs(bound), 1.0) * 2.0 ** -24 * 4)


class CompiledFilter:
    """A compiled filter: `mask(dev, batch)` -> bool [N] device tensor."""

    def __init__(self, fn, builders: Dict[str, ParamBuilder], cql: str,
                 filter_ast=None, band_fn=None):
        self._fn = fn
        self.builders = builders
        self.cql = cql
        self.filter_ast = filter_ast
        self._band_fn = band_fn

    def params(self, dev: DeviceBatch, batch: FeatureBatch
               ) -> Dict[str, torch.Tensor]:
        device = dev[VALID].device
        return {k: upload(b(batch), device) for k, b in self.builders.items()}

    def mask(self, dev: DeviceBatch, batch: FeatureBatch) -> torch.Tensor:
        return self._fn(self.params(dev, batch), dev)

    @property
    def has_band(self) -> bool:
        return self._band_fn is not None

    def band(self, dev: DeviceBatch, batch: FeatureBatch) -> torch.Tensor:
        """Boundary-ambiguity flags [N]."""
        if self._band_fn is None:
            raise ValueError("filter has no boundary band")
        return self._band_fn(self.params(dev, batch), dev)

    def _band_rows(self, dev: DeviceBatch, batch: FeatureBatch, extra=None):
        """The band's row indices on the device (ascending), with `extra`
        ANDed into the band first: one device pass, no fetch."""
        b = self.band(dev, batch)
        if extra is not None:
            b = b & extra
        return torch.nonzero(b).flatten()

    def refine(self, mask: np.ndarray, dev: DeviceBatch, batch: FeatureBatch,
               extra=None) -> np.ndarray:
        """Patch an already-fetched host mask: the rows of the f32 boundary
        band are re-evaluated in f64 on the host. `extra` (a device bool
        mask the caller already ANDed into `mask`, such as the partition
        allowance) is ANDed into the band first, so rows outside it keep
        their value and are never re-evaluated. No-op without a band."""
        if self._band_fn is None or self.filter_ast is None:
            return mask
        (idx,) = fetch(self._band_rows(dev, batch, extra))
        if not len(idx):
            return mask
        mask = mask.copy()
        mask[idx] = eval_filter_host(self.filter_ast, batch.select(idx))
        return mask

    def mask_refined(self, dev: DeviceBatch, batch: FeatureBatch) -> np.ndarray:
        """The host mask with the f32 boundary band's rows re-evaluated
        exactly in f64 (`refine` over the fetched device mask)."""
        (mask,) = fetch(self.mask(dev, batch))
        return self.refine(mask, dev, batch)

    def band_count_correction(self, dev: DeviceBatch, batch: FeatureBatch,
                              m=None, extra=None) -> int:
        """(exact - approximate) match count over the band rows: add it to
        the device count of `m` (the filter mask ANDed with `extra`;
        computed here when None) to make that count f64-exact. `extra` is
        ANDed into the band on the device before anything is fetched, so
        only its rows are re-evaluated on the host. One device pass and
        one small fetch (the band rows and their approximate count)."""
        if self._band_fn is None or self.filter_ast is None:
            return 0
        if m is None:
            m = self.mask(dev, batch)
            if extra is not None:
                m = m & extra
        at = self._band_rows(dev, batch, extra)
        idx, approx = fetch(at, m[at].sum(dtype=torch.int64))
        if not len(idx):
            return 0
        exact = int(eval_filter_host(self.filter_ast, batch.select(idx)).sum())
        return exact - int(approx)

    def band_corrections(self, dev: DeviceBatch, batch: FeatureBatch,
                         extra=None):
        """Exact f64 membership of the rows inside the f32 boundary band
        (ANDed with `extra` on the device when given), as (idx int64 [m]
        ascending, exact bool [m]). The caller scatters `exact` (ANDed
        with any per-row components it owns) into its device mask at
        `idx`."""
        empty = (np.zeros(0, np.int64), np.zeros(0, bool))
        if self._band_fn is None or self.filter_ast is None:
            return empty
        (idx,) = fetch(self._band_rows(dev, batch, extra))
        if not len(idx):
            return empty
        idx = idx.astype(np.int64)
        exact = np.asarray(
            eval_filter_host(self.filter_ast, batch.select(idx)), bool)
        return idx, exact

    def __repr__(self):
        return f"CompiledFilter({self.cql!r})"


def compile_filter(f: ast.Filter, sft: SimpleFeatureType) -> CompiledFilter:
    builders: Dict[str, ParamBuilder] = {}
    counter = [0]
    bands: List = []
    fn = _compile(f, sft, builders, counter, bands)

    def top(params, dev):
        return fn(params, dev) & dev[VALID]

    band_fn = None
    if bands:
        def band_fn(params, dev, _bands=tuple(bands)):
            m = _bands[0](params, dev)
            for g in _bands[1:]:
                m = m | g(params, dev)
            return m & dev[VALID]

    return CompiledFilter(top, builders, ast.to_cql(f), f, band_fn)


# -- helpers ---------------------------------------------------------------


def _key(counter: List[int]) -> str:
    counter[0] += 1
    return f"p{counter[0]}"


def _attr(sft: SimpleFeatureType, name: str):
    if name not in sft:
        raise ValueError(f"unknown attribute {name!r} in filter (sft {sft.name!r})")
    return sft.attribute(name)


def _allowed_table(name: str, pred: Callable[[str], bool]) -> ParamBuilder:
    """Builder producing a bool table over the batch's vocab for `name`."""

    def build(batch: FeatureBatch) -> np.ndarray:
        col = batch.columns[name]
        if not isinstance(col, DictColumn):
            raise TypeError(f"{name!r} is not a string column")
        if not col.vocab:
            return np.zeros(1, dtype=bool)
        return np.array([pred(v) for v in col.vocab], dtype=bool)

    return build


def _gather_allowed(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(codes, 0, table.shape[0] - 1).long()
    return torch.where(codes >= 0, table[safe], torch.zeros_like(codes, dtype=torch.bool))


def _operands(col: torch.Tensor, value):
    """(column, literal) in the dtype the reference compares them in."""
    if (isinstance(value, float) and not col.dtype.is_floating_point
            and col.dtype != torch.bool):
        return col.double(), value
    return col, value


_NUM_OPS = {
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_STR_OPS = {
    "=": lambda v, lit: v == lit,
    "<>": lambda v, lit: v != lit,
    "<": lambda v, lit: v < lit,
    "<=": lambda v, lit: v <= lit,
    ">": lambda v, lit: v > lit,
    ">=": lambda v, lit: v >= lit,
}


def _ones(dev):
    return torch.ones_like(dev[VALID])


def _zeros(dev):
    return torch.zeros_like(dev[VALID])


# -- node compilation ------------------------------------------------------


def _compile(f: ast.Filter, sft, builders, counter, bands=None):
    if isinstance(f, ast.Include):
        return lambda params, dev: _ones(dev)
    if isinstance(f, ast.Exclude):
        return lambda params, dev: _zeros(dev)
    if isinstance(f, (ast.And, ast.Or)):
        fns = [_compile(c, sft, builders, counter, bands) for c in f.children]
        is_and = isinstance(f, ast.And)

        def combine(params, dev):
            m = fns[0](params, dev)
            for g in fns[1:]:
                m = (m & g(params, dev)) if is_and else (m | g(params, dev))
            return m
        return combine
    if isinstance(f, ast.Not):
        g = _compile(f.child, sft, builders, counter, bands)
        return lambda params, dev: ~g(params, dev)
    if isinstance(f, ast.Comparison):
        return _compile_comparison(f, sft, builders, counter)
    if isinstance(f, ast.Between):
        a = _attr(sft, f.prop.name)
        neg = f.negate
        if a.type in ("String", "UUID"):
            lo, hi = str(f.lo.value), str(f.hi.value)
            k = _key(counter)
            pred = (lambda v: not lo <= v <= hi) if neg else (lambda v: lo <= v <= hi)
            builders[k] = _allowed_table(a.name, pred)
            return lambda params, dev, k=k, n=a.name: _gather_allowed(params[k], dev[n])
        lo = _literal_value(f.lo, a)
        hi = _literal_value(f.hi, a)

        def between(params, dev, n=a.name):
            c, lo_ = _operands(dev[n], lo)
            c, hi_ = _operands(c, hi)
            m = (c >= lo_) & (c <= hi_)
            return ~m if neg else m
        return between
    if isinstance(f, ast.Like):
        a = _attr(sft, f.prop.name)
        if a.type not in ("String", "UUID"):
            raise ValueError(f"LIKE on non-string attribute {a.name!r}")
        rx = like_regex(f.pattern, f.case_insensitive)
        k = _key(counter)
        builders[k] = _allowed_table(a.name, lambda v: rx.match(v) is not None)
        neg = f.negate

        def like(params, dev, k=k, n=a.name):
            m = _gather_allowed(params[k], dev[n])
            return ~m & (dev[n] >= 0) if neg else m
        return like
    if isinstance(f, ast.In):
        a = _attr(sft, f.prop.name)
        neg = f.negate
        if a.type in ("String", "UUID"):
            vals = {str(v) for v in f.values}
            k = _key(counter)
            builders[k] = _allowed_table(a.name, lambda v: v in vals)

            def isin(params, dev, k=k, n=a.name):
                m = _gather_allowed(params[k], dev[n])
                return ~m & (dev[n] >= 0) if neg else m
            return isin
        vals = np.array(sorted(float(v) for v in f.values))

        def isin_num(params, dev, n=a.name):
            col = dev[n]
            m = torch.isin(col, torch.as_tensor(vals, device=col.device).to(col.dtype))
            return ~m if neg else m
        return isin_num
    if isinstance(f, ast.IsNull):
        a = _attr(sft, f.prop.name)
        neg = f.negate
        if a.type in ("String", "UUID"):
            def isnull(params, dev, n=a.name):
                m = dev[n] < 0
                return ~m if neg else m
            return isnull
        if a.type in ("Double", "Float"):
            def isnan(params, dev, n=a.name):
                m = torch.isnan(dev[n])
                return ~m if neg else m
            return isnan
        # int/temporal columns have no null representation on device
        return lambda params, dev: _ones(dev) if neg else _zeros(dev)
    if isinstance(f, ast.TemporalPredicate):
        a = _attr(sft, f.prop.name)
        if not a.is_temporal:
            raise ValueError(f"temporal predicate on non-date attribute {a.name!r}")
        n = a.name
        s, e = int(f.start), (int(f.end) if f.end is not None else None)
        if f.op == "DURING":
            return lambda params, dev: (dev[n] > s) & (dev[n] < e)
        if f.op == "BEFORE":
            return lambda params, dev: dev[n] < s
        if f.op == "AFTER":
            return lambda params, dev: dev[n] > s
        return lambda params, dev: dev[n] == s  # TEQUALS
    if isinstance(f, ast.SpatialPredicate):
        return _compile_spatial(f, sft, bands)
    if isinstance(f, ast.DistancePredicate):
        return _compile_distance(f, sft)
    raise NotImplementedError(f"cannot compile {type(f).__name__}")


def _literal_value(lit: ast.Literal, attr):
    if attr.is_temporal:
        if lit.kind != "datetime":
            raise ValueError(f"non-datetime literal for {attr.name!r}")
        return int(lit.value)
    return lit.value


def _compile_comparison(f: ast.Comparison, sft, builders, counter):
    # normalize: Property op Expr
    left, right, op = f.left, f.right, f.op
    if isinstance(left, ast.Literal) and isinstance(right, ast.Property):
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}
        left, right, op = right, left, flip[op]
    if not isinstance(left, ast.Property):
        raise ValueError("comparison requires at least one property operand")
    a = _attr(sft, left.name)
    fn = _NUM_OPS[op]

    if isinstance(right, ast.Property):
        b = _attr(sft, right.name)
        if a.type in ("String", "UUID") or b.type in ("String", "UUID"):
            raise NotImplementedError("string property-to-property comparison")
        return lambda params, dev: fn(dev[a.name], dev[b.name])

    if a.type in ("String", "UUID"):
        lit = str(right.value)
        pred = _STR_OPS[op]
        k = _key(counter)
        builders[k] = _allowed_table(a.name, lambda v: pred(v, lit))
        return lambda params, dev, k=k, n=a.name: _gather_allowed(params[k], dev[n])

    v = _literal_value(right, a)
    return lambda params, dev: fn(*_operands(dev[a.name], v))


# -- spatial ---------------------------------------------------------------


def _compile_spatial(f: ast.SpatialPredicate, sft, bands=None):
    a = _attr(sft, f.prop.name)
    if not a.is_geometry:
        raise ValueError(f"spatial predicate on non-geometry {a.name!r}")
    if a.type != "Point":
        from geomesa_tpu_torch.engine.geometry import compile_extended_spatial

        return compile_extended_spatial(f, a.name, a.type)
    n = a.name
    g = f.geometry
    op = f.op
    if op == "BBOX":
        return _bbox(n, g.bbox, bands)
    if op in ("INTERSECTS", "WITHIN", "DISJOINT"):
        base = _point_intersects(n, g, bands)
        if op == "DISJOINT":
            return lambda params, dev: ~base(params, dev)
        return base
    if op in ("EQUALS", "CONTAINS"):
        # a point can only equal/contain a coincident point literal
        if g.kind in ("Point", "MultiPoint"):
            return _coincident(n, np.concatenate(g.rings, axis=0))
        return lambda params, dev: _zeros(dev)
    if op == "TOUCHES":
        # a point touches an area/line iff it lies on the boundary; a point
        # literal has no boundary, so nothing can touch it (DE-9IM)
        segs = DeviceTables(polygon_edges(g))
        if len(segs.host[0]) == 0:
            return lambda params, dev: _zeros(dev)
        return _near_segments(n, segs, 0.5)  # half a meter (f32 floor)
    if op in ("OVERLAPS", "CROSSES"):
        # DE-9IM: a point can never overlap or cross anything
        return lambda params, dev: _zeros(dev)
    raise NotImplementedError(f"spatial op {op}")


def _bbox(n: str, box, bands=None):
    x0, y0, x1, y1 = box

    def bbox(params, dev):
        X = dev[f"{n}__x"]
        Y = dev[f"{n}__y"]
        return (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)

    if bands is not None:
        # coordinates within the ulp band of a bbox edge can flip sides
        # on the f32 device column: flag them for f64 host refinement
        ex0, ex1 = float(f32_ulp_band(x0)), float(f32_ulp_band(x1))
        ey0, ey1 = float(f32_ulp_band(y0)), float(f32_ulp_band(y1))

        def bbox_band(params, dev):
            X = dev[f"{n}__x"]
            Y = dev[f"{n}__y"]
            return (
                (torch.abs(X - x0) <= ex0) | (torch.abs(X - x1) <= ex1)
                | (torch.abs(Y - y0) <= ey0) | (torch.abs(Y - y1) <= ey1)
            )

        bands.append(bbox_band)
    return bbox


def _coincident(n: str, pts: np.ndarray):
    """Rows whose point equals one of `pts` (compared in the column's
    dtype, the literal rounded to it as the reference's weak scalars)."""
    pts = [(float(px), float(py)) for px, py in pts]

    def eq(params, dev):
        X = dev[f"{n}__x"]
        Y = dev[f"{n}__y"]
        m = _zeros(dev)
        for px, py in pts:
            m = m | ((X == px) & (Y == py))
        return m
    return eq


def _near_segments(n: str, segs: DeviceTables, d: float):
    """Rows within `d` meters of the segment table (equirectangular)."""
    def near(params, dev):
        X = dev[f"{n}__x"]
        return within_segments_m(X, dev[f"{n}__y"], *segs.on(X.device), d)
    return near


def _point_intersects(n: str, g, bands=None):
    """INTERSECTS/WITHIN of a point column against a geometry literal:
    coincidence with a Point or MultiPoint, within half a meter of a
    LineString, else the even-odd crossing test over the polygon's f32
    edge table (kernel B4), with its ambiguity band (kernel B5) appended
    to `bands` for the f64 host refine."""
    if g.kind in ("Point", "MultiPoint"):
        pts = np.concatenate(g.rings, axis=0) if g.rings else np.zeros((0, 2))
        return _coincident(n, pts)
    if g.kind in ("LineString", "MultiLineString"):
        return _near_segments(n, DeviceTables(polygon_edges(g)), 0.5)
    edges = DeviceTables(polygon_edges(g), np.float32)

    def pip(params, dev):
        X = dev[f"{n}__x"]
        return points_in_polygon(X, dev[f"{n}__y"], *edges.on(X.device))

    if bands is not None:
        def band(params, dev):
            X = dev[f"{n}__x"]
            return points_in_polygon_band(X, dev[f"{n}__y"], *edges.on(X.device))

        bands.append(band)
    return pip


def _compile_distance(f: ast.DistancePredicate, sft):
    """DWITHIN/BEYOND: the haversine for a single point literal, else the
    equirectangular distance to the literal's segments (a point cloud's
    points as degenerate segments), ORed with the polygon test for a
    polygon literal. No f32 band, as in the reference."""
    a = _attr(sft, f.prop.name)
    if a.type != "Point":
        from geomesa_tpu_torch.engine.geometry import compile_extended_spatial

        return compile_extended_spatial(f, a.name, a.type)
    n = a.name
    g = f.geometry
    d = float(f.distance_m)

    if g.kind in ("Point", "MultiPoint") and sum(len(r) for r in g.rings) == 1:
        px, py = (float(v) for v in g.point)

        def base(params, dev):
            return haversine_m(dev[f"{n}__x"], dev[f"{n}__y"], px, py) <= d
    else:
        x1e, y1e, x2e, y2e = polygon_edges(g)
        if len(x1e) == 0:  # point-cloud literal: degenerate segments
            pts = np.concatenate(g.rings, axis=0)
            x1e = x2e = pts[:, 0]
            y1e = y2e = pts[:, 1]
        near = _near_segments(n, DeviceTables((x1e, y1e, x2e, y2e)), d)
        inside = (_point_intersects(n, g)
                  if g.kind in ("Polygon", "MultiPolygon") else None)

        def base(params, dev):
            m = near(params, dev)
            if inside is not None:
                m = m | inside(params, dev)
            return m

    if f.op == "BEYOND":
        return lambda params, dev: ~base(params, dev)
    return base
