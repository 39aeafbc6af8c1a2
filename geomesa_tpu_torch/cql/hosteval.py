"""Host f64 filter evaluation over a FeatureBatch.

The counterpart of the reference package's `cql/hosteval.py`: it
re-decides, in f64 NumPy, the rows that the f32 device mask flags inside
the boundary band, so counts and masks are exact against the f64 data.
Point-in-polygon uses the f64 crossing-number oracle with the device
kernels' edge rule; distances use the equirectangular segment distance
and the haversine; extended geometries replay the CSR algorithm of
`engine/geometry.py` feature by feature. The formulas are the
reference's, as they stand.
"""

from __future__ import annotations

import re

import numpy as np

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.engine.geodesy import haversine_m_np, point_to_segments_m_np
from geomesa_tpu_torch.engine.pip import points_in_polygon_np, polygon_edges

_OPS = {
    "=": np.equal, "<>": np.not_equal, "<": np.less,
    "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
}
_SOPS = {
    "=": lambda v, lit: v == lit, "<>": lambda v, lit: v != lit,
    "<": lambda v, lit: v < lit, "<=": lambda v, lit: v <= lit,
    ">": lambda v, lit: v > lit, ">=": lambda v, lit: v >= lit,
}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}


def eval_filter_host(f: ast.Filter, batch: FeatureBatch) -> np.ndarray:
    n = len(batch)
    valid = batch.valid if batch.valid is not None else np.ones(n, bool)
    return _eval(f, batch) & valid


def _strings(batch, name):
    col = batch.columns[name]
    if not isinstance(col, DictColumn):
        raise TypeError(f"{name!r} is not a string column")
    return col.decode()


def like_regex(pattern: str, case_insensitive: bool) -> "re.Pattern":
    """CQL LIKE: % = any run, _ = one char, backslash escapes."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$",
                      re.IGNORECASE if case_insensitive else 0)


def _eval(f: ast.Filter, b: FeatureBatch) -> np.ndarray:
    n = len(b)
    if isinstance(f, ast.Include):
        return np.ones(n, bool)
    if isinstance(f, ast.Exclude):
        return np.zeros(n, bool)
    if isinstance(f, ast.And):
        m = np.ones(n, bool)
        for c in f.children:
            m &= _eval(c, b)
        return m
    if isinstance(f, ast.Or):
        m = np.zeros(n, bool)
        for c in f.children:
            m |= _eval(c, b)
        return m
    if isinstance(f, ast.Not):
        return ~_eval(f.child, b)
    if isinstance(f, ast.Comparison):
        return _eval_cmp(f, b)
    if isinstance(f, ast.Between):
        attr = b.sft.attribute(f.prop.name)
        if attr.type in ("String", "UUID"):
            lo, hi = str(f.lo.value), str(f.hi.value)
            inb = lambda v: lo <= v <= hi  # noqa: E731
            return np.array([v is not None and (not inb(v) if f.negate else inb(v))
                             for v in _strings(b, f.prop.name)], bool)
        col = np.asarray(b.columns[f.prop.name])
        m = (col >= f.lo.value) & (col <= f.hi.value)
        return ~m if f.negate else m
    if isinstance(f, ast.Like):
        rx = like_regex(f.pattern, f.case_insensitive)
        vals = _strings(b, f.prop.name)
        m = np.array([v is not None and rx.match(v) is not None for v in vals], bool)
        if f.negate:
            m = ~m & np.array([v is not None for v in vals], bool)
        return m
    if isinstance(f, ast.In):
        if b.sft.attribute(f.prop.name).type in ("String", "UUID"):
            vals = _strings(b, f.prop.name)
            allowed = {str(v) for v in f.values}
            m = np.array([v is not None and v in allowed for v in vals], bool)
            if f.negate:
                m = ~m & np.array([v is not None for v in vals], bool)
            return m
        col = np.asarray(b.columns[f.prop.name])
        m = np.isin(col, np.array(sorted(float(v) for v in f.values), col.dtype))
        return ~m if f.negate else m
    if isinstance(f, ast.IsNull):
        attr = b.sft.attribute(f.prop.name)
        if attr.type in ("String", "UUID"):
            m = np.array([v is None for v in _strings(b, f.prop.name)], bool)
        elif attr.type in ("Double", "Float"):
            m = np.isnan(np.asarray(b.columns[f.prop.name], np.float64))
        else:
            m = np.zeros(n, bool)
        return ~m if f.negate else m
    if isinstance(f, ast.TemporalPredicate):
        t = np.asarray(b.columns[f.prop.name], np.int64)
        if f.op == "DURING":
            return (t > f.start) & (t < f.end)
        if f.op == "BEFORE":
            return t < f.start
        if f.op == "AFTER":
            return t > f.start
        return t == f.start
    if isinstance(f, ast.SpatialPredicate):
        return _eval_spatial(f, b)
    if isinstance(f, ast.DistancePredicate):
        return _eval_distance(f, b)
    raise NotImplementedError(type(f).__name__)


def _eval_cmp(f: ast.Comparison, b: FeatureBatch) -> np.ndarray:
    left, right, op = f.left, f.right, f.op
    if isinstance(left, ast.Literal):
        left, right, op = right, left, _FLIP[op]
    attr = b.sft.attribute(left.name)
    if isinstance(right, ast.Property):
        return _OPS[op](np.asarray(b.columns[left.name]),
                        np.asarray(b.columns[right.name]))
    if attr.type in ("String", "UUID"):
        lit = str(right.value)
        return np.array([v is not None and _SOPS[op](v, lit)
                         for v in _strings(b, left.name)], bool)
    return _OPS[op](np.asarray(b.columns[left.name]), right.value)


def _eval_spatial(f: ast.SpatialPredicate, b: FeatureBatch) -> np.ndarray:
    col: GeometryColumn = b.columns[f.prop.name]
    n = len(b)
    g = f.geometry
    if col.is_point:
        x, y = col.x, col.y
        if f.op == "BBOX":
            x0, y0, x1, y1 = g.bbox
            return (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        if f.op in ("INTERSECTS", "WITHIN", "DISJOINT"):
            m = _point_intersects_np(x, y, g)
            return ~m if f.op == "DISJOINT" else m
        if f.op in ("EQUALS", "CONTAINS"):
            if g.kind in ("Point", "MultiPoint"):
                return _coincident_np(x, y, np.concatenate(g.rings, axis=0))
            return np.zeros(n, bool)
        if f.op in ("OVERLAPS", "CROSSES"):
            return np.zeros(n, bool)
        if f.op == "TOUCHES":
            if g.kind in ("Point", "MultiPoint"):
                return np.zeros(n, bool)  # points have no boundary
            return _dist_to_segments_np(x, y, g) <= 0.5
        raise NotImplementedError(f.op)
    # extended geometries: the CSR algorithm in plain loops
    out = np.zeros(n, bool)
    for i in range(n):
        out[i] = _geom_predicate_np(f.op, col.geometry(i), g)
    return out


def _coincident_np(x, y, pts) -> np.ndarray:
    m = np.zeros(len(x), bool)
    for px, py in pts:
        m |= (x == px) & (y == py)
    return m


def _point_intersects_np(x, y, g):
    if g.kind in ("Point", "MultiPoint"):
        return _coincident_np(x, y, _poly_vertices(g))
    if g.kind in ("LineString", "MultiLineString"):
        return _dist_to_segments_np(x, y, g) <= 0.5
    return points_in_polygon_np(x, y, g)


def _dist_to_segments_np(px, py, g):
    x1, y1, x2, y2 = polygon_edges(g)
    if len(x1) == 0:  # point-cloud literal: degenerate segments
        pts = _poly_vertices(g)
        x1 = x2 = pts[:, 0]
        y1 = y2 = pts[:, 1]
    return point_to_segments_m_np(px, py, x1, y1, x2, y2)


def _poly_vertices(g):
    return np.concatenate(g.rings, axis=0) if g.rings else np.zeros((0, 2))


def _segments_cross(g1, g2) -> bool:
    ax1, ay1, ax2, ay2 = polygon_edges(g1)
    bx1, by1, bx2, by2 = polygon_edges(g2)
    if len(ax1) == 0 or len(bx1) == 0:
        return False

    def cross(ox, oy, px, py, qx, qy):
        return (px - ox) * (qy - oy) - (py - oy) * (qx - ox)
    d1 = cross(bx1[None], by1[None], bx2[None], by2[None], ax1[:, None], ay1[:, None])
    d2 = cross(bx1[None], by1[None], bx2[None], by2[None], ax2[:, None], ay2[:, None])
    d3 = cross(ax1[:, None], ay1[:, None], ax2[:, None], ay2[:, None], bx1[None], by1[None])
    d4 = cross(ax1[:, None], ay1[:, None], ax2[:, None], ay2[:, None], bx2[None], by2[None])
    return bool(np.any(((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))))


def _geom_predicate_np(op, a, lit) -> bool:
    av = _poly_vertices(a)
    lv = _poly_vertices(lit)
    poly_lit = lit.kind in ("Polygon", "MultiPolygon")
    poly_a = a.kind in ("Polygon", "MultiPolygon")
    a_in_lit = (points_in_polygon_np(av[:, 0], av[:, 1], lit)
                if poly_lit and len(av) else np.zeros(len(av), bool))
    lit_in_a = (points_in_polygon_np(lv[:, 0], lv[:, 1], a)
                if poly_a and len(lv) else np.zeros(len(lv), bool))
    crossings = _segments_cross(a, lit)
    ax0, ay0, ax1, ay1 = a.bbox
    lx0, ly0, lx1, ly1 = lit.bbox
    bbox_overlap = ax0 <= lx1 and ax1 >= lx0 and ay0 <= ly1 and ay1 >= ly0
    intersects = bbox_overlap and (
        bool(a_in_lit.any()) or bool(lit_in_a.any()) or crossings)
    within = (bool(len(av)) and bool(a_in_lit.all()) and not crossings
              and not bool(lit_in_a.any()))
    contains = (bool(len(lv)) and bool(lit_in_a.all()) and not crossings
                and not bool(a_in_lit.any()))
    if op == "BBOX":
        return bbox_overlap
    if op == "INTERSECTS":
        return intersects
    if op == "DISJOINT":
        return not intersects
    if op == "WITHIN":
        return within
    if op == "CONTAINS":
        return contains
    if op == "EQUALS":
        return within and contains
    if op == "OVERLAPS":
        return intersects and not within and not contains
    if op == "CROSSES":
        return crossings or (bool(a_in_lit.any()) and not bool(a_in_lit.all()))
    if op == "TOUCHES":
        return (bbox_overlap and not bool(a_in_lit.any())
                and not bool(lit_in_a.any()) and crossings)
    raise NotImplementedError(op)


def _eval_distance(f: ast.DistancePredicate, b: FeatureBatch) -> np.ndarray:
    col: GeometryColumn = b.columns[f.prop.name]
    g = f.geometry
    d = f.distance_m
    if col.is_point:
        if g.kind in ("Point", "MultiPoint") and sum(len(r) for r in g.rings) == 1:
            px, py = g.point
            m = haversine_m_np(col.x, col.y, px, py) <= d
        else:
            m = _dist_to_segments_np(col.x, col.y, g) <= d
            if g.kind in ("Polygon", "MultiPolygon"):
                m |= points_in_polygon_np(col.x, col.y, g)
    else:
        n = len(b)
        m = np.zeros(n, bool)
        for i in range(n):
            fi = col.geometry(i)
            fv = _poly_vertices(fi)
            vd = _dist_to_segments_np(fv[:, 0], fv[:, 1], g)
            m[i] = bool((vd <= d).any()) or _geom_predicate_np("INTERSECTS", fi, g)
    if f.op == "BEYOND":
        return ~m
    return m
