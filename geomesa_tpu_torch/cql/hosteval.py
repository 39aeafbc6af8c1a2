"""Host f64 filter evaluation over a FeatureBatch.

The counterpart of the reference package's `cql/hosteval.py` for the
predicates the port compiles: it re-decides, in f64 NumPy, the rows
that the f32 device mask flags inside the boundary band, so counts and
masks are exact against the f64 data. Point-in-polygon uses the f64
crossing-number oracle with the device kernels' edge rule. Distance and
extended-geometry predicates come with their slices.
"""

from __future__ import annotations

import re

import numpy as np

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.engine.pip import points_in_polygon_np
from geomesa_tpu_torch.errors import NotPortedError

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
    if isinstance(f, ast.SpatialPredicate) and f.op == "BBOX":
        col = b.columns[f.prop.name]
        x0, y0, x1, y1 = f.geometry.bbox
        return (col.x >= x0) & (col.x <= x1) & (col.y >= y0) & (col.y <= y1)
    if (isinstance(f, ast.SpatialPredicate)
            and f.op in ("INTERSECTS", "WITHIN", "DISJOINT")
            and "Polygon" in f.geometry.kind):
        col = b.columns[f.prop.name]
        m = points_in_polygon_np(col.x, col.y, f.geometry)
        return ~m if f.op == "DISJOINT" else m
    raise NotPortedError(f"host evaluation of {type(f).__name__}",
                         "the distance-predicate slice")


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
