"""Extended-geometry (CSR) spatial predicates against a literal geometry.

The counterpart of the reference package's `engine/geometry.py`: JTS
geometry predicates over non-point columns, as dense edge and vertex
tables reduced per feature id, with no per-feature control flow:

  INTERSECTS(feature, L) = any feature vertex in L
                         | any L vertex inside feature
                         | any (feature edge x L edge) proper crossing
  WITHIN(feature, L)     = all feature vertices in L
                         & no proper edge crossings
                         & no L vertex inside feature
  CONTAINS(feature, L)   = the mirror image of WITHIN
  DISJOINT               = ~INTERSECTS; BBOX = envelope overlap test

EQUALS, OVERLAPS, CROSSES and TOUCHES are the reference's approximations
from the same primitives, unchanged (noted inline).

The columns are the extended device keys of `engine/device.py`
(`__verts`, `__vfeat`, `__ex1`..`__ey2`, `__efeat`, `__bbox`). The
literal's edge and vertex tables stay f64, as in the reference, so the
[E, L] passes run in the promoted dtype of the column and the literal.
"Feature vertex in L" is the port's `points_in_polygon` (kernel B4 on the
card, f32). The [E, L] passes are chunked over data edges and literal
vertices so that each [chunk, L] temporary and each [N, L] parity count
holds at most `PAIR_BUDGET_BYTES`; a chunk's result is an OR (or an
AND) and a parity sum, so the answer does not depend on the chunking
(the tests shrink the budget and widen `PRUNE_PAD` to hold that).

Data edges that cannot contribute are skipped before the [E, L] passes:
- the literal-vertex parity skips edges whose y-span holds no literal
  vertex's y (the half-open straddle test is an exact comparison, False
  for every literal vertex) and edges left of every literal vertex by
  more than `PRUNE_PAD` (their crossing x stays within rounding of their
  own x-span, so it is never right of a literal vertex). Both are exact;
- the proper-crossing test skips edges whose bounding box lies farther
  than `PRUNE_PAD` outside the literal's: two segments with separated
  boxes do not cross, and the computed orientations could only both
  straddle for four points collinear to within f64 rounding. The tests
  hold the skipped edges False in the reference's formula
  (`tests/test_torch_geometry.py`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from geomesa_tpu_torch.core.wkt import Geometry
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.engine.device import VALID, DeviceTables
from geomesa_tpu_torch.engine.geodesy import within_segments_m
from geomesa_tpu_torch.engine.pip import points_in_polygon, polygon_edges

# bytes of one [chunk, L] temporary, and of one [N, L] parity count
PAIR_BUDGET_BYTES = 1 << 28
# degrees: a skipped edge lies at least this far outside what it is
# tested against, far above the f64 arithmetic's rounding
PRUNE_PAD = 1e-4


def _literal_arrays(g: Geometry):
    """Host f64: ((x1, y1, x2, y2) edges, vertex xs, vertex ys)."""
    edges = polygon_edges(g)
    verts = np.concatenate(g.rings, axis=0) if g.rings else np.zeros((0, 2))
    return edges, np.ascontiguousarray(verts[:, 0], np.float64), \
        np.ascontiguousarray(verts[:, 1], np.float64)


def _cross(ox, oy, ax, ay, bx, by):
    return (ax - ox) * (by - oy) - (ay - oy) * (bx - ox)


def _any_by_feature(values: torch.Tensor, feat: torch.Tensor, n: int) -> torch.Tensor:
    """OR-reduce a per-edge/vertex bool array into per-feature bools."""
    acc = torch.zeros(n, dtype=torch.int32, device=values.device)
    acc.index_add_(0, feat.long(), values.to(torch.int32))
    return acc > 0


def _step(width: int, itemsize: int) -> int:
    """Rows of a [rows, width] chunk that fit PAIR_BUDGET_BYTES."""
    return max(1, PAIR_BUDGET_BYTES // (max(width, 1) * itemsize))


def _itemsize(*tensors) -> int:
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.empty(0, dtype=dt).element_size()


def edge_crossings(ex1, ey1, ex2, ey2, efeat, n: int, lit_edges) -> torch.Tensor:
    """[N]: does any data edge properly cross any literal edge. Chunked
    over the data edges whose box comes within PRUNE_PAD of the
    literal's (module docstring)."""
    lx1, ly1, lx2, ly2 = (a[None, :] for a in lit_edges)
    e, L = ex1.shape[0], lx1.shape[1]
    hit = torch.zeros(e, dtype=torch.bool, device=ex1.device)
    if L == 0 or e == 0:
        return torch.zeros(n, dtype=torch.bool, device=ex1.device)
    f64 = torch.float64
    xlo = float(torch.minimum(lx1.min(), lx2.min())) - PRUNE_PAD
    xhi = float(torch.maximum(lx1.max(), lx2.max())) + PRUNE_PAD
    ylo = float(torch.minimum(ly1.min(), ly2.min())) - PRUNE_PAD
    yhi = float(torch.maximum(ly1.max(), ly2.max())) + PRUNE_PAD
    keep = torch.nonzero(
        (torch.maximum(ex1, ex2).to(f64) >= xlo)
        & (torch.minimum(ex1, ex2).to(f64) <= xhi)
        & (torch.maximum(ey1, ey2).to(f64) >= ylo)
        & (torch.minimum(ey1, ey2).to(f64) <= yhi)).flatten()
    step = _step(L, _itemsize(ex1, lx1))
    for s in range(0, keep.shape[0], step):
        idx = keep[s:s + step]
        a1, b1 = ex1[idx, None], ey1[idx, None]
        a2, b2 = ex2[idx, None], ey2[idx, None]
        d1 = _cross(lx1, ly1, lx2, ly2, a1, b1)
        d2 = _cross(lx1, ly1, lx2, ly2, a2, b2)
        d3 = _cross(a1, b1, a2, b2, lx1, ly1)
        d4 = _cross(a1, b1, a2, b2, lx2, ly2)
        proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
        hit[idx] = proper.any(dim=1)
    return _any_by_feature(hit, efeat, n)


def literal_vertex_parity(ex1, ey1, ex2, ey2, efeat, n: int, lvx, lvy,
                          reduce_all: bool) -> torch.Tensor:
    """[N]: is any (reduce_all: every) literal vertex inside the data
    feature, by the crossing-number parity of the feature's edges.
    Chunked over literal vertices (the [N, Lc] count) and data edges (the
    [C, Lc] temporaries)."""
    device = ex1.device
    L = lvx.shape[0]
    out = torch.full((n,), reduce_all, dtype=torch.bool, device=device)
    if L == 0:
        return out
    lstep = _step(n, 4)
    for ls in range(0, L, lstep):
        px = lvx[ls:ls + lstep][None, :]
        py = lvy[ls:ls + lstep][None, :]
        lc = px.shape[1]
        # exact skips (module docstring): the y-span misses every literal
        # vertex's y, or the edge lies left of every literal vertex
        lo = torch.minimum(ey1, ey2).to(py.dtype)
        hi = torch.maximum(ey1, ey2).to(py.dtype)
        right = torch.maximum(ex1, ex2).to(px.dtype)
        keep = torch.nonzero((hi > py.min()) & (lo <= py.max())
                             & (right >= float(px.min()) - PRUNE_PAD)).flatten()
        counts = torch.zeros((n, lc), dtype=torch.int32, device=device)
        step = _step(lc, _itemsize(ex1, px))
        for s in range(0, keep.shape[0], step):
            idx = keep[s:s + step]
            a1, b1 = ex1[idx, None], ey1[idx, None]
            a2, b2 = ex2[idx, None], ey2[idx, None]
            cond = (b1 <= py) != (b2 <= py)
            t = (py - b1) / torch.where(b2 == b1, torch.ones_like(b1), b2 - b1)
            xc = a1 + t * (a2 - a1)
            counts.index_add_(0, efeat[idx].long(),
                              (cond & (xc > px)).to(torch.int32))
        inside = (counts % 2) == 1
        if reduce_all:
            out &= inside.all(dim=1)
        else:
            out |= inside.any(dim=1)
    return out


class _Parts:
    """One mask call's columns and its memoized primitives (the reference
    gets the sharing from jit's common-subexpression elimination)."""

    def __init__(self, dev, name: str, lit: DeviceTables, poly_literal: bool,
                 data_is_poly: bool):
        x = dev[f"{name}__x"]
        self.n = x.shape[0]
        verts = dev[f"{name}__verts"]
        self.vx, self.vy = verts[:, 0], verts[:, 1]
        self.vfeat = dev[f"{name}__vfeat"]
        self.edges = tuple(dev[f"{name}__{k}"] for k in ("ex1", "ey1", "ex2", "ey2"))
        self.efeat = dev[f"{name}__efeat"]
        self.bbox = dev[f"{name}__bbox"]
        *self.lit_edges, self.lvx, self.lvy = lit.on(x.device)
        self.poly_literal = poly_literal
        self.data_is_poly = data_is_poly
        self._memo: dict = {}

    def _get(self, key, fn):
        got = self._memo.get(key)
        if got is None:
            got = self._memo[key] = fn()
        return got

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.n, dtype=torch.bool, device=self.vx.device)

    def vertex_in_literal(self) -> torch.Tensor:
        """[V] data vertices inside the polygon literal (B4)."""
        return self._get("vin", lambda: points_in_polygon(
            self.vx, self.vy, *self.lit_edges))

    def vertex_in_literal_any(self) -> torch.Tensor:
        if not self.poly_literal:
            return self.zeros()
        return self._get("vany", lambda: _any_by_feature(
            self.vertex_in_literal(), self.vfeat, self.n))

    def vertex_in_literal_all(self) -> torch.Tensor:
        if not self.poly_literal:
            return self.zeros()

        def all_in():
            has_out = _any_by_feature(~self.vertex_in_literal(), self.vfeat, self.n)
            counts = torch.zeros(self.n, dtype=torch.int32, device=self.vx.device)
            counts.index_add_(0, self.vfeat.long(), torch.ones_like(self.vfeat))
            return ~has_out & (counts > 0)
        return self._get("vall", all_in)

    def literal_vertex_in_feature(self) -> torch.Tensor:
        if self.lvx.shape[0] == 0 or not self.data_is_poly:
            return self.zeros()
        return self._get("lany", lambda: literal_vertex_parity(
            *self.edges, self.efeat, self.n, self.lvx, self.lvy, False))

    def literal_all_in_feature(self) -> torch.Tensor:
        if not self.data_is_poly:
            return self.zeros()
        return self._get("lall", lambda: literal_vertex_parity(
            *self.edges, self.efeat, self.n, self.lvx, self.lvy, True))

    def edge_crossings(self) -> torch.Tensor:
        return self._get("cross", lambda: edge_crossings(
            *self.edges, self.efeat, self.n, self.lit_edges))

    def bbox_overlap(self, x0, y0, x1b, y1b) -> torch.Tensor:
        bb = self.bbox
        return ((bb[:, 0] <= x1b) & (bb[:, 2] >= x0)
                & (bb[:, 1] <= y1b) & (bb[:, 3] >= y0))


def _feature_masks(f, name: str, data_is_poly: bool = True):
    """(params, dev) -> mask for a SpatialPredicate on CSR data.

    `data_is_poly`: whether the data features are areal (ray-crossing
    parity against their edge tables is meaningful). Open polylines and
    multipoints have no interior, so "literal vertex inside feature" is
    identically False."""
    op = f.op
    g = f.geometry
    (x1, y1, x2, y2), lvx, lvy = _literal_arrays(g)
    lit = DeviceTables((x1, y1, x2, y2, lvx, lvy))
    bb = g.bbox
    poly_literal = g.kind in ("Polygon", "MultiPolygon")

    def parts(dev) -> _Parts:
        return _Parts(dev, name, lit, poly_literal, data_is_poly)

    def intersects(p: _Parts):
        return p.bbox_overlap(*bb) & (
            p.vertex_in_literal_any()
            | p.literal_vertex_in_feature()
            | p.edge_crossings()
        )

    def within(p: _Parts):
        return (p.vertex_in_literal_all() & ~p.edge_crossings()
                & ~p.literal_vertex_in_feature())

    def contains(p: _Parts):
        if p.lvx.shape[0] == 0:
            return p.zeros()
        no_data_vertex_in_lit = (~p.vertex_in_literal_any() if poly_literal
                                 else ~p.zeros())
        return (p.literal_all_in_feature() & ~p.edge_crossings()
                & no_data_vertex_in_lit)

    if op == "BBOX":
        return lambda params, dev: parts(dev).bbox_overlap(*bb)
    if op == "INTERSECTS":
        return lambda params, dev: intersects(parts(dev))
    if op == "DISJOINT":
        return lambda params, dev: ~intersects(parts(dev))
    if op == "WITHIN":
        return lambda params, dev: within(parts(dev))
    if op == "CONTAINS":
        return lambda params, dev: contains(parts(dev))
    if op == "EQUALS":
        # approximation: mutual containment
        def equals(params, dev):
            p = parts(dev)
            return within(p) & contains(p)
        return equals
    if op == "OVERLAPS":
        # approximation: interiors intersect, neither contains the other
        def overlaps(params, dev):
            p = parts(dev)
            return intersects(p) & ~within(p) & ~contains(p)
        return overlaps
    if op == "CROSSES":
        # line/polygon crossing: edge crossings, or part-in/part-out
        def crosses(params, dev):
            p = parts(dev)
            return p.edge_crossings() | (p.vertex_in_literal_any()
                                         & ~p.vertex_in_literal_all())
        return crosses
    if op == "TOUCHES":
        # approximation: boundaries meet but interiors don't overlap =
        # bbox overlap & ~(any vertex strictly inside either way) & edges meet
        def touches(params, dev):
            p = parts(dev)
            return (p.bbox_overlap(*bb) & ~p.vertex_in_literal_any()
                    & ~p.literal_vertex_in_feature() & p.edge_crossings())
        return touches
    raise NotImplementedError(f"extended spatial op {op}")


def compile_extended_spatial(f, name: str, attr_type: str = "Polygon") -> Callable:
    """Entry point of cql.compile for non-Point geometry attributes."""
    data_is_poly = "Polygon" in attr_type or attr_type in (
        "Geometry", "GeometryCollection")
    if isinstance(f, ast.DistancePredicate):
        return _distance_mask(f, name, data_is_poly)
    return _feature_masks(f, name, data_is_poly)


def _distance_mask(f, name: str, data_is_poly: bool = True):
    (x1, y1, x2, y2), lvx, lvy = _literal_arrays(f.geometry)
    if x1.shape[0] == 0:
        if lvx.shape[0] == 0:  # EMPTY literal: nothing is within any distance
            return lambda params, dev: torch.zeros_like(dev[VALID])
        x1 = x2 = lvx
        y1 = y2 = lvy
    segs = DeviceTables((x1, y1, x2, y2))
    d = float(f.distance_m)
    intersect_fn = _feature_masks(
        ast.SpatialPredicate("INTERSECTS", f.prop, f.geometry), name,
        data_is_poly)

    def dwithin(params, dev):
        x = dev[f"{name}__x"]
        verts = dev[f"{name}__verts"]
        vnear = within_segments_m(verts[:, 0], verts[:, 1], *segs.on(x.device), d)
        near = _any_by_feature(vnear, dev[f"{name}__vfeat"], x.shape[0])
        # near via any vertex, or actually intersecting (distance 0)
        return near | intersect_fn(params, dev)

    if f.op == "BEYOND":
        return lambda params, dev: ~dwithin(params, dev)
    return dwithin
