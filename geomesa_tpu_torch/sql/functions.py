"""st_* spatial functions.

A copy of the reference package's `sql/functions.py` (host NumPy over the
port's Geometry model); `st_transform` reprojects through the port's
`core/crs.py`.

Parity: geomesa-spark-jts o.l.g.spark.jts {constructors, accessors,
predicates, processors} [upstream, unverified]. Semantics notes:

- Predicates over point *columns* (NumPy arrays of x/y) are vectorized and
  return boolean arrays — the columnar analog of a Spark UDF over a
  geometry column. Geometry×Geometry forms take Geometry objects.
- Planar predicates use lon/lat degrees as a flat plane, exactly like JTS
  defaults upstream; spherical measures are the *Sphere variants.
- Polygon×polygon intersects = bbox gate + (vertex containment either way
  or any edge pair crossing): exact for simple polygons incl. holes.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from geomesa_tpu_torch.core.wkt import Geometry, parse_wkt, point as _mk_point, to_wkt
from geomesa_tpu_torch.engine.geodesy import EARTH_RADIUS_M, haversine_m_np
from geomesa_tpu_torch.engine.pip import points_in_polygon_np, polygon_edges

ArrayLike = Union[np.ndarray, Sequence[float]]

__all__ = [
    "FUNCTIONS",
    "register",
    "st_area",
    "st_asText",
    "st_bbox",
    "st_buffer",
    "st_bufferPoint",
    "st_castToGeometry",
    "st_centroid",
    "st_contains",
    "st_convexHull",
    "st_crosses",
    "st_disjoint",
    "st_distance",
    "st_distanceSphere",
    "st_dwithin",
    "st_envelope",
    "st_equals",
    "st_exteriorRing",
    "st_geomFromText",
    "st_geomFromWKT",
    "st_geomFromWKB",
    "st_geomFromGeoHash",
    "st_geomFromGeoJSON",
    "st_geoHash",
    "st_idlSafeGeom",
    "st_interiorRingN",
    "st_isValid",
    "st_geometryType",
    "st_intersects",
    "st_length",
    "st_lengthSphere",
    "st_makeBBOX",
    "st_makeBox2D",
    "st_makeLine",
    "st_makePoint",
    "st_makePolygon",
    "st_numGeometries",
    "st_numInteriorRings",
    "st_numPoints",
    "st_antimeridianSafeGeom",
    "st_asBinary",
    "st_asGeoJSON",
    "st_byteArray",
    "st_castToPoint",
    "st_castToPolygon",
    "st_castToLineString",
    "st_pointFromGeoHash",
    "st_pointFromText",
    "st_polygonFromText",
    "st_lineFromText",
    "st_geometryN",
    "st_simplify",
    "st_overlaps",
    "st_point",
    "st_pointN",
    "st_touches",
    "st_transform",
    "st_translate",
    "st_within",
    "st_x",
    "st_y",
]


# ---------------------------------------------------------------------------
# constructors


def st_point(x: float, y: float) -> Geometry:
    return _mk_point(float(x), float(y))


st_makePoint = st_point


def st_geomFromWKT(wkt: str) -> Geometry:
    return parse_wkt(wkt)


st_geomFromText = st_geomFromWKT


def st_makeBBOX(xmin: float, ymin: float, xmax: float, ymax: float) -> Geometry:
    ring = np.array(
        [[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax], [xmin, ymin]],
        np.float64,
    )
    return Geometry("Polygon", [ring])


st_makeBox2D = st_makeBBOX


def st_makeLine(points: Iterable[Geometry]) -> Geometry:
    pts = np.array([p.point for p in points], np.float64)
    return Geometry("LineString", [pts])


def st_makePolygon(line: Geometry) -> Geometry:
    ring = np.asarray(line.rings[0], np.float64)
    if not np.array_equal(ring[0], ring[-1]):
        ring = np.concatenate([ring, ring[:1]], axis=0)
    return Geometry("Polygon", [ring])


def st_castToGeometry(g: Geometry) -> Geometry:
    return g


# ---------------------------------------------------------------------------
# accessors


def st_x(g: Union[Geometry, ArrayLike]):
    if isinstance(g, Geometry):
        return g.point[0]
    return np.asarray(g, np.float64)


def st_y(g: Union[Geometry, ArrayLike]):
    if isinstance(g, Geometry):
        return g.point[1]
    return np.asarray(g, np.float64)


def st_envelope(g: Geometry) -> Geometry:
    return st_makeBBOX(*g.bbox)


def st_bbox(g: Geometry) -> Tuple[float, float, float, float]:
    return g.bbox


def st_exteriorRing(g: Geometry) -> Geometry:
    if "Polygon" not in g.kind:
        raise ValueError("st_exteriorRing expects a polygon")
    ring = np.asarray(g.rings[0], np.float64)
    return Geometry("LineString", [ring])


def st_numPoints(g: Geometry) -> int:
    return int(sum(len(r) for r in g.rings)) if g.rings else 1


def st_pointN(g: Geometry, n: int) -> Geometry:
    """1-based vertex of a line (negative counts from the end), per JTS."""
    pts = np.asarray(g.rings[0], np.float64)
    idx = n - 1 if n > 0 else len(pts) + n
    return _mk_point(float(pts[idx, 0]), float(pts[idx, 1]))


def st_geometryType(g: Geometry) -> str:
    return g.kind


def st_asText(g: Geometry) -> str:
    return to_wkt(g)


# ---------------------------------------------------------------------------
# measures


def _ring_shoelace(ring) -> float:
    """|shoelace area| of one closed-or-open ring (0 if degenerate)."""
    r = np.asarray(ring, np.float64)
    if len(r) < 3:
        return 0.0
    if not np.array_equal(r[0], r[-1]):
        r = np.concatenate([r, r[:1]], axis=0)
    return 0.5 * abs(float(np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1])))


def st_area(g: Geometry) -> float:
    """Planar (degree²) shoelace area. Geometry.parts gives the ring count
    per part; within each part, ring 0 is the shell (adds) and the rest
    are holes (subtract) — JTS area semantics for (Multi)Polygons."""
    if "Polygon" not in g.kind and g.kind != "Geometry":
        return 0.0
    total = 0.0
    ri = 0
    for nrings in g.parts:
        for j in range(nrings):
            a = _ring_shoelace(g.rings[ri])
            ri += 1
            total += a if j == 0 else -a
    return max(total, 0.0)


def st_length(g: Geometry) -> float:
    """Planar (degree) path length of line kinds; 0 for points/polygons
    (JTS semantics: polygon length is the perimeter — matched for polygons)."""
    if g.is_point:
        return 0.0
    close = "Polygon" in g.kind
    total = 0.0
    for ring in g.rings:
        r = np.asarray(ring, np.float64)
        if close and not np.array_equal(r[0], r[-1]):
            r = np.concatenate([r, r[:1]], axis=0)
        d = np.diff(r, axis=0)
        total += float(np.sum(np.hypot(d[:, 0], d[:, 1])))
    return total


def st_lengthSphere(g: Geometry) -> float:
    """Great-circle (meters) path length of a line."""
    if g.is_point:
        return 0.0
    total = 0.0
    for ring in g.rings:
        r = np.asarray(ring, np.float64)
        if len(r) < 2:
            continue
        total += float(
            np.sum(haversine_m_np(r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]))
        )
    return total


def st_centroid(g: Geometry) -> Geometry:
    if g.is_point:
        return g
    if "Polygon" in g.kind:
        # area-weighted centroid over all parts; holes carry negative weight
        wsum = cxsum = cysum = 0.0
        ri = 0
        for nrings in g.parts:
            for j in range(nrings):
                r = np.asarray(g.rings[ri], np.float64)
                ri += 1
                if len(r) < 3:
                    continue
                if not np.array_equal(r[0], r[-1]):
                    r = np.concatenate([r, r[:1]], axis=0)
                cross = r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1]
                a = abs(float(np.sum(cross)) / 2.0)
                if a < 1e-300:
                    continue
                sgn = float(np.sign(np.sum(cross))) or 1.0
                cx = float(np.sum((r[:-1, 0] + r[1:, 0]) * cross)) / (6.0 * (a * sgn))
                cy = float(np.sum((r[:-1, 1] + r[1:, 1]) * cross)) / (6.0 * (a * sgn))
                w = a if j == 0 else -a
                wsum += w
                cxsum += w * cx
                cysum += w * cy
        if abs(wsum) < 1e-300:
            pts = np.concatenate(
                [np.asarray(r, np.float64) for r in g.rings], axis=0
            )
            return _mk_point(float(pts[:, 0].mean()), float(pts[:, 1].mean()))
        return _mk_point(cxsum / wsum, cysum / wsum)
    pts = np.concatenate([np.asarray(r, np.float64) for r in g.rings], axis=0)
    return _mk_point(float(pts[:, 0].mean()), float(pts[:, 1].mean()))


def st_distance(a: Geometry, b: Geometry) -> float:
    """Planar (degree) min distance between two geometries."""
    if a.is_point and b.is_point:
        ax, ay = a.point
        bx, by = b.point
        return math.hypot(ax - bx, ay - by)
    if st_intersects(a, b):
        return 0.0
    return min(
        _min_vertex_to_edges(a, b),
        _min_vertex_to_edges(b, a),
    )


def st_distanceSphere(a: Geometry, b: Geometry) -> float:
    """Great-circle (meters); exact for point×point, vertex-sampled
    otherwise (documented approximation)."""
    if a.is_point and b.is_point:
        ax, ay = a.point
        bx, by = b.point
        return float(haversine_m_np(ax, ay, bx, by))
    if st_intersects(a, b):
        return 0.0
    av = _vertices(a)
    bv = _vertices(b)
    d = haversine_m_np(
        av[:, None, 0], av[:, None, 1], bv[None, :, 0], bv[None, :, 1]
    )
    return float(np.min(d))


# ---------------------------------------------------------------------------
# predicates


def st_contains(a: Geometry, b: Union[Geometry, ArrayLike], y: Optional[ArrayLike] = None):
    """contains(a, b) — b strictly inside a.

    Columnar form: st_contains(poly, x_array, y_array) -> bool[N]."""
    if y is not None:
        return points_in_polygon_np(np.asarray(b, np.float64), np.asarray(y, np.float64), a)
    assert isinstance(b, Geometry)
    if b.is_point:
        x, yy = b.point
        return bool(points_in_polygon_np([x], [yy], a)[0])
    # every vertex of b inside a, and no boundary crossing
    bv = _vertices(b)
    if not bool(np.all(points_in_polygon_np(bv[:, 0], bv[:, 1], a))):
        return False
    return not _edges_cross(a, b)


def st_within(a: Union[Geometry, ArrayLike], b: Geometry, y: Optional[ArrayLike] = None):
    """within(a, b) — a inside b. Columnar: st_within(x, y_arrays..., poly)
    is spelled st_within(x_array, poly, y_array) for symmetry with
    st_contains; prefer the Geometry×Geometry form in user code."""
    if y is not None:
        return points_in_polygon_np(np.asarray(a, np.float64), np.asarray(y, np.float64), b)
    assert isinstance(a, Geometry)
    return st_contains(b, a)


def st_intersects(a: Geometry, b: Union[Geometry, ArrayLike], y: Optional[ArrayLike] = None):
    if y is not None:
        return points_in_polygon_np(np.asarray(b, np.float64), np.asarray(y, np.float64), a)
    assert isinstance(b, Geometry)
    abox, bbox_ = a.bbox, b.bbox
    if abox[0] > bbox_[2] or abox[2] < bbox_[0] or abox[1] > bbox_[3] or abox[3] < bbox_[1]:
        return False
    if a.is_point:
        return st_contains(b, a) if not b.is_point else a.point == b.point
    if b.is_point:
        return st_contains(a, b)
    av = _vertices(a)
    bv = _vertices(b)
    if "Polygon" in b.kind or b.kind == "Geometry":
        if bool(np.any(points_in_polygon_np(av[:, 0], av[:, 1], b))):
            return True
    if "Polygon" in a.kind or a.kind == "Geometry":
        if bool(np.any(points_in_polygon_np(bv[:, 0], bv[:, 1], a))):
            return True
    return _edges_cross(a, b)


def st_disjoint(a: Geometry, b: Geometry) -> bool:
    return not st_intersects(a, b)


def st_equals(a: Geometry, b: Geometry) -> bool:
    if a.is_point and b.is_point:
        return a.point == b.point
    return a == b


def st_crosses(a: Geometry, b: Geometry) -> bool:
    """Line×polygon / line×line crossing (boundary interiors intersect)."""
    return _edges_cross(a, b)


def st_touches(a: Geometry, b: Geometry) -> bool:
    """Boundaries meet but interiors do not (approximated as: intersects,
    no vertex of either strictly inside the other, and — for line pairs —
    no proper edge crossing or collinear overlap)."""
    if not st_intersects(a, b):
        return False
    # interior evidence: vertices AND edge midpoints (a vertex can land
    # exactly on the other's boundary while an edge runs through its
    # interior — midpoints catch that)
    av = _sample_points(a)
    bv = _sample_points(b)
    inside_a = (
        np.any(_strictly_inside(bv, a)) if ("Polygon" in a.kind) else False
    )
    inside_b = (
        np.any(_strictly_inside(av, b)) if ("Polygon" in b.kind) else False
    )
    if bool(inside_a) or bool(inside_b):
        return False
    if "Polygon" not in a.kind and "Polygon" not in b.kind:
        # line×line: interiors intersect when edges properly cross or
        # overlap collinearly — either refutes "touches"
        if _edges_properly_cross(a, b):
            return False
    return True


def st_overlaps(a: Geometry, b: Geometry) -> bool:
    """Interiors overlap but neither contains the other (polygon×polygon)."""
    if not st_intersects(a, b):
        return False
    return not st_contains(a, b) and not st_contains(b, a) and not st_touches(a, b)


def st_dwithin(
    a: Geometry,
    b: Union[Geometry, ArrayLike],
    dist_or_y=None,
    dist: Optional[float] = None,
    meters: bool = False,
):
    """dwithin(a, b, d) planar degrees by default; meters=True -> haversine.

    Columnar: st_dwithin(point_geom, x_array, y_array, dist=d, meters=...)."""
    if dist is not None and not isinstance(b, Geometry):
        x = np.asarray(b, np.float64)
        yy = np.asarray(dist_or_y, np.float64)
        ax, ay = a.point
        if meters:
            return haversine_m_np(x, yy, ax, ay) <= dist
        return np.hypot(x - ax, yy - ay) <= dist
    d = float(dist_or_y)
    if meters:
        return st_distanceSphere(a, b) <= d
    return st_distance(a, b) <= d


# ---------------------------------------------------------------------------
# processors


def st_transform(g: Geometry, from_srid, to_srid) -> Geometry:
    """Reproject between registered CRSs (EPSG:4326 <-> EPSG:3857; see
    core.crs). Accepts codes as ints or 'EPSG:NNNN' strings (upstream
    st_transform takes CRS names)."""
    from geomesa_tpu_torch.core.crs import transform as _crs_transform

    def _code(v):
        if isinstance(v, str):
            v = v.upper().replace("EPSG:", "")
        return int(v)

    src, dst = _code(from_srid), _code(to_srid)
    rings = []
    for r in g.rings:
        a = np.asarray(r, np.float64)
        x, y = _crs_transform(a[:, 0], a[:, 1], src, dst)
        rings.append(np.stack([x, y], 1))
    return Geometry(g.kind, rings, parts=list(g.parts))


def st_translate(g: Geometry, dx: float, dy: float) -> Geometry:
    if g.is_point:
        x, y = g.point
        return _mk_point(x + dx, y + dy)
    rings = [np.asarray(r, np.float64) + np.array([dx, dy]) for r in g.rings]
    return Geometry(g.kind, rings)


def st_bufferPoint(g: Geometry, distance_m: float, segments: int = 64) -> Geometry:
    """Geodesic buffer around a point, in meters (upstream: spark-jts
    st_bufferPoint — SURVEY.md:378). Vertices via the spherical
    destination-point formula, so the ring is correct at any latitude
    (a naive lon/lat circle degenerates toward the poles)."""
    x, y = g.point
    lat1 = math.radians(y)
    lon1 = math.radians(x)
    ang = distance_m / EARTH_RADIUS_M
    th = np.linspace(0.0, 2.0 * math.pi, segments, endpoint=False)
    lat2 = np.arcsin(
        math.sin(lat1) * math.cos(ang)
        + math.cos(lat1) * math.sin(ang) * np.cos(th)
    )
    lon2 = lon1 + np.arctan2(
        np.sin(th) * math.sin(ang) * math.cos(lat1),
        math.cos(ang) - math.sin(lat1) * np.sin(lat2),
    )
    ring = np.stack([np.degrees(lon2), np.degrees(lat2)], 1)
    ring = np.concatenate([ring, ring[:1]], 0)
    return Geometry("Polygon", [ring])


def st_buffer(g: Geometry, d: float, resolution: int = 96) -> Geometry:
    """Buffer in planar degrees (JTS st_buffer parity — SURVEY.md:378).

    TPU-era formulation: instead of JTS's offset-curve + union machinery,
    the buffer is the d-level contour of the geometry's signed distance
    field, extracted by marching squares with linear interpolation. One
    algorithm covers every kind (multi-parts and overlapping circles union
    naturally), negative d shrinks polygons, and degenerate inputs can
    only yield empty output — never a crash or a self-intersecting mess.
    Accuracy: ~extent/resolution per coordinate (resolution is the
    quadrantSegments-style knob)."""
    if not g.rings:
        return Geometry("Polygon", [])
    verts = _vertices(g)
    if len(verts) == 0:
        return Geometry("Polygon", [])
    if d <= 0 and g.kind not in ("Polygon", "MultiPolygon"):
        return Geometry("Polygon", [])  # only areas can shrink
    if g.is_point and len(verts) == 1:
        # exact K-gon circle fast path
        th = np.linspace(0.0, 2.0 * math.pi, 64, endpoint=False)
        ring = np.stack(
            [verts[0, 0] + d * np.cos(th), verts[0, 1] + d * np.sin(th)], 1
        )
        ring = np.concatenate([ring, ring[:1]], 0)
        return Geometry("Polygon", [ring])

    x0, y0, x1, y1 = g.bbox
    pad = abs(d) * 1.05 + 1e-9
    ex = max(x1 - x0, 1e-9) + 2 * pad
    ey = max(y1 - y0, 1e-9) + 2 * pad
    cell = max(ex, ey) / resolution
    xs = np.arange(x0 - pad, x1 + pad + cell, cell)
    ys = np.arange(y0 - pad, y1 + pad + cell, cell)
    gx, gy = np.meshgrid(xs, ys)
    px, py = gx.ravel(), gy.ravel()
    field = _planar_distance(px, py, g).reshape(gy.shape)
    if g.kind in ("Polygon", "MultiPolygon"):
        inside = points_in_polygon_np(px, py, g).reshape(gy.shape)
        field = np.where(inside, -field, field)
    rings = _marching_squares(field - d, xs, ys)
    if not rings:
        return Geometry("Polygon", [])
    # shells vs holes by containment depth; orient shells CCW, holes CW
    out: List[np.ndarray] = []
    parts: List[int] = []
    depths = []
    for i, r in enumerate(rings):
        # containment probe: a VERTEX of the ring (contours are disjoint,
        # so any vertex represents the whole ring; the centroid would lie
        # in the hole of an annular ring and misclassify it)
        c = r[0]
        depth = 0
        for j, other in enumerate(rings):
            if i != j and _point_in_ring(c, other):
                depth += 1
        depths.append(depth)
    def oriented(i):
        r = rings[i]
        signed = 0.5 * float(
            np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1])
        )
        want_ccw = depths[i] % 2 == 0
        return r if (signed > 0) == want_ccw else r[::-1]

    shells = [i for i, dp in enumerate(depths) if dp % 2 == 0]
    holes = [i for i, dp in enumerate(depths) if dp % 2 == 1]
    for s in shells:
        out.append(oriented(s))
        # a hole belongs to shell s iff s contains it one level up
        mine = [
            h
            for h in holes
            if depths[h] == depths[s] + 1
            and _point_in_ring(rings[h][0], rings[s])
        ]
        for h in mine:
            out.append(oriented(h))
        parts.append(1 + len(mine))
    kind = "MultiPolygon" if len(parts) > 1 else "Polygon"
    return Geometry(kind, out, parts)


def _planar_distance(px: np.ndarray, py: np.ndarray, g: Geometry) -> np.ndarray:
    """Unsigned planar (degree) distance from points to the geometry's
    edges/vertices, chunked so the [N, E] block stays bounded."""
    x1, y1, x2, y2 = polygon_edges(g)
    if len(x1) == 0:  # point cloud: distance to vertices
        v = _vertices(g)
        x1 = x2 = v[:, 0]
        y1 = y2 = v[:, 1]
    out = np.empty(len(px), np.float64)
    step = max(1, (1 << 22) // max(len(x1), 1))
    ex, ey = x2 - x1, y2 - y1
    L2 = np.maximum(ex * ex + ey * ey, 1e-30)
    for s in range(0, len(px), step):
        qx = px[s : s + step, None]
        qy = py[s : s + step, None]
        t = np.clip(((qx - x1) * ex + (qy - y1) * ey) / L2, 0.0, 1.0)
        cx = x1 + t * ex
        cy = y1 + t * ey
        out[s : s + step] = np.sqrt(
            np.min((qx - cx) ** 2 + (qy - cy) ** 2, axis=1)
        )
    return out


def _point_in_ring(pt, ring) -> bool:
    x, y = pt
    rx, ry = ring[:, 0], ring[:, 1]
    c = (ry[:-1] <= y) != (ry[1:] <= y)
    dy = np.where(ry[1:] == ry[:-1], 1.0, ry[1:] - ry[:-1])
    t = (y - ry[:-1]) / dy
    xc = rx[:-1] + t * (rx[1:] - rx[:-1])
    return bool(np.sum(c & (xc > x)) % 2)


# marching-squares case table: corner bits (1=SW, 2=SE, 4=NE, 8=NW) ->
# crossed-edge pairs (undirected; ring orientation is fixed afterwards by
# shoelace + containment depth). Edges: B(ottom)/R(ight)/T(op)/L(eft).
_MS_CASES = {
    1: [("L", "B")], 2: [("B", "R")], 3: [("L", "R")], 4: [("R", "T")],
    6: [("B", "T")], 7: [("L", "T")], 8: [("T", "L")], 9: [("B", "T")],
    11: [("R", "T")], 12: [("L", "R")], 13: [("B", "R")], 14: [("L", "B")],
}


def _marching_squares(field: np.ndarray, xs: np.ndarray, ys: np.ndarray):
    """Closed level-0 contours of `field` (negative = inside) sampled at
    (ys[i], xs[j]). The caller pads the domain so no contour touches the
    boundary; rings come back closed (first == last), unoriented."""
    inside = field < 0
    H, W = field.shape
    segs: List[Tuple[tuple, tuple]] = []
    # cells with a sign change only
    cellmask = (
        inside[:-1, :-1] | inside[:-1, 1:] | inside[1:, :-1] | inside[1:, 1:]
    ) & ~(
        inside[:-1, :-1] & inside[:-1, 1:] & inside[1:, :-1] & inside[1:, 1:]
    )
    for i, j in zip(*np.nonzero(cellmask)):
        code = (
            (1 if inside[i, j] else 0)
            | (2 if inside[i, j + 1] else 0)
            | (4 if inside[i + 1, j + 1] else 0)
            | (8 if inside[i + 1, j] else 0)
        )
        if code in (5, 10):
            # saddle: split by center sign
            center = (
                field[i, j] + field[i, j + 1] + field[i + 1, j] + field[i + 1, j + 1]
            ) / 4.0
            if code == 5:
                pairs = (
                    [("L", "T"), ("B", "R")]
                    if center >= 0
                    else [("L", "B"), ("R", "T")]
                )
            else:
                pairs = (
                    [("B", "L"), ("T", "R")]
                    if center >= 0
                    else [("B", "R"), ("T", "L")]
                )
        else:
            pairs = _MS_CASES[code]
        eid = {
            "B": ("h", i, j),
            "T": ("h", i + 1, j),
            "L": ("v", i, j),
            "R": ("v", i, j + 1),
        }
        for a, b in pairs:
            segs.append((eid[a], eid[b]))

    adj: dict = {}
    for a, b in segs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)

    def vertex(e):
        kind, i, j = e
        if kind == "h":
            a, b = field[i, j], field[i, j + 1]
            t = a / (a - b) if a != b else 0.5
            return (xs[j] + t * (xs[j + 1] - xs[j]), ys[i])
        a, b = field[i, j], field[i + 1, j]
        t = a / (a - b) if a != b else 0.5
        return (xs[j], ys[i] + t * (ys[i + 1] - ys[i]))

    rings = []
    visited = set()
    for start in adj:
        if start in visited or len(adj[start]) != 2:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = start, adj[start][0]
        while cur != start:
            loop.append(cur)
            visited.add(cur)
            nxts = [e for e in adj.get(cur, []) if e != prev]
            if not nxts:
                break  # open chain (boundary-clipped): drop it
            prev, cur = cur, nxts[0]
        else:
            pts = np.array([vertex(e) for e in loop] + [vertex(start)])
            if len(pts) >= 4:
                rings.append(pts)
    return rings


def st_convexHull(g: Geometry) -> Geometry:
    """Monotone-chain convex hull of all vertices."""
    pts = _vertices(g)
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return Geometry("LineString", [pts]) if len(pts) == 2 else _mk_point(
            float(pts[0, 0]), float(pts[0, 1])
        )
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    p = pts[order]

    def half(points):
        out: List[np.ndarray] = []
        for pt in points:
            while len(out) >= 2:
                u = out[-1] - out[-2]
                v = pt - out[-2]
                if u[0] * v[1] - u[1] * v[0] <= 0:  # 2D cross product
                    out.pop()
                else:
                    break
            out.append(pt)
        return out

    lower = half(p)
    upper = half(p[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1] + [lower[0]], np.float64)
    return Geometry("Polygon", [hull])


# ---------------------------------------------------------------------------
# internals


def _vertices(g: Geometry) -> np.ndarray:
    if g.is_point:
        return np.asarray([g.point], np.float64)
    return np.concatenate([np.asarray(r, np.float64) for r in g.rings], axis=0)


def _edges(g: Geometry):
    return polygon_edges(g)


def _edge_orientations(a: Geometry, b: Geometry):
    """All-pairs segment orientation tests between a's and b's edges.

    Returns None when either has no edges; else (o1, o2, o3, o4, coords)
    where coords = (ax1, ay1, ax2, ay2, bx1, by1, bx2, by2) broadcastable
    [A, B] orientation signs."""
    ax1, ay1, ax2, ay2 = _edges(a)
    bx1, by1, bx2, by2 = _edges(b)
    if len(ax1) == 0 or len(bx1) == 0:
        return None

    def orient(ox, oy, px, py, qx, qy):
        return (px - ox) * (qy - oy) - (py - oy) * (qx - ox)

    o1 = orient(ax1[:, None], ay1[:, None], ax2[:, None], ay2[:, None], bx1[None, :], by1[None, :])
    o2 = orient(ax1[:, None], ay1[:, None], ax2[:, None], ay2[:, None], bx2[None, :], by2[None, :])
    o3 = orient(bx1[None, :], by1[None, :], bx2[None, :], by2[None, :], ax1[:, None], ay1[:, None])
    o4 = orient(bx1[None, :], by1[None, :], bx2[None, :], by2[None, :], ax2[:, None], ay2[:, None])
    return o1, o2, o3, o4, (ax1, ay1, ax2, ay2, bx1, by1, bx2, by2)


def _edges_properly_cross(a: Geometry, b: Geometry) -> bool:
    """True when segment *interiors* intersect: a strict crossing, or a
    collinear pair overlapping over positive length."""
    os_ = _edge_orientations(a, b)
    if os_ is None:
        return False
    o1, o2, o3, o4, (ax1, ay1, ax2, ay2, bx1, by1, bx2, by2) = os_
    proper = (np.sign(o1) * np.sign(o2) < 0) & (np.sign(o3) * np.sign(o4) < 0)
    if bool(np.any(proper)):
        return True
    # collinear overlap: all four orientations zero and the 1-D projections
    # share more than a point
    col = (o1 == 0) & (o2 == 0) & (o3 == 0) & (o4 == 0)
    if not bool(np.any(col)):
        return False
    # project on the dominant axis of each a-edge
    use_x = np.abs(ax2 - ax1)[:, None] >= np.abs(ay2 - ay1)[:, None]
    alo = np.where(use_x, np.minimum(ax1, ax2)[:, None], np.minimum(ay1, ay2)[:, None])
    ahi = np.where(use_x, np.maximum(ax1, ax2)[:, None], np.maximum(ay1, ay2)[:, None])
    blo = np.where(use_x, np.minimum(bx1, bx2)[None, :], np.minimum(by1, by2)[None, :])
    bhi = np.where(use_x, np.maximum(bx1, bx2)[None, :], np.maximum(by1, by2)[None, :])
    overlap = np.minimum(ahi, bhi) - np.maximum(alo, blo)
    return bool(np.any(col & (overlap > 1e-12)))


def _edges_cross(a: Geometry, b: Geometry) -> bool:
    os_ = _edge_orientations(a, b)
    if os_ is None:
        return False
    o1, o2, o3, o4, (ax1, ay1, ax2, ay2, bx1, by1, bx2, by2) = os_
    proper = (np.sign(o1) * np.sign(o2) < 0) & (np.sign(o3) * np.sign(o4) < 0)
    if bool(np.any(proper)):
        return True
    # collinear touching endpoints
    def on_seg(ox, oy, px, py, qx, qy, o):
        return (
            (o == 0)
            & (np.minimum(ox, px) - 1e-12 <= qx)
            & (qx <= np.maximum(ox, px) + 1e-12)
            & (np.minimum(oy, py) - 1e-12 <= qy)
            & (qy <= np.maximum(oy, py) + 1e-12)
        )

    t = (
        on_seg(ax1[:, None], ay1[:, None], ax2[:, None], ay2[:, None], bx1[None, :], by1[None, :], o1)
        | on_seg(ax1[:, None], ay1[:, None], ax2[:, None], ay2[:, None], bx2[None, :], by2[None, :], o2)
        | on_seg(bx1[None, :], by1[None, :], bx2[None, :], by2[None, :], ax1[:, None], ay1[:, None], o3)
        | on_seg(bx1[None, :], by1[None, :], bx2[None, :], by2[None, :], ax2[:, None], ay2[:, None], o4)
    )
    return bool(np.any(t))


def _sample_points(g: Geometry) -> np.ndarray:
    """Vertices plus edge midpoints (boundary sample for interior tests)."""
    v = _vertices(g)
    x1, y1, x2, y2 = _edges(g)
    if len(x1) == 0:
        return v
    mid = np.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0], axis=1)
    return np.concatenate([v, mid], axis=0)


def _strictly_inside(pts: np.ndarray, g: Geometry, eps: float = 1e-12) -> np.ndarray:
    """Interior test excluding the boundary: crossing-number AND min
    distance to any edge > eps (the half-open crossing rule alone counts
    some on-boundary points as inside)."""
    inside = points_in_polygon_np(pts[:, 0], pts[:, 1], g)
    if not np.any(inside):
        return inside
    x1, y1, x2, y2 = _edges(g)
    px = pts[:, None, 0]
    py = pts[:, None, 1]
    ex = (x2 - x1)[None, :]
    ey = (y2 - y1)[None, :]
    denom = np.where(ex * ex + ey * ey == 0, 1.0, ex * ex + ey * ey)
    t = np.clip(((px - x1[None, :]) * ex + (py - y1[None, :]) * ey) / denom, 0.0, 1.0)
    d = np.min(np.hypot(px - (x1[None, :] + t * ex), py - (y1[None, :] + t * ey)), axis=1)
    return inside & (d > eps)


def _min_vertex_to_edges(a: Geometry, b: Geometry) -> float:
    """Min planar distance from a's vertices to b's edges (or vertices)."""
    av = _vertices(a)
    bx1, by1, bx2, by2 = _edges(b)
    if len(bx1) == 0:
        bv = _vertices(b)
        d = np.hypot(av[:, None, 0] - bv[None, :, 0], av[:, None, 1] - bv[None, :, 1])
        return float(np.min(d))
    px = av[:, None, 0]
    py = av[:, None, 1]
    ex = (bx2 - bx1)[None, :]
    ey = (by2 - by1)[None, :]
    denom = np.where(ex * ex + ey * ey == 0, 1.0, ex * ex + ey * ey)
    t = np.clip(((px - bx1[None, :]) * ex + (py - by1[None, :]) * ey) / denom, 0.0, 1.0)
    cx = bx1[None, :] + t * ex
    cy = by1[None, :] + t * ey
    return float(np.min(np.hypot(px - cx, py - cy)))


# ---------------------------------------------------------------------------
# registry



# ---------------------------------------------------------------------------
# round-3 surface: geohash constructors, validity, simplification, ring /
# geometry accessors, antimeridian handling, casts, WKB/GeoJSON codecs
# (geomesa-spark-jts parity set — SURVEY.md:373-380)

_GH32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_GH32_POS = {c: i for i, c in enumerate(_GH32)}


def st_geoHash(g: Geometry, precision: int = 25) -> str:
    """Geohash of the geometry's centroid-ish point at `precision` BITS
    (upstream st_geoHash takes bit precision; rounded up to whole base-32
    chars)."""
    if g.is_point:
        x, y = g.point
    else:
        c = st_centroid(g)
        x, y = c.point
    nchars = max(1, -(-int(precision) // 5))
    lo_x, hi_x, lo_y, hi_y = -180.0, 180.0, -90.0, 90.0
    out = []
    bit = 0
    val = 0
    even = True  # lon first
    while len(out) < nchars:
        if even:
            mid = (lo_x + hi_x) / 2
            if x >= mid:
                val = (val << 1) | 1
                lo_x = mid
            else:
                val <<= 1
                hi_x = mid
        else:
            mid = (lo_y + hi_y) / 2
            if y >= mid:
                val = (val << 1) | 1
                lo_y = mid
            else:
                val <<= 1
                hi_y = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_GH32[val])
            bit = 0
            val = 0
    return "".join(out)


def _geohash_bbox(h: str) -> Tuple[float, float, float, float]:
    lo_x, hi_x, lo_y, hi_y = -180.0, 180.0, -90.0, 90.0
    even = True
    for ch in h.lower():
        try:
            cd = _GH32_POS[ch]
        except KeyError:
            raise ValueError(f"invalid geohash character {ch!r}")
        for b in range(4, -1, -1):
            bit = (cd >> b) & 1
            if even:
                mid = (lo_x + hi_x) / 2
                if bit:
                    lo_x = mid
                else:
                    hi_x = mid
            else:
                mid = (lo_y + hi_y) / 2
                if bit:
                    lo_y = mid
                else:
                    hi_y = mid
            even = not even
    return lo_x, lo_y, hi_x, hi_y


def st_geomFromGeoHash(h: str, precision: Optional[int] = None) -> Geometry:
    """Geohash cell -> bbox Polygon (precision in bits truncates)."""
    if precision is not None:
        h = h[: max(1, -(-int(precision) // 5))]
    xmin, ymin, xmax, ymax = _geohash_bbox(h)
    from geomesa_tpu_torch.core.wkt import box

    return box(xmin, ymin, xmax, ymax)


def st_pointFromGeoHash(h: str, precision: Optional[int] = None) -> Geometry:
    if precision is not None:
        h = h[: max(1, -(-int(precision) // 5))]
    xmin, ymin, xmax, ymax = _geohash_bbox(h)
    return _mk_point((xmin + xmax) / 2, (ymin + ymax) / 2)


def st_numInteriorRings(g: Geometry) -> int:
    if g.kind != "Polygon":
        return 0
    return max(0, len(g.rings) - 1)


def st_interiorRingN(g: Geometry, n: int) -> Optional[Geometry]:
    """0-based interior-ring accessor (None out of range, JTS-style)."""
    if g.kind != "Polygon" or n < 0 or n + 1 >= len(g.rings):
        return None
    return Geometry("LineString", [np.asarray(g.rings[n + 1], np.float64)])


def st_numGeometries(g: Geometry) -> int:
    if g.kind.startswith("Multi"):
        if g.kind == "MultiPolygon":
            return len(g.parts)
        if g.kind == "MultiPoint":
            return sum(len(r) for r in g.rings)
        return len(g.rings)
    return 1


def st_geometryN(g: Geometry, n: int) -> Optional[Geometry]:
    """0-based part accessor; a simple geometry is its own part 0."""
    if n < 0 or n >= st_numGeometries(g):
        return None
    if not g.kind.startswith("Multi"):
        return g
    if g.kind == "MultiPoint":
        pts = np.concatenate([np.asarray(r, np.float64) for r in g.rings], 0)
        return _mk_point(float(pts[n, 0]), float(pts[n, 1]))
    if g.kind == "MultiLineString":
        return Geometry("LineString", [np.asarray(g.rings[n], np.float64)])
    i = sum(g.parts[:n])
    return Geometry("Polygon", list(g.rings[i: i + g.parts[n]]))


def _segments_self_intersect(rings: List[np.ndarray]) -> bool:
    """Any non-adjacent segment pair crossing (vectorized O(E^2))."""
    x1, y1, x2, y2 = polygon_edges(Geometry("Polygon", rings))
    e = len(x1)
    if e < 2:
        return False
    d1x, d1y = (x2 - x1), (y2 - y1)

    def orient(ax, ay, bx, by, cx, cy):
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)

    A = np.arange(e)
    I, J = np.meshgrid(A, A, indexing="ij")
    upper = J > I + 1  # skip self + adjacent
    # closing edge of each ring is adjacent to that ring's first edge
    o1 = orient(x1[I], y1[I], x2[I], y2[I], x1[J], y1[J])
    o2 = orient(x1[I], y1[I], x2[I], y2[I], x2[J], y2[J])
    o3 = orient(x1[J], y1[J], x2[J], y2[J], x1[I], y1[I])
    o4 = orient(x1[J], y1[J], x2[J], y2[J], x2[I], y2[I])
    proper = (np.sign(o1) * np.sign(o2) < 0) & (np.sign(o3) * np.sign(o4) < 0)
    # shared-endpoint contacts are fine (ring closure); only proper
    # crossings invalidate
    return bool(np.any(proper & upper & (d1x[I] ** 2 + d1y[I] ** 2 > 0)))


def st_isValid(g: Geometry) -> bool:
    """Structural validity: rings closed with >= 4 points (polygons),
    >= 2 points (lines), finite coordinates, no proper self-intersection
    for (multi)polygons up to ~2k edges (larger layers: structural checks
    only, matching a fast-path JTS isSimple screen)."""
    for r in g.rings:
        a = np.asarray(r, np.float64)
        if not np.isfinite(a).all():
            return False
    if g.kind in ("Point", "MultiPoint"):
        return all(len(r) >= 1 for r in g.rings)
    if g.kind in ("LineString", "MultiLineString"):
        return all(len(r) >= 2 for r in g.rings)
    if g.kind in ("Polygon", "MultiPolygon"):
        for r in g.rings:
            a = np.asarray(r, np.float64)
            if len(a) < 4 or not np.allclose(a[0], a[-1]):
                return False
        total_edges = sum(len(r) - 1 for r in g.rings)
        if total_edges <= 2048 and _segments_self_intersect(g.rings):
            return False
        return True
    return True


def st_simplify(g: Geometry, tolerance: float) -> Geometry:
    """Douglas-Peucker per ring (iterative, vectorized distance step);
    ring closure is preserved and rings never collapse below validity."""

    def dp(pts: np.ndarray, closed: bool) -> np.ndarray:
        n = len(pts)
        if n <= (4 if closed else 2):
            return pts
        keep = np.zeros(n, bool)
        keep[0] = keep[n - 1] = True
        stack = [(0, n - 1)]
        while stack:
            i, j = stack.pop()
            if j <= i + 1:
                continue
            seg = pts[j] - pts[i]
            ln = np.hypot(*seg)
            mid = pts[i + 1: j]
            if ln == 0:
                d = np.hypot(*(mid - pts[i]).T)
            else:
                d = np.abs(
                    seg[0] * (pts[i][1] - mid[:, 1])
                    - seg[1] * (pts[i][0] - mid[:, 0])
                ) / ln
            kmax = int(np.argmax(d))
            if d[kmax] > tolerance:
                k = i + 1 + kmax
                keep[k] = True
                stack.append((i, k))
                stack.append((k, j))
        out = pts[keep]
        if closed and len(out) < 4:
            return pts  # refuse to invalidate the ring
        return out

    if g.is_point:
        return g
    closed = g.kind in ("Polygon", "MultiPolygon")
    rings = [dp(np.asarray(r, np.float64), closed) for r in g.rings]
    return Geometry(g.kind, rings, list(g.parts))


def st_antimeridianSafeGeom(g: Geometry) -> Geometry:
    """Split geometries spanning the +-180 meridian into a multi-part
    geometry on [-180, 180] (upstream st_antimeridianSafeGeom /
    st_idlSafeGeom). Heuristic matches upstream JTS utils: a geometry
    "crosses" when its bbox width exceeds 180 deg (coordinates were
    entered across the wrap)."""
    xmin, ymin, xmax, ymax = g.bbox
    if xmax - xmin <= 180.0 or g.is_point:
        return g
    # shift western hemisphere points +360, split at x=180, shift back
    rings_e: List[np.ndarray] = []
    rings_w: List[np.ndarray] = []
    for r in g.rings:
        a = np.asarray(r, np.float64).copy()
        a[a[:, 0] < 0, 0] += 360.0
        e = a.copy()
        e[:, 0] = np.minimum(e[:, 0], 180.0)
        w = a.copy()
        w[:, 0] = np.maximum(w[:, 0], 180.0) - 360.0
        rings_e.append(e)
        rings_w.append(w)
    if g.kind in ("Polygon", "MultiPolygon"):
        # preserve the input's part structure on BOTH copies — collapsing
        # all east rings into one part would turn a second shell into a
        # hole of the first
        src_parts = list(g.parts) if g.kind == "MultiPolygon" else [
            len(g.rings)
        ]
        return Geometry(
            "MultiPolygon", rings_e + rings_w, src_parts + src_parts,
        )
    return Geometry("MultiLineString", rings_e + rings_w)


def st_idlSafeGeom(g: Geometry) -> Geometry:
    """Upstream alias of st_antimeridianSafeGeom."""
    return st_antimeridianSafeGeom(g)


def st_castToPoint(g: Geometry) -> Optional[Geometry]:
    return g if g.kind == "Point" else None


def st_castToPolygon(g: Geometry) -> Optional[Geometry]:
    return g if g.kind == "Polygon" else None


def st_castToLineString(g: Geometry) -> Optional[Geometry]:
    return g if g.kind == "LineString" else None


def st_pointFromText(wkt: str) -> Optional[Geometry]:
    g = parse_wkt(wkt)
    return g if g.kind == "Point" else None


def st_polygonFromText(wkt: str) -> Optional[Geometry]:
    g = parse_wkt(wkt)
    return g if g.kind == "Polygon" else None


def st_lineFromText(wkt: str) -> Optional[Geometry]:
    g = parse_wkt(wkt)
    return g if g.kind == "LineString" else None


def st_geomFromWKB(buf: bytes) -> Geometry:
    from geomesa_tpu_torch.core.wkt import parse_wkb

    return parse_wkb(bytes(buf))


def st_asBinary(g: Geometry) -> bytes:
    from geomesa_tpu_torch.core.wkt import to_wkb

    return to_wkb(g)


def st_byteArray(s: str) -> bytes:
    """Upstream st_byteArray: string -> UTF-8 bytes."""
    return s.encode("utf-8")


def st_asGeoJSON(g: Geometry) -> str:
    import json as _json

    from geomesa_tpu_torch.core.wkt import to_geojson

    return _json.dumps(to_geojson(g))


def st_geomFromGeoJSON(text: str) -> Geometry:
    import json as _json

    d = _json.loads(text) if isinstance(text, str) else dict(text)
    kind = d["type"]
    co = d["coordinates"]
    if kind == "Point":
        return _mk_point(float(co[0]), float(co[1]))
    if kind == "MultiPoint":
        pts = np.asarray(co, np.float64)
        return Geometry("MultiPoint", [pts[i:i + 1] for i in range(len(pts))])
    if kind == "LineString":
        return Geometry("LineString", [np.asarray(co, np.float64)])
    if kind == "MultiLineString":
        return Geometry(
            "MultiLineString", [np.asarray(r, np.float64) for r in co])
    if kind == "Polygon":
        return Geometry("Polygon", [np.asarray(r, np.float64) for r in co])
    if kind == "MultiPolygon":
        rings: List[np.ndarray] = []
        parts: List[int] = []
        for poly in co:
            rings.extend(np.asarray(r, np.float64) for r in poly)
            parts.append(len(poly))
        return Geometry("MultiPolygon", rings, parts)
    raise ValueError(f"unsupported GeoJSON type {kind}")


FUNCTIONS = {
    name: obj
    for name, obj in list(globals().items())
    if name.startswith("st_") and callable(obj)
}


def register() -> dict:
    """name -> callable table (the UDF-registration analog)."""
    return dict(FUNCTIONS)
